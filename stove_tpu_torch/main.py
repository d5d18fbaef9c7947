"""Entry point: `python -m stove_tpu_torch.main [mode=...] key=value ...`.

Counterpart of `stove_tpu/main.py`, serving all of its modes.  Tokens
are `key=value`: `mode=` (`train`, the default, `eval`, `mcts`,
`generate`, `viz` or `profile`), `restore=` (a run directory written by
the JAX trainer or the port's: its config.json and latest ckpt_*.npz),
`preset=`, `device=` (`cuda`, the default, or `cpu`), and any Config
field as an override (`scan_impl=pallas`, `likelihood_impl=pallas`,
`spn_impl=pallas` select the port's training kernels, the scan's forward
in bfloat16 as the JAX package's; `compute_dtype=bfloat16` rounds the
operands of the encoder's and the dynamics' products to bfloat16, sums in
float32, as the JAX package's; every rollout on the card runs the rollout
kernel, at compute_dtype's precision but for the planner's leaves under
`mcts_rollout_impl=pallas`, which run the TPU kernel's bfloat16 variant).

Every mode that reads a corpus reads it through `envs/data.py::
ensure_dataset`, as the JAX package does: the split's file under
`data_dir` (either package's, or the reference's pickles), else the split
generated from the config's seed and written there.

mode=train trains from scratch or, with restore=, resumes the run (params,
Adam state, epoch) for the remaining epochs; it writes config.json,
spn_seeds.json, metrics.jsonl, checkpoints and a rollout GIF after each
evaluation to `<run_dir>/<run_name>` only, never into the restored
directory unless it is that one.  mode=eval prints the same keys as the
JAX mode=eval: the conditioned-rollout metrics (with the reward metrics
for an action-conditioned model), the mean and sampled 80-step
long-horizon metrics and the trivial baselines.  mode=mcts plans
avoidance episodes from pixels with the restored model against the oracle
and random policies (`planning/runner.py`) and prints their scores.
mode=generate makes (or finds) the train and test corpora and prints
their paths.  mode=viz renders a restored model's conditioned rollout of
the first test sequence, true | predicted, as `rollout_viz.gif`, and its
posterior boxes over the conditioning frames as `detect_grid.png`.  The
JAX package writes both into the restored directory; the port writes them
to `<run_dir>/<run_name>`, as its Trainer writes, and refuses a
directory inside the committed store `ckpts/`.  mode=profile traces
training steps with `torch.profiler` (`utils/profiling.py`) and prints
where the trace was written.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from stove_tpu_torch.config import Config, make_config
from stove_tpu_torch.device import resolve_device


def build_config(argv: List[str]) -> Tuple[Config, str, Optional[str]]:
    """Split CLI tokens into (config, mode, device)."""
    mode, preset, restore, device = "train", None, None, None
    overrides: List[str] = []
    for tok in argv:
        key, _, val = tok.partition("=")
        if key == "mode":
            mode = val
        elif key == "preset":
            preset = val
        elif key == "restore":
            restore = val
        elif key == "device":
            device = val
        else:
            overrides.append(tok)
    if restore is not None:
        from stove_tpu_torch.train import checkpoint as ckpt_lib
        cfg = ckpt_lib.load_config(restore)
        cfg = cfg.with_overrides(*overrides, restore=restore)
    else:
        cfg = make_config(preset, *overrides)
    return cfg, mode, device


def run_eval(cfg: Config, device=None) -> Dict[str, torch.Tensor]:
    """mode=eval: restore the run, read the test corpus, compute metrics."""
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.models.bundle import StoveModel
    from stove_tpu_torch.train import evaluate as eval_lib

    if cfg.restore is None:
        raise SystemExit("mode=eval requires restore=<run_dir>")
    dev = resolve_device(device)
    model = StoveModel.from_run(cfg.restore, cfg=cfg, device=dev)
    test_ep = data_lib.ensure_dataset(cfg, "test", dev)
    m = eval_lib.rollout_metrics(
        model, test_ep, torch.Generator().manual_seed(cfg.seed))
    m.update({f"longhorizon_{k}": v for k, v in
              eval_lib.longhorizon_metrics(
                  model, test_ep, torch.Generator().manual_seed(cfg.seed + 1),
                  t_pred=80).items()})
    m.update({f"longhorizon_sampled_{k}": v for k, v in
              eval_lib.longhorizon_metrics(
                  model, test_ep, torch.Generator().manual_seed(cfg.seed + 2),
                  t_pred=80, sample=True).items()})
    m.update(eval_lib.baseline_metrics(cfg, test_ep))
    return m


def run_train(cfg: Config, device=None):
    """mode=train: train (or resume); returns (trainer, last metrics).

    Under `python -m torch.distributed.run --nproc_per_node=N` (WORLD_SIZE
    in the environment) this process joins the group as rank RANK, on
    card LOCAL_RANK (or the CPU with device=cpu, over gloo), and the
    Trainer shards its batch over `mesh_shape`; the other modes run in one
    process."""
    from stove_tpu_torch.parallel import mesh as mesh_lib
    from stove_tpu_torch.train.trainer import Trainer

    if "WORLD_SIZE" not in os.environ:
        trainer = Trainer(cfg, device=device)
        return trainer, trainer.train()
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    mesh_lib.init_process_group(resolve_device(dev))
    try:
        trainer = Trainer(cfg, device=dev)
        return trainer, trainer.train()
    finally:
        torch.distributed.destroy_process_group()


def run_generate(cfg: Config, device=None) -> Dict[str, str]:
    """mode=generate: the train and test corpora, found or made and
    written (`ensure_dataset`); {split: path}."""
    from stove_tpu_torch.envs import data as data_lib

    dev = resolve_device(device)
    out = {}
    for split in ("train", "test"):
        ep = data_lib.ensure_dataset(cfg, split, dev)
        out[split] = data_lib.dataset_path(cfg, split)
        print(f"{split}: frames {tuple(ep.frames.shape)} -> {out[split]}")
    return out


def run_viz(cfg: Config, device=None) -> Tuple[str, str]:
    """mode=viz (main.py:106): the restored model conditioned on the first
    test sequence's cfg.window frames (posterior noise from a generator
    seeded with cfg.seed, as mode=eval's), a mean rollout of
    cfg.eval_rollout_steps from its last posterior mean (the rollout
    kernel on the card), written as true | predicted frames to
    `<run_dir>/<run_name>/rollout_viz.gif`, and the posterior boxes over
    the conditioning frames to `detect_grid.png` there.  Returns both
    paths."""
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.models.bundle import StoveModel
    from stove_tpu_torch.models.dynamics import POS, SIZE
    from stove_tpu_torch.train import visualize as viz
    from stove_tpu_torch.train.trainer import check_run_dir

    if cfg.restore is None:
        raise SystemExit("mode=viz requires restore=<run_dir>")
    out_dir = check_run_dir(os.path.join(cfg.run_dir, cfg.run_name))
    dev = resolve_device(device)
    model = StoveModel.from_run(cfg.restore, cfg=cfg, device=dev)
    ep = data_lib.ensure_dataset(cfg, "test", dev)
    t_cond, t_pred = cfg.window, cfg.eval_rollout_steps
    frames = data_lib.normalize_frames(ep.frames[:1, :t_cond])
    gen = torch.Generator().manual_seed(cfg.seed)
    with torch.no_grad():
        inf = model.infer(frames, ep.actions[:1, :t_cond], generator=gen)
        states, _ = model.rollout(
            inf.z_mean[:, -1], ep.actions[:1, t_cond - 1:t_cond - 1 + t_pred],
            t_pred, gen, sample=False)
    true = data_lib.normalize_frames(ep.frames[0, t_cond:t_cond + t_pred])
    gif = viz.dump_rollout_gif(cfg, out_dir, "viz", true.cpu().numpy(),
                               states[0, :, :, POS].cpu().numpy(),
                               pred_sizes=states[0, :, :, SIZE].cpu().numpy())
    boxes = torch.cat([inf.z[0, :, :, SIZE], inf.z[0, :, :, POS]], -1)
    grid = viz.frame_grid(os.path.join(out_dir, "detect_grid.png"),
                          frames[0].cpu().numpy(), boxes.cpu().numpy())
    return gif, grid


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, mode, device = build_config(argv)
    if mode == "generate":
        run_generate(cfg, device)
        return 0
    if mode == "train":
        _, result = run_train(cfg, device)
        print("final:", {k: v for k, v in result.items()
                         if not isinstance(v, list)})
        return 0
    if mode == "eval":
        for k, v in run_eval(cfg, device).items():
            print(f"{k}: {np.asarray(v.detach().cpu())}")
        return 0
    if mode == "viz":
        gif, grid = run_viz(cfg, device)
        print(f"wrote {gif}\nwrote {grid}")
        return 0
    if mode == "profile":
        from stove_tpu_torch.utils.profiling import profile_train_steps
        print(f"trace written to {profile_train_steps(cfg, device=device)}")
        return 0
    if mode == "mcts":
        from stove_tpu_torch.planning import runner
        print("planning:", runner.run_planning(cfg, device=device))
        return 0
    raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    sys.exit(main())
