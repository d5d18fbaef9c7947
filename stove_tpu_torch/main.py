"""Entry point: `python -m stove_tpu_torch.main [mode=train|eval|mcts] ...`.

Counterpart of `stove_tpu/main.py` for the modes ported so far.  Tokens
are `key=value`: `mode=` (`train`, the default, `eval` or `mcts`),
`restore=` (a run directory written by the JAX trainer or the port's: its
config.json and latest ckpt_*.npz), `preset=`, `device=` (`cuda`, the
default, or `cpu`), and any Config field as an override
(`scan_impl=pallas`, `likelihood_impl=pallas`, `spn_impl=pallas` select
the port's training kernels, the scan's forward in bfloat16 as the JAX
package's; every rollout on the card runs the rollout kernel, in float32
but for the planner's leaves under `mcts_rollout_impl=pallas`, which run
its bfloat16 library).

mode=train trains from scratch or, with restore=, resumes the run (params,
Adam state, epoch) for the remaining epochs; it writes config.json,
spn_seeds.json, metrics.jsonl and checkpoints to
`<run_dir>/<run_name>` only, never into the restored directory unless it
is that one.  mode=eval generates the test corpus in memory from the
config's seed (nothing is written), then prints the same keys as the JAX
mode=eval: the conditioned-rollout metrics (with the reward metrics for an
action-conditioned model), the mean and sampled 80-step long-horizon
metrics and the trivial baselines.  mode=mcts plans avoidance episodes from
pixels with the restored model against the oracle and random policies
(`planning/runner.py`) and prints their scores.
"""

from __future__ import annotations

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
    """mode=eval: restore the run, make the test corpus, compute metrics."""
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.models.bundle import StoveModel
    from stove_tpu_torch.train import evaluate as eval_lib

    if cfg.restore is None:
        raise SystemExit("mode=eval requires restore=<run_dir>")
    dev = resolve_device(device)
    model = StoveModel.from_run(cfg.restore, cfg=cfg, device=dev)
    test_ep = data_lib.split(cfg, "test", dev)
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
    """mode=train: train (or resume); returns (trainer, last metrics)."""
    from stove_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    return trainer, trainer.train()


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, mode, device = build_config(argv)
    if mode == "train":
        _, result = run_train(cfg, device)
        print("final:", {k: v for k, v in result.items()
                         if not isinstance(v, list)})
        return 0
    if mode == "mcts":
        from stove_tpu_torch.planning import runner
        print("planning:", runner.run_planning(cfg, device=device))
        return 0
    if mode != "eval":
        raise SystemExit(f"not ported yet: mode={mode} (viz, generate and "
                         "profile are still to port)")
    for k, v in run_eval(cfg, device).items():
        print(f"{k}: {np.asarray(v.detach().cpu())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
