"""Trainer: epoch loop over random 8-frame windows, Adam, eval, checkpoints.

Counterpart of `stove_tpu/train/trainer.py`: a SuPAIR-only warm-up for
cfg.supair_only_epochs epochs, then the full STOVE ELBO; Adam with
separate learning rates for the SuPAIR and dynamics parameters after a
global-norm clip, written out to optax's semantics (`Optimizer`); periodic
rollout evaluation through `train/evaluate.py`; checkpoints in the JAX
package's npz layout, so the port resumes JAX runs and the reverse.

`fused_epoch` (the default) runs each epoch as one device program, as
the reference's whole-epoch lax.scan does: on the card one step (window
sampling, the ELBO, the gradient, the all-reduce, the clip and Adam) is
captured as a CUDA graph after the epoch's first, eager step and
replayed for the rest, with no host sync between steps; each step's
metrics row is copied on the device and the log reads the last one once
an epoch.  `fused_epoch=false` runs the step loop, one eager step at a
time; so does the fused epoch on the CPU (where the reference's rule,
`_use_fused`, fuses only at debug sizes) and beside a gloo all-reduce.
`mode=profile` profiles single eager steps (`train_step`).

Differences from the reference, all deliberate:
* Data parallelism is one process per device (`parallel/mesh.py`,
  launched by `torch.distributed.run`), where the reference shards one
  jitted step over a mesh.  The step computes the same global function:
  every rank samples the whole window batch and draws the whole batch's
  ELBO noise from the same generators, takes its rows (`Mesh.rows`),
  weights its shard's loss by its share of the batch (`Mesh.share`; ranks
  along a second mesh axis hold the same rows; the balanced reward
  BCE's batch rate from the whole batch's rewards), and the gradients
  and metrics are summed over the ranks in one all-reduce before the
  optimizer's clip and update, which every rank applies.  A batch the
  mesh does not divide is sharded over the largest mesh size that does
  (JAX trainer.py:137-143); the ranks beyond it sit the step out, adding
  zeros to the all-reduce.  Only rank 0 writes the run directory (config,
  SPN seeds, metrics, checkpoints, GIFs); every rank evaluates and
  restores.
* Randomness comes from torch.Generators on the training device: window
  sampling from one seeded cfg.seed + 2, the ELBO's and the warm-up's
  normals from one seeded cfg.seed + 3 (the fused epoch and the step loop
  draw the same numbers from them).  A resumed run cannot continue the JAX
  PRNG key stored in the checkpoint; it reseeds both generators from
  cfg.seed and the restored step, and says so.
* The corpora are read through `ensure_dataset`, as the reference's
  are: from `data_dir` under the JAX package's file names, or generated
  from the seed (train: cfg.seed, test: cfg.seed + 1) and written there.
  A file either package wrote is read by both; the two draw different
  sequences at one seed.
* The GIF dump after each evaluation (`_dump_gif`) writes
  `<run_dir>/rollout_ep%04d.gif` with the port's own GIF encoder
  (train/visualize.py, no Pillow).  The reference catches every exception
  there; the port catches only a failure to write the file, so that a
  kernel's failure is not swallowed.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from stove_tpu_torch import tree
from stove_tpu_torch.config import Config
from stove_tpu_torch.device import resolve_device
from stove_tpu_torch.envs import data as data_lib
from stove_tpu_torch.models import supair as supair_lib
from stove_tpu_torch.models import stove as stove_lib
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.ops import launches
from stove_tpu_torch.parallel import mesh as mesh_lib
from stove_tpu_torch.train import checkpoint as ckpt_lib
from stove_tpu_torch.train import evaluate as eval_lib
from stove_tpu_torch.train.metrics import MetricsLogger

GROUPS = ("dynamics", "supair")
# the metrics of each kind of step, in the order they are all-reduced
TRAIN_METRICS = ("loss", "elbo", "log_lik", "kl", "reward_loss", "overshoot",
                 "overshoot_reward", "open_sigma_nll")
SUPAIR_METRICS = ("loss", "supair_ll", "mean_scale")
# the metrics row each kind of step writes
STEP_KEYS = {"stove": TRAIN_METRICS + ("grad_norm",), "supair": SUPAIR_METRICS}
# the repository's committed run directories: read, never written
COMMITTED_RUNS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "ckpts")


def _inside(path: str, root: str) -> bool:
    path, root = os.path.realpath(path), os.path.realpath(root)
    return os.path.commonpath([path, root]) == root


def check_run_dir(run_dir: str) -> str:
    """`run_dir`, unless it lies in the committed checkpoint store, which
    runs read and never write: then ValueError."""
    if _inside(run_dir, COMMITTED_RUNS):
        raise ValueError(f"run directory {run_dir} lies in the committed "
                         f"checkpoint store {COMMITTED_RUNS}; pass "
                         "run_dir=<elsewhere>")
    return run_dir


def anneal_steps(cfg: Config) -> int:
    """Length of the lr-anneal schedule in optimizer steps (trainer.py:45):
    debug_anneal_lr > 1 is a step count, in (0, 1] a fraction of
    num_epochs × steps_per_epoch."""
    spe = cfg.steps_per_epoch or max(1, cfg.num_train // cfg.batch_size)
    return max(int(cfg.debug_anneal_lr if cfg.debug_anneal_lr > 1
                   else cfg.debug_anneal_lr * cfg.num_epochs * spe), 1)


class Optimizer:
    """`make_optimizer` (trainer.py:56-95) written out to optax's semantics:

        chain(clip_by_global_norm(grad_clip),
              multi_transform({supair: adam(lr_s), dynamics: adam(lr_d)}))

    * clip: with n the global norm over every gradient leaf, the gradients
      are scaled by grad_clip / n only when n ≥ grad_clip (optax divides by
      n itself; `torch.nn.utils.clip_grad_norm_` divides by n + 1e-6 and
      scales whenever n > max, which is not the same);
    * Adam per group: mu = (1−b1) g + b1 mu, nu = (1−b2) g² + b2 nu,
      count += 1, update = mû / (sqrt(nû) + 1e-8) with the bias corrections
      1 − b^count;
    * the step size: a linear or cosine anneal (debug_anneal_lr > 0) read
      at each group's own schedule count before it advances, else the
      base rate.

    State per group: {"count", "mu", "nu", "lr_count"} ("lr_count" None
    without a schedule), the leaves of optax's state tree.  `update` reads
    nothing back to the host: the schedule's step size is computed on the
    state's device from "lr_count" (`lr`), and the bias corrections' bases
    are tensors built once a device.  It updates the parameters and the
    state in place, so a captured step (`Trainer`'s fused epoch) replays
    on the same storage.
    """

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.base = {"supair": cfg.supair_lr, "dynamics": cfg.dynamics_lr}
        self.scheduled = cfg.debug_anneal_lr > 0
        self.steps = anneal_steps(cfg)
        self._bases: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def lr(self, group: str, count: torch.Tensor):
        """The step size at schedule count `count` (an integer tensor), a
        0-d float32 tensor on the count's device: optax's linear_schedule
        / cosine_decay_schedule, evaluated in float64 and rounded once to
        float32 (rounding each term to float32 as well moved the two-rank
        run of tests/test_torch_parallel.py past its parameter
        tolerance); the base rate, a float, without a schedule."""
        base = self.base[group]
        if not self.scheduled:
            return base
        alpha = self.cfg.anneal_final
        c = count.to(torch.float64)
        if self.cfg.anneal_shape == "cosine":
            c = torch.clamp(c, max=float(self.steps))
            decay = 0.5 * (1 + torch.cos(math.pi * c / self.steps))
            lr = base * ((1 - alpha) * decay + alpha)
        else:
            frac = 1 - torch.clamp(c, 0, self.steps) / self.steps
            lr = (base - alpha * base) * frac + alpha * base
        return lr.to(torch.float32)

    def bias_bases(self, device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """b1 and b2 as float32 tensors on `device`, built once."""
        got = self._bases.get(device)
        if got is None:
            got = self._bases[device] = (
                torch.tensor(self.cfg.adam_b1, device=device),
                torch.tensor(self.cfg.adam_b2, device=device))
        return got

    def init(self, params: Dict) -> Dict:
        def zeros(g):
            return tree.map_leaves(torch.zeros_like, params[g])

        dev = tree.leaves(params)[0].device
        self.bias_bases(dev)
        return {g: {"count": torch.zeros((), dtype=torch.int32, device=dev),
                    "mu": zeros(g), "nu": zeros(g),
                    "lr_count": (torch.zeros((), dtype=torch.int32,
                                             device=dev)
                                 if self.scheduled else None)}
                for g in GROUPS}

    @torch.no_grad()
    def update(self, params: Dict, grads: Dict, state: Dict) -> torch.Tensor:
        """One step: params and state updated in place; returns the global
        norm of the unclipped gradients."""
        cfg = self.cfg
        all_grads = [g for grp in GROUPS for g in tree.leaves(grads[grp])]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in all_grads))
        clip = norm >= cfg.grad_clip
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        for grp in GROUPS:
            st = state[grp]
            st["count"] += 1
            count = st["count"].to(torch.float32)
            base1, base2 = self.bias_bases(count.device)
            bc1 = 1 - torch.pow(base1, count)
            bc2 = 1 - torch.pow(base2, count)
            lr = self.lr(grp, st["lr_count"])
            for p, g, mu, nu in zip(tree.leaves(params[grp]),
                                    tree.leaves(grads[grp]),
                                    tree.leaves(st["mu"]),
                                    tree.leaves(st["nu"])):
                g = torch.where(clip, (g / norm) * cfg.grad_clip, g)
                mu.mul_(b1).add_((1 - b1) * g)
                nu.mul_(b2).add_((1 - b2) * (g * g))
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)
                p.add_(upd * (-lr))
            if self.scheduled:
                st["lr_count"] += 1
        return norm


class CapturedStep:
    """A training step captured as one CUDA graph, replayed in place.

    `step()` runs once under `torch.cuda.graph` (on its side stream, after
    the caller has run the step eagerly at least once, as whole-network
    capture requires); its output, the metrics row, lives in the graph's
    memory pool and is overwritten by every replay.  `generators` are
    registered with the graph, so each replay draws from them where an
    eager step would, and advances them by as much.  The kernel launches
    the capture counted, which ran nothing, are taken back out of the
    wrappers' counters and added at every replay (`ops/launches.py`).
    """

    def __init__(self, step: Callable[[], torch.Tensor],
                 generators: Sequence[torch.Generator]):
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        snap = launches.by_library()
        with torch.cuda.graph(self.graph):
            self.out = step()
        self.per_replay = launches.since(snap)
        launches.add(self.per_replay, -1)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        launches.add(self.per_replay)
        for k, v in self.per_replay.items():
            launches.REPLAYED[k] = launches.REPLAYED.get(k, 0) + v
        return self.out


class Trainer:
    """Counterpart of the reference's `Trainer(config).train()`."""

    def __init__(self, cfg: Config, run_dir: Optional[str] = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh_lib.for_batch(mesh_lib.make_mesh(cfg),
                                       cfg.batch_size)
        self.writes = self.mesh.rank == 0 and not cfg.nolog
        self.run_dir = run_dir or os.path.join(cfg.run_dir, cfg.run_name)
        if not cfg.nolog:
            check_run_dir(self.run_dir)
        self.logger = MetricsLogger(self.run_dir if self.writes else None,
                                    echo=self.mesh.rank == 0)

        dev = self.device
        # rank 0 finds or writes the corpora, the others read them after
        if self.mesh.rank > 0:
            mesh_lib.barrier()
        self.train_ep = data_lib.ensure_dataset(cfg, "train", dev)
        self.test_ep = data_lib.ensure_dataset(cfg, "test", dev)
        if self.mesh.rank == 0:
            mesh_lib.barrier()
        if (cfg.action_conditioned and cfg.reward_balanced_loss
                and cfg.reward_pos_rate == 0.0):
            rate = float(torch.mean(self.train_ep.rewards))
            cfg = self.cfg = cfg.with_overrides(
                reward_pos_rate=round(rate, 6))

        seeds = (supair_lib.run_spec_seeds(cfg.restore, cfg)
                 if cfg.restore is not None
                 else supair_lib.draw_spec_seeds(cfg))
        if self.writes:
            ckpt_lib.save_config(self.run_dir, cfg)
            supair_lib.save_spec_seeds(self.run_dir, seeds)
        self.model = StoveModel(cfg, device=dev, seeds=seeds)
        self.params = self.model.params
        mesh_lib.replicate(tree.leaves(self.params))
        for leaf in tree.leaves(self.params):
            leaf.requires_grad_(True)
        self.optimizer = Optimizer(cfg)
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0
        self._seed_generators(cfg.seed)
        self._baselines_logged = False
        # every step's metrics (0-d tensors) of the latest epoch; the log
        # keeps only the last step's, as the reference's does
        self.epoch_metrics: List[Dict[str, torch.Tensor]] = []
        # the fused epoch's captured steps by kind
        self._graphs: Dict[str, CapturedStep] = {}

        self.start_epoch = 0
        if cfg.restore is not None:
            self.restore(cfg.restore)

    def _seed_generators(self, seed: int) -> None:
        self.data_gen = torch.Generator(device=self.device).manual_seed(
            seed + 2)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(
            seed + 3)

    # ------------------------------------------------------------- steps
    def _apply(self, loss: Optional[torch.Tensor],
               metrics: Dict[str, torch.Tensor], keys, share: float
               ) -> torch.Tensor:
        """The gradient of `share` x this rank's `loss` and its `metrics`
        (None and zeros on a rank that sits out), summed over the ranks in
        one all-reduce, then one optimizer step; returns the batch's
        metrics and the gradients' global norm as one float32 row."""
        leaves = tree.leaves(self.params)
        got = ([None] * len(leaves) if loss is None else
               torch.autograd.grad(loss * share, leaves, allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, got)]
        vals = [metrics[k].detach() * share if loss is not None
                else torch.zeros((), device=self.device) for k in keys]
        summed = mesh_lib.all_reduce_sum(grads + vals)
        grads = tree.unflatten(self.params, summed[:len(leaves)])
        norm = self.optimizer.update(self.params, grads, self.opt_state)
        return torch.stack([v.to(torch.float32)
                            for v in summed[len(leaves):]] + [norm])

    def _stove_body(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One ELBO step (trainer.py:172-194) on this rank's rows of the
        batch: the ELBO noise drawn from `noise_gen`, the gradient, the
        all-reduce and the optimizer; the metrics row (STEP_KEYS["stove"]).
        Nothing here reads the device back, so a CUDA graph captures it."""
        cfg = self.cfg
        ac = cfg.action_conditioned
        frames = batch["frames"]
        B = frames.shape[0]
        noise = stove_lib.draw_elbo_noise(cfg, B, frames.shape[1],
                                          self.noise_gen, frames.device)
        rows = self.mesh.rows(B)
        out, metrics = None, {}
        if self.mesh.active:
            f, a, r = mesh_lib.shard_batch(
                self.mesh, [frames, batch["actions"] if ac else None,
                            batch["rewards"] if ac else None], B)
            out = self.model.elbo(self.params, f, a, r,
                                  stove_lib.noise_rows(noise, rows, B),
                                  batch_rewards=batch["rewards"] if ac
                                  else None)
            metrics = dict(zip(TRAIN_METRICS, (
                out.loss, out.elbo, out.log_lik, out.kl, out.reward_loss,
                out.overshoot_loss, out.overshoot_reward_loss,
                out.open_sigma_nll)))
        return self._apply(None if out is None else out.loss, metrics,
                           TRAIN_METRICS, self.mesh.share(B))

    def _supair_body(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """SuPAIR-only warm-up step on the window's frames
        (trainer.py:196-212), this rank's windows' frames; the metrics row
        (STEP_KEYS["supair"]).  Capturable as `_stove_body`."""
        cfg = self.cfg
        B = batch["frames"].shape[0]
        frames = batch["frames"].reshape(-1, cfg.img_size, cfg.img_size)
        noise = stove_lib.draw_normals((frames.shape[0], cfg.num_obj, 4),
                                       self.noise_gen, frames.device)
        rows = self.mesh.rows(B)
        T = frames.shape[0] // B
        frame_rows = slice(rows.start * T, rows.stop * T)
        value, metrics = None, {}
        if self.mesh.active:
            value, diag = self.model.supair_elbo(
                self.params, frames[frame_rows], noise[frame_rows])
            metrics = {"loss": -diag["supair_ll"],
                       "supair_ll": diag["supair_ll"],
                       "mean_scale": diag["boxes_mean_scale"]}
        row = self._apply(None if value is None else -value, metrics,
                          SUPAIR_METRICS, self.mesh.share(B))
        return row[:len(SUPAIR_METRICS)]

    def _body(self, kind: str):
        return self._stove_body if kind == "stove" else self._supair_body

    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One ELBO step, eagerly; the batch's metrics as 0-d tensors."""
        row = self._stove_body(batch)
        self.step += 1
        return dict(zip(STEP_KEYS["stove"], row))

    def supair_step(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """One SuPAIR-only warm-up step, eagerly; its metrics."""
        row = self._supair_body(batch)
        self.step += 1
        return dict(zip(STEP_KEYS["supair"], row))

    def steps_per_epoch(self) -> int:
        if self.cfg.steps_per_epoch:
            return self.cfg.steps_per_epoch
        return max(1, self.train_ep.frames.shape[0] // self.cfg.batch_size)

    def _use_fused(self) -> bool:
        """Whether epochs are fused (trainer.py:253-261): cfg.fused_epoch
        on the card, and on the CPU only at debug sizes, so that tests
        exercise the path."""
        return self.cfg.fused_epoch and (self.device.type == "cuda"
                                         or self.cfg.debug)

    def _captures(self) -> bool:
        """Whether a fused epoch replays a captured step: on the card,
        unless the all-reduce goes through a backend other than NCCL
        (gloo's cannot be captured)."""
        return (self.device.type == "cuda"
                and mesh_lib.backend() in (None, "nccl"))

    def _sampled_step(self, kind: str) -> torch.Tensor:
        """One step of `kind` from the generators alone: a window batch
        sampled from `data_gen`, then the body; its metrics row.  What
        every epoch runs, and what the fused epoch captures."""
        batch = data_lib.sample_windows(self.train_ep, self.cfg,
                                        self.data_gen, self.cfg.batch_size)
        return self._body(kind)(batch)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch of steps_per_epoch() steps, SuPAIR-only before
        cfg.supair_only_epochs.  Fused where `_use_fused` and `_captures`,
        the counterpart of the reference's whole-epoch lax.scan
        (trainer.py:214-245): while the kind has no graph its first step
        runs eagerly (a real step of the epoch; it builds the kernels),
        then one step is captured (`CapturedStep`, kept across epochs: the
        shapes never change) and replayed for the rest, with no host sync
        between steps; a failed capture or replay raises.  Otherwise (the
        step loop, and the fused epoch on the CPU or beside a gloo
        all-reduce) every step runs eagerly.  Each step's metrics row is
        copied into one (n, M) tensor on the device; keeps them all in
        `epoch_metrics`, logs and returns the last, read from the device
        once."""
        cfg = self.cfg
        warmup = epoch < cfg.supair_only_epochs
        kind = "supair" if warmup else "stove"
        n = self.steps_per_epoch()
        keys = STEP_KEYS[kind]
        captures = self._use_fused() and self._captures()
        graph = self._graphs.get(kind) if captures else None
        rows = torch.empty((n, len(keys)), device=self.device)
        for i in range(n):
            if captures and graph is None and i > 0:
                graph = self._graphs[kind] = CapturedStep(
                    lambda: self._sampled_step(kind),
                    (self.data_gen, self.noise_gen))
            rows[i] = (graph.replay() if graph is not None
                       else self._sampled_step(kind))
            self.step += 1
        self.epoch_metrics = [dict(zip(keys, row)) for row in rows]
        out = dict(zip(keys, rows[-1].tolist()))
        self.logger.log(self.step, "train", epoch=epoch, warmup=warmup, **out)
        return out

    # ------------------------------------------------------------- eval
    @torch.no_grad()
    def evaluate(self, epoch: int) -> Dict[str, float]:
        """Rollout metrics on the test corpus (trainer.py:290-345), with
        noise from a generator seeded by cfg.seed + 7919 and the step."""
        cfg = self.cfg
        self.model.set_params(self.params)
        gen = torch.Generator().manual_seed(cfg.seed + 7919 + self.step)
        m = eval_lib.rollout_metrics(self.model, self.test_ep, gen)
        if cfg.eval_longhorizon > 0:
            n_val = self.test_ep.frames.shape[0] // 2
            val_ep = data_lib.Episode(*(x[:n_val] for x in self.test_ep))
            lh = eval_lib.longhorizon_metrics(self.model, val_ep, gen,
                                              t_pred=cfg.eval_longhorizon)
            m["val_speed_ratio"] = lh["speed_ratio"]
            m["val_in_frame"] = lh["frac_in_frame"]
            lhs = eval_lib.longhorizon_metrics(self.model, val_ep, gen,
                                               t_pred=cfg.eval_longhorizon,
                                               sample=True)
            m["val_speed_ratio_sampled"] = lhs["speed_ratio"]
            m["val_in_frame_sampled"] = lhs["frac_in_frame"]
        if not self._baselines_logged:
            self._baselines_logged = True
            bl = eval_lib.baseline_metrics(cfg, self.test_ep)
            self.logger.log(self.step, "baseline", **_plain(bl))
        flat = _plain(m)
        self.logger.log(self.step, "eval", epoch=epoch, **flat)
        if (cfg.supair_only_epochs <= epoch
                < cfg.supair_only_epochs + 4 * max(1, cfg.eval_every)
                and flat.get("detect_mse", 0.0) > 0.05):
            print(f"[warn] detect_mse={flat['detect_mse']:.3f} at epoch "
                  f"{epoch}: recognition/tracking handoff failure signature "
                  "— this seed is unlikely to recover; consider restarting "
                  "with a different seed", flush=True)
        if self.writes:
            try:
                self._dump_gif(epoch)
            except OSError as e:       # a full disk must not end training
                print(f"[viz] gif dump failed: {e}", flush=True)
        return flat

    @torch.no_grad()
    def _dump_gif(self, epoch: int) -> str:
        """true | reconstruction→prediction GIF of the first test sequence
        (trainer.py:347): the posterior over cfg.window frames (noise from
        a generator seeded as this evaluation's), then a mean rollout of
        cfg.eval_rollout_steps from its last mean (the rollout kernel on
        the card); the model panel shows the posterior means for t <
        window, then the prediction.  Written to
        `<run_dir>/rollout_ep%04d.gif`."""
        from stove_tpu_torch.train import visualize as viz

        cfg = self.cfg
        t_cond, t_pred = cfg.window, cfg.eval_rollout_steps
        frames = data_lib.normalize_frames(self.test_ep.frames[:1, :t_cond])
        actions = self.test_ep.actions[:1]
        gen = torch.Generator().manual_seed(cfg.seed + 7919 + self.step)
        inf = self.model.infer(frames, actions[:, :t_cond], generator=gen)
        states, _ = self.model.rollout(
            inf.z_mean[:, -1], actions[:, t_cond - 1:t_cond - 1 + t_pred],
            t_pred, gen, sample=False)
        model_pos = torch.cat([inf.pos_mean[0], states[0, :, :, 2:4]], 0)
        model_size = torch.cat([inf.z_mean[0, :, :, 0:2],
                                states[0, :, :, 0:2]], 0)
        true = data_lib.normalize_frames(
            self.test_ep.frames[0, :t_cond + t_pred])
        return viz.dump_rollout_gif(cfg, self.run_dir, f"ep{epoch:04d}",
                                    true.cpu().numpy(),
                                    model_pos.cpu().numpy(),
                                    pred_sizes=model_size.cpu().numpy())

    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        result: Dict[str, float] = {}
        for epoch in range(self.start_epoch, cfg.num_epochs):
            result.update(self.train_epoch(epoch))
            if (epoch + 1) % cfg.eval_every == 0:
                result.update(self.evaluate(epoch))
            if self.writes and (epoch + 1) % cfg.ckpt_every == 0:
                self.save(epoch)
        if self.writes:
            self.save(cfg.num_epochs - 1)
        return result

    # ------------------------------------------------------------- persistence
    def save(self, epoch: int) -> None:
        ckpt_lib.save(self.run_dir, self.step, self.params, self.opt_state,
                      epoch, keep=self.cfg.ckpt_keep)

    def restore(self, run_dir: str) -> None:
        step, params, opt_state, epoch = ckpt_lib.restore(
            run_dir, GROUPS, device=self.device)
        with torch.no_grad():
            for dst, src in zip(tree.leaves(self.params),
                                tree.leaves(params)):
                if dst.shape != src.shape:
                    raise ValueError(f"checkpoint leaf of shape "
                                     f"{tuple(src.shape)}, model expects "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        for g in GROUPS:
            if (opt_state[g]["lr_count"] is None) == self.optimizer.scheduled:
                raise ValueError(f"checkpoint's {g!r} schedule state does "
                                 "not match the config's debug_anneal_lr")
        self.opt_state = opt_state
        self.step = step
        self.start_epoch = epoch + 1
        self._seed_generators(self.cfg.seed * 1_000_003 + step)
        # the captured steps hold the old optimizer state and generators
        self._graphs = {}
        print(f"[restore] {run_dir} at step {step}, epoch {epoch}: the JAX "
              "PRNG key is not used; window and ELBO noise generators "
              f"reseeded from seed {self.cfg.seed} and step {step}",
              flush=True)


def _plain(metrics: Dict) -> Dict:
    return {k: (v.detach().cpu().numpy().tolist()
                if isinstance(v, torch.Tensor) and v.ndim
                else float(v)) for k, v in metrics.items()}
