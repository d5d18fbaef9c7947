"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100: `python3 chip_smoke.py`.

Builds every kernel library the run launches from the checkout's sources
(one nvcc per library, all at once): the rollout source for the
action-free model, the action-conditioned one and the open-loop std head,
each in both of the TPU kernel's precisions (float32 on the CUDA cores,
bfloat16 on the tensor cores) and at both tiles (16 samples a block, 4
below 132 blocks); the scan source, on the same dynamics core, per velocity
mode and with actions and the reward head, in both precisions for the three
models' training at the small tile (the training batch's) and for billiards
at 16 samples a block; the SPN and likelihood sources.  It holds each
kernel against its plain PyTorch version on the card,
runs `mode=eval` of the trained 3-ball billiards model (ckpts/r4rp_bill_s32,
full width) and STOVE training at full width through the port's entry
points, resumes the trained run through the kernels, times the kernels
and the training step, then runs `mode=eval` and MCTS planning
(`mode=mcts`) of the trained action-conditioned avoidance model
(ckpts/r4a_dense_s2, full width) through the action-conditioned rollout
kernel, trains that model from scratch and resumes it through the scan
kernel with actions and the reward head, runs `mode=eval` and resumed
training of the trained gravity model (ckpts/r4rp_grav_s32, full width)
through the rollout kernel's open-loop std head, holds the bfloat16
libraries against the plain version at bfloat16, plans with bfloat16
leaves (`mcts_rollout_impl=pallas`) and times every rollout library in
both precisions, then drives the CLI's last modes -- `mode=generate`
(and training from its files), `mode=viz` of the billiards and the
avoidance model, `mode=profile` -- and holds the SuPAIR settings
`spn_impl=matmul` and `overlap_impl=image` against float64; then
`compute_dtype=bfloat16` on every path (the rollout library's third
precision, "dense_bf16", against its plain version, bf16 eval of the three
models, bf16 training) and data parallelism on the one card (NCCL at world
1, two ranks over gloo).  Every phase
that reads a corpus gets a fresh `data_dir`.  Training with `scan_impl=pallas` runs the scan's bf16
library forward, as the JAX package's `_scan_pallas` does.  One line per
phase, with the seconds since start:

  (0) device      card name and power limit (nvidia-smi); TF32 off
  (1) build       nvcc of every kernel library: seconds, registers, spills,
                  dynamic shared memory
  (2) mean        kernel vs plain mean rollout, f32, trained weights, z0 from
                  the posterior of rendered frames: max |err| over steps 1-8
                  <= 1e-4 against the plain version in float32 and float64;
                  over all 80 steps of the eval's horizon, the kernel's
                  distance from float64 <= 2x the float32 plain version's
  (3) sampled     eps recovered from H=1 samples (>= 1e6 draws): |mean| and
                  |std - 1| < 0.01, share beyond 5 sigma < 1e-5; H=92
                  position dispersion ratio kernel/plain in [0.9, 1.1]
  (4) eval        mode=eval on the card with the entry point's own precision
                  (kernel launches > 0, TF32 off, mse_final finite and below
                  the constant-velocity baseline), and again with the plain
                  rollout (no launch): mean-path metrics agree to 1e-4 relative
                  (the 80-step speed ratio, past where float32 rollouts
                  drift apart, to 1e-2)
  (5) throughput  sampled kernel at B=16384, H=92 (then B=65536 if time
                  allows): warm-up + 10 runs timed with CUDA events; the
                  bf16 library (the TPU kernel's perf path) at B=16384
  (6) spn         SPN kernel vs plain on one training step's object patches
                  (6144, 100) and frames (2048, 1024), trained weights and
                  region graphs: |err| <= 1e-5 * max(|log p|, 100); the
                  packing kernel vs its plain version, 1e-6 relative
  (7) likelihood  likelihood kernel vs plain on 2048 rendered frames with
                  posterior boxes, the same limits
  (8) scan        scan kernel (float32 library) vs plain at B=256, T2=6,
                  trained weights, pre-drawn eps, and at B=255 (the small
                  tile's last block ragged) and B=2113 (16 samples a block):
                  z, z_mean within 1e-4 of the float32 and float64 plain
                  versions, kl within 2e-5 relative; the other three
                  velocity modes with random weights at B=63 (2e-4)
  (9) train       from scratch at full width through the entry point: 2
                  warm-up + 3 STOVE steps with the scan and likelihood
                  kernels, then 1 + 1 with the SPN kernel; losses finite,
                  launches > 0; one batch's gradients kernel vs plain path
                  (the scan on its float32 library), leaf by leaf, within
                  1e-3 of each leaf's largest entry or the plain path's own
                  floor where that is higher (its gradient's change when
                  the frames move by 1e-5); mixture logits: 1e-6 absolute,
                  their scale being 1
  (10) resume     restore=ckpts/r4rp_bill_s32 mode=train num_epochs=361
                  through the kernels: 20 steps, mean elbo in [1197, 1248],
                  kl in [-10.5, -7.5] (the JAX package's own float32 value
                  on these weights, see there), overshoot < 0.02, nothing
                  written under ckpts/
  (11) timing     STOVE and warm-up step, kernel vs plain path (host clock,
                  synchronised), and each kernel vs its plain version at the
                  training shapes (CUDA events), beside its bound; the
                  scan's weight packing, and the SPNs' and the
                  likelihood's packing kernels (once a call) vs their plain
                  version
  (12) act-mean   action-conditioned kernel (actions, reward head) vs plain
                  mean rollout, r4a_dense_s2 weights, z0 from the posterior
                  of rendered avoidance frames, random actions.  At B=360
                  H=10 (the checkpoint's own 10-episode planner leaf), B=360
                  H=1 (its step) and B=100 H=8 (the eval): states within
                  1e-4 over steps 1-8 against the plain version in float32
                  and float64.  At those and at the planning run's leaf and
                  step (B = E·K·A = 576, H=10 and H=1), and after (14) and
                  (15) at every other mean shape they launched: step 1's
                  states within 1e-4 of both, rewards within 1e-4 of both
                  over steps 1-8 (a long horizon also held by phase (2)'s
                  criterion); the 8-step state distances printed beside the
                  float32 plain version's own (card and CPU)
  (13) act-sampled H=92 position dispersion ratio kernel/plain with one
                  action sequence for all 8192 samples, in [0.9, 1.1]
  (14) avoid-eval mode=eval of ckpts/r4a_dense_s2 on the card (launches > 0,
                  TF32 off, mse_final finite and below the constant-velocity
                  baseline), again with the plain rollout (no launch):
                  metrics agree to 1e-4 relative (the 80-step speed ratio to
                  1e-2); mse_final, detect_mse and reward_auc inside
                  AVOID_BAND, the JAX package's values on the same corpus
                  (tests/test_torch_avoidance.py); launches by shape
  (15) plan       mode=mcts of ckpts/r4a_dense_s2 with mcts_episodes=16,
                  mcts_episode_len=40 (other planner fields from the run):
                  oracle mean > model mean > random mean, the paired gain of
                  the model over random > 2 SEM; rollout launches per round
                  and by shape
  (16) act-timing the action-conditioned kernel at the planning run's leaf
                  (B=576 H=10) and step (B=576 H=1), at the checkpoint's own
                  leaf (B=360 H=10) and at B=16384 H=92 sampled (CUDA
                  events), beside its bound and its plain version
  (17) scan-act   scan kernel with actions and the reward head vs plain at
                  B=256, T2=10: r4a_dense_s2 weights, posterior inputs of
                  rendered avoidance frames, their actions, pre-drawn eps;
                  z, z_mean within 1e-4 of the float32 and float64 plain
                  versions, kl within 2e-5 relative, rewards within 1e-4 and
                  spanning both classes; the same for the gravity model's
                  window (B=256, T2=14); each again at B=255
  (18) avoid-train preset=stove_avoidance from scratch at full width (only
                  the corpus cut): 2 warm-up + 3 STOVE steps through the
                  scan and likelihood kernels, every loss finite (the reward
                  and overshoot-reward losses too), launches > 0; one
                  batch's gradients kernel vs plain path to phase (9)'s
                  limits and floor, the reward heads' and action rows'
                  nonzero
  (19) avoid-resume restore=ckpts/r4a_dense_s2 mode=train for 20 steps
                  through the kernels: mean elbo, kl and reward_loss inside
                  AVOID_RESUME_BAND (the JAX package's float32 values at
                  those weights on the port's corpus); nothing written under
                  ckpts/
  (20) open-sampled the sampled rollout with the open-loop std head,
                  r4rp_grav_s32 weights, z0 from the posterior of rendered
                  gravity frames: eps recovered at H=1 (>= 1e6 draws) with
                  rollout_sigma_temp * std_open to phase (3)'s limits; the
                  same normals through the library without the head give
                  the injected std, within 1e-2 relative of the plain
                  head's; H=92 dispersion ratio kernel/plain in [0.9, 1.1];
                  the model's mean rollout by phase (2)'s criterion; the
                  library with actions, reward head and open head (no
                  committed run has it: random open-head weights on
                  r4a_dense_s2) at B=576, H=10, sampled: every step's eps
                  recovered to phase (3)'s limits, rewards within 1e-4
  (21) grav-eval  mode=eval of ckpts/r4rp_grav_s32 on the card (launches of
                  the open-head library, TF32 off, mse_final below the
                  constant-velocity baseline), again with the plain rollout
                  (phase (4)'s limits); mse_final, detect_mse and the mean
                  80-step speed_ratio inside GRAV_EVAL_BAND; the sampled
                  80-step speed_ratio and frac_in_frame beside the plain
                  path's, within the range of 8 plain draws widened by its
                  width; launches by shape
  (22) grav-train restore=ckpts/r4rp_grav_s32 mode=train from step 5200, 20
                  steps through the kernels and the Trainer's evaluation
                  (eval_every=1: its sampled 80-step rollouts launch the
                  open-head library): mean elbo, kl, overshoot and
                  open_sigma_nll inside GRAV_RESUME_BAND; nothing written
                  under ckpts/
  (23) timing4    the scan kernel at (256, 10) with actions and the reward
                  head and at (256, 14) for gravity, the open-head sampled
                  rollout at B=16384, H=92 (CUDA events), each beside its
                  bound and plain version; the launches of each new path

  (24) bf16      each bf16 rollout library against the plain version at
                  bf16 over 4 steps -- billiards from phase (2)'s posterior
                  states and avoidance with random actions (and rewards), at
                  B=16384 (16 samples a block) and the planner's B=576 (4):
                  at every step the median of |kernel - plain bf16| over the
                  step and over each state column's (sample, object)
                  entries at most 0.1x that of |plain bf16 - plain f32|,
                  the largest |kernel - plain bf16| at most 2x the largest
                  |plain bf16 - plain f32|, at most 1e-2 of the entries
                  (rewards 3e-2, or one (sample, object) row's where that
                  is more) above 0.1x that largest distance; the float32
                  libraries at
                  B=16384, H=8: step 1 within 1e-4 of the float32 and float64
                  plain versions, the 8-step distance from float64 at most
                  2x the float32 plain version's, rewards within 1e-4; each
                  precision's open-loop head by the implied std of phase
                  (20) (median relative error <= 1e-2; float32's maximum
                  too); the bf16 scan libraries against the plain loop at
                  bf16 on each model's posterior windows at B=256 and 255
                  (billiards also 2113, 16 samples a block), by the same
                  criterion (z, z_mean, rewards; kl by the median and the
                  2x maximum)
  (25) plan-bf16  mode=mcts of ckpts/r4a_dense_s2 with
                  mcts_rollout_impl=pallas (leaves in bf16, steps in
                  float32), 16 episodes of 40 steps: phase (15)'s limits,
                  one bf16 small-tile leaf launch and one float32 step a
                  round
  (26) timing5    every rollout library at its paths' launch shapes --
                  B=16384 H=92 sampled and mean, the planner's leaf (576,
                  10) and step (576, 1), the eval's (100, 8) and (32, 80),
                  the open head at (16384, 92) and (32, 80) sampled --
                  float32 and bf16 in turns (f32, bf16, bf16, f32), each
                  beside its plain version at that precision and its bound;
                  the bf16 and velocity-mode scan libraries at their
                  training shapes, the 16-sample ones at B=4096, beside
                  their bounds (bf16: operations at the tensor-core peak)
                  and the weight packing each scan_kernel call does

  (27) generate   mode=generate of preset=stove_billiards (64 train, 32
                  test sequences) on the card into a fresh data_dir: both
                  files load back equal, array for array, to split() on the
                  card; one training step at batch 256 from those files
                  (the Trainer generating nothing) with the scan and
                  likelihood kernels, and one with the scan and SPN kernels
                  (the fused likelihood evaluates both SPNs inside its own
                  kernel): losses finite, those kernels launched
  (28) viz        mode=viz of ckpts/r4rp_bill_s32 and ckpts/r4a_dense_s2:
                  rollout_viz.gif (eval_rollout_steps frames, 264 x 128, by
                  the port's own GIF header reader) and detect_grid.png
                  under the run dir, nothing written under ckpts/, one
                  launch of the rollout library (rollout_act's for the
                  avoidance model); a run dir inside ckpts/ refused
  (29) profile    mode=profile at the published batch (256 windows of 8
                  frames), once with the three pallas impls and once with
                  the scan and SPN kernels beside the plain likelihood: the
                  trace (utils/profiling.py) parses; the device busy share
                  over its 3 steps and the top device events; the scan's,
                  likelihood's and SPN's kernels among its CUDA events
  (30) supair     the plain likelihood at 2048 frames (posterior boxes of
                  rendered frames) with spn_impl=matmul, with
                  overlap_impl=image and with both, against the dense plain
                  version in float64 with the same claim weights: 1e-5 of
                  max(|log p|, 100), no kernel launched, each timed beside
                  the dense float32 version; likelihood_impl=pallas with
                  overlap_impl=image raises before any launch

  (31) dense-bf16 the rollout library at compute_dtype=bfloat16's precision
                  (-DSTOVE_BF16=2: the attention column and the reward
                  head's geometry rows and last columns rounded too)
                  against the plain version at "dense_bf16" by (24)'s
                  criterion, from posterior states: billiards and gravity
                  at the eval's (100, 8), avoidance at the planner's (576,
                  10) with random actions (and rewards); the TPU kernel's
                  variant beside it (its median distance from the dense
                  plain version over the bf16 - f32 one, steps 1-4); each
                  timed in turns with the float32 and the variant's
                  libraries beside the plain version and the bf16 bound;
                  the gravity model's open-loop head by the implied std
                  (median relative error <= 1e-2), timed at (32, 80)
                  sampled beside float32's
  (32) bf16-eval  mode=eval at compute_dtype=bfloat16 of ckpts/r4rp_bill_s32,
                  ckpts/r4rp_grav_s32 and ckpts/r4a_dense_s2: rollouts
                  through the dense bf16 libraries only, mse_final finite
                  and below the constant-velocity baseline, billiards' and
                  gravity's inside BF16_EVAL_BANDS (the JAX package's bf16
                  values on the port's corpus)
  (33) bf16-train preset=stove_billiards compute_dtype=bfloat16 from scratch
                  at batch 256 (only the corpus cut): 2 warm-up + 6 STOVE
                  steps through the scan and likelihood kernels and one
                  evaluation; finite losses, the last logged STOVE loss
                  below the first; the step against float32's in turns;
                  one batch's gradients, kernel path against the plain
                  path with its semantics, by phase (9)'s limits (the
                  floor doubled: at bf16 it is rounding flips)
  (34) parallel   dryrun_multichip (stove_tpu_torch/parallel/dryrun.py) with
                  NCCL at world size 1: equal bit for bit to the step
                  without a process group; two ranks over gloo sharing
                  the card when gloo takes CUDA tensors (NCCL refuses two
                  ranks on one device): the sharded loss within rel 1e-4
                  of one device's; mesh_shape=(2,) in one process raises

Any failed check raises, so the script exits non-zero and prints no result.
The last three lines are the kernel table (JSON; one entry per library,
its launches counted on the main paths -- every run through the entry
points and phase (5)'s throughput measurement -- by the wrappers' counts
by library), the card's name and power limit, and the result JSON.
Writes nothing into the repository but the git-ignored build directory;
runs and corpora go to temporary directories.  Imports nothing of JAX or
the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import time

T0 = time.perf_counter()
RUN = "ckpts/r4rp_bill_s32"
AVOID = "ckpts/r4a_dense_s2"
GRAV = "ckpts/r4rp_grav_s32"
# mode=eval of AVOID on the card must land here: the range of the JAX
# package's float32 metrics on the port's test corpus over the posterior
# draws of jax.random.key(0..31), widened by half its width on each side
# (tests/test_torch_avoidance.py::test_eval_band_from_the_jax_package
# recomputes the draws and checks this band on the CPU; the port equals
# the JAX package under the same draw, test_eval_matches_jax_on_its_noise)
AVOID_BAND = {"mse_final": (0.0086, 0.0129), "detect_mse": (2.14e-4, 2.37e-4),
              "reward_auc": (0.861, 0.914)}
# mode=eval of GRAV on the card (phase (21)) and its 20 resumed steps
# (phase (22)), and the 20 resumed steps of AVOID (phase (19)), must land
# here: the range of the JAX package's float32 values at the restored
# weights on the port's corpora, widened by half its width on each side --
# mode=eval's metrics over the posterior draws of jax.random.key(0..15),
# the ELBO terms over 8 batches of 32 training windows under JAX's noise
# (tests/test_torch_gravity_eval.py, tests/test_torch_gravity.py and
# tests/test_torch_avoidance_train.py recompute the draws and check these
# bands; the port equals the JAX package under the same draws).
AVOID_RESUME_BAND = {"elbo": (868.8, 883.7), "kl": (-9.08, -7.48),
                     "reward_loss": (0.134, 0.291)}
GRAV_EVAL_BAND = {"mse_final": (0.0044, 0.0080),
                  "detect_mse": (2.63e-4, 3.44e-4),
                  "longhorizon_speed_ratio": (0.971, 1.075)}
GRAV_RESUME_BAND = {"elbo": (1110.0, 1163.0), "kl": (-21.6, -8.0),
                    "overshoot_loss": (0.088, 0.171),
                    "open_sigma_nll": (-56.7, 53.2)}
# mode=eval of RUN and GRAV at compute_dtype=bfloat16 on the card (phase
# (32)) must land here: the range of the JAX package's mse_final at
# compute_dtype=bfloat16 on the port's test corpus over the posterior draws
# of jax.random.key(0..15), widened by half its width on each side
# (tests/test_torch_compute_bf16.py::test_bf16_eval_band_from_the_jax_package
# recomputes the draws and checks these bands on the CPU).
BF16_EVAL_BANDS = {"billiards": {"mse_final": (0.0070, 0.0112)},
                   "gravity": {"mse_final": (0.0046, 0.0073)}}
BUDGET_S = 240.0          # start the optional B=65536 timing only before this
# the scan's velocity modes besides the trained models' (mode 2), held with
# random weights in phase (8) and timed in phase (26)
SCAN_MODES = {"velocity_obs_full_std=False": dict(velocity_obs_full_std=False),
              "velocity_obs=filtered": dict(velocity_obs="filtered"),
              "velocity_posterior=False": dict(velocity_posterior=False)}


def phase(name: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] ({name}) {msg}", flush=True)


TEMP_DIRS: list = []         # directories made by this run, removed at the end


def fresh_data() -> str:
    """A `data_dir=` token naming a new empty directory: every phase that
    reads a corpus (`ensure_dataset`) generates and writes its own, and
    never reads one that an earlier run left under the default `data`."""
    import tempfile
    TEMP_DIRS.append(tempfile.mkdtemp(prefix="chip_smoke_data_"))
    return f"data_dir={TEMP_DIRS[-1]}"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def macs_per_frame(cfg, open_head: bool = False) -> int:
    """Multiply-adds of one dynamics step for one sample (all objects), as
    the kernel computes them: embed, self, receiver|sender, the relational
    MLP over O(O-1) ordered pairs, the output MLP (padded last layer
    counted at its true width); with a reward head, its two heads per
    object: [s ; r] -> h, h -> h, h -> 1 (the gap and distance rows are
    elementwise); with the open-loop std head, [s ; r] -> h -> 4 + cl."""
    O, h, D, cl = cfg.num_obj, cfg.dyn_hidden, cfg.full_state_dim, cfg.cl
    per_obj = D * h + h * h + 2 * h * h + 2 * h * h + 2 * h * h + h * h \
        + h * (6 + 2 * cl)
    if cfg.reward_head:
        per_obj += 2 * (2 * h * h + h * h + h)
    if open_head:
        per_obj += 2 * h * h + h * (4 + cl)
    per_pair = h * h + h * (h + 1)
    return O * per_obj + O * (O - 1) * per_pair


def batch_rows(x, n: int):
    """The first n rows of x along dim 0, x repeated as often as needed."""
    return x.repeat((-(-n // x.shape[0]),) + (1,) * (x.dim() - 1))[:n] \
        .contiguous()


def time_cuda(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from stove_tpu_torch import main as entry
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.models import dynamics as dyn_lib
    from stove_tpu_torch.models.bundle import StoveModel
    from stove_tpu_torch.ops import fused_rollout as fr
    from stove_tpu_torch.train import checkpoint as ckpt_lib

    # ---- (0) device
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    phase("device", f"{torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; TF32 off")

    # ---- (1) build: every kernel library of both slices, one nvcc each,
    # all started together
    from stove_tpu_torch.ops import _build
    from stove_tpu_torch.ops import fused_likelihood as flik
    from stove_tpu_torch.ops import fused_scan as fscan
    from stove_tpu_torch.ops import fused_spn as fspn
    cfg = ckpt_lib.load_config(RUN)
    model = StoveModel.from_run(RUN, device=dev)
    sspecs = model.specs.supair
    acfg = ckpt_lib.load_config(AVOID)
    gcfg = ckpt_lib.load_config(GRAV)
    ocfg = acfg.with_overrides(open_loop_sigma=True)
    count_main_paths()
    loaders = {}
    for c, op, dts, tiles in ((cfg, False, fr.DTYPES, (16, 4)),
                              (acfg, False, fr.DTYPES, (16, 4)),
                              (gcfg, True, fr.DTYPES, (16, 4)),
                              (ocfg, True, ("float32",), (4,)),
                              (cfg, False, ("dense_bf16",), (4,)),
                              (acfg, False, ("dense_bf16",), (4,)),
                              (gcfg, True, ("dense_bf16",), (4,))):
        for dt in dts:
            for tile in tiles:
                if (c, op, dt, tile) == (gcfg, True, "bfloat16", 4):
                    continue           # no path launches it
                loaders[fr.job(c, op, dt, tile)] = (
                    lambda c=c, op=op, dt=dt, tile=tile: fr.load(
                        c, op, dt, tile).stove_rollout_smem_bytes())
    for c, dts, tiles in (
            (cfg, fr.DTYPES, (fr.SMALL_TILE, fr.TILE)),
            (acfg, fr.DTYPES, (fr.SMALL_TILE,)),
            (gcfg, fr.DTYPES, (fr.SMALL_TILE,)),
            *[(cfg.with_overrides(**kw), ("float32",), (fr.SMALL_TILE,))
              for kw in SCAN_MODES.values()]):
        for dt in dts:
            for tile in tiles:
                loaders[fscan.job(c, dt, tile)] = (
                    lambda c=c, dt=dt, tile=tile: fscan.load(
                        c, dt, tile).stove_scan_smem_bytes())
    for spec in (sspecs.obj, sspecs.bg):
        loaders[fspn.job(spec)] = (
            lambda spec=spec: fspn.load(spec).stove_spn_smem_bytes())
    loaders[flik.job(cfg, sspecs)] = (
        lambda: flik.load(cfg, sspecs).stove_lik_smem_bytes())
    jobs = list(loaders)
    t = time.perf_counter()
    paths = _build.build(jobs)
    phase("build", f"{len(jobs)} libraries in {time.perf_counter() - t:.1f} s")
    for job_, path in zip(jobs, paths):
        secs = _build.BUILDS.get(str(path), (0.0, ""))[0]
        report = _build.ptxas_report(path)
        smem = loaders[job_]()
        note(job_, ptxas=report, smem_bytes=smem)
        phase("build", f"{job_[0]} {' '.join(job_[1])}: nvcc {secs:.1f} s; "
              f"{report or 'already built'}; dynamic smem {smem} B")

    # ---- (2) mean path, z0 from the posterior of rendered frames
    dyn = model.params["dynamics"]
    gen = torch.Generator().manual_seed(0)
    pcfg = cfg.with_overrides(seq_len=cfg.window)
    ep = data_lib.generate(pcfg, 16384, gen, dev)
    with torch.no_grad():
        inf = model.infer(data_lib.normalize_frames(ep.frames), None,
                          generator=gen)
    z_post = inf.z_mean[:, -1].contiguous()                    # (16384, O, D)
    check(bool(torch.isfinite(z_post).all()), "posterior states finite")
    groups = {"size": (0, 2), "pos": (2, 4), "vel": (4, 6),
              "latent": (6, None)}
    phase("mean", "posterior states, max |z| by rows: " + ", ".join(
        f"{k} {z_post[..., a:b].abs().max().item():.3f}"
        for k, (a, b) in groups.items()))
    max_err = hold_mean_rollout("mean", dyn, cfg, z_post, model.prepared)

    # ---- (3) sampled path, in distribution
    z0 = z_post
    s = fr.rollout_states(dyn, cfg, z0, 1, True, torch.Generator().manual_seed(1),
                          model.prepared)[:, 0]
    d = dyn_lib.apply(dyn, cfg, z0)
    eps = (s - d.mean) / (cfg.rollout_sigma_temp * d.std_open)
    e_mean, e_std = eps.mean().item(), eps.std().item()
    e_tail = (eps.abs() > 5).double().mean().item()
    phase("sampled", f"H=1 eps over {eps.numel()} draws: mean {e_mean:+.5f} "
          f"std {e_std:.5f} share>5sigma {e_tail:.2e} max|eps| "
          f"{eps.abs().max().item():.3f}")
    check(eps.numel() >= 10 ** 6, "at least 1e6 draws")
    check(abs(e_mean) < 0.01 and abs(e_std - 1) < 0.01 and e_tail < 1e-5,
          "sampled normals' moments")
    Bd, Hd = 8192, 92
    z_one = z_post[:1].expand(Bd, -1, -1).contiguous()    # same start
    got = fr.rollout_states(dyn, cfg, z_one, Hd, True,
                            torch.Generator().manual_seed(2), model.prepared)
    noise = torch.randn((Bd, Hd) + tuple(z_one.shape[1:]),
                        generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev)
    ref, _ = fr.rollout_states_reference(dyn, cfg, z_one, Hd, noise)
    disp = lambda x: x[:, -1, :, 2:4].std(dim=0).mean().item()  # noqa: E731
    ratio = disp(got) / max(disp(ref), 1e-12)
    phase("sampled", f"H={Hd} B={Bd} position dispersion kernel/plain = "
          f"{ratio:.4f} ({disp(got):.4f} / {disp(ref):.4f})")
    check(0.9 <= ratio <= 1.1, f"dispersion ratio {ratio}")

    # ---- (4) eval through the entry point, counts read around it.  The
    # entry point sets its own float32 precision (TF32 off), so torch's
    # default cuDNN setting is restored first and the setting checked after.
    argv = [f"restore={RUN}", "mode=eval", fresh_data()]
    ecfg, _, edev = entry.build_config(argv)
    torch.backends.cudnn.allow_tf32 = True
    fr.launch_kernel.launches = 0
    t = time.perf_counter()
    m = entry.run_eval(ecfg, edev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    launches = fr.launch_kernel.launches
    for k, v in m.items():
        print(f"  {k}: {v.detach().cpu().numpy()}")
    phase("eval", f"mode=eval on the card {eval_s:.2f} s; rollout kernel "
          f"launches {launches}")
    check(launches > 0, "eval path launched the rollout kernel")
    check(not (torch.backends.cudnn.allow_tf32
               or torch.backends.cuda.matmul.allow_tf32),
          "the entry point runs with TF32 off")
    mse, lin = m["mse_final"].item(), m["linear_mse_final"].item()
    check(math.isfinite(mse) and mse < lin,
          f"mse_final {mse} finite and below linear baseline {lin}")

    compare_plain_eval("eval", m, ecfg, edev, launches)

    # ---- (5) throughput of the sampled kernel
    macs = macs_per_frame(cfg)
    gen5 = torch.Generator().manual_seed(5)
    times = {}
    for B in (16384, 65536):
        if B > 16384 and time.perf_counter() - T0 > BUDGET_S:
            phase("throughput", f"B={B} skipped: time budget")
            continue
        z0 = z_post.repeat(B // 16384, 1, 1).contiguous()
        snap = library_counts()
        ms = time_cuda(lambda: fr.rollout_states(
            dyn, cfg, z0, 92, True, gen5, model.prepared), iters=10)
        for k, v in counted_since(snap).items():
            MAIN_PATH[k] = MAIN_PATH.get(k, 0) + v
        times[B] = ms
        phase("throughput", f"sampled kernel B={B} H=92: {ms:.3f} ms/call, "
              f"{B * 92 / ms * 1e3:,.0f} frames/s on {card}")
    B = 16384
    z0 = z_post
    noise = torch.randn((B, 92) + tuple(z0.shape[1:]), device=dev)
    plain_ms = time_cuda(lambda: fr.rollout_states_reference(
        dyn, cfg, z0, 92, noise), iters=3)
    flops = 2.0 * macs * B * 92
    nbytes = 4.0 * z0.numel() * (1 + 92) + model.prepared.numel()
    bound_ms, _ = rollout_bound(flops, nbytes, "float32")
    phase("throughput", f"plain version B={B} H=92: {plain_ms:.3f} ms/call; "
          f"{macs} MACs/frame, bound {bound_ms:.3f} ms (f32 67 TFLOP/s), bf16 "
          f"tensor-core bound {flops / BF16_PEAK * 1e3:.3f} ms; kernel at "
          f"{flops / (times[B] * 1e-3) / 1e12:.2f} TFLOP/s")
    # the TPU kernel's perf path (bench.py:199-205): the bf16 library
    pb = model.prepared_for("bfloat16")
    snap = library_counts()
    bf_ms = time_cuda(lambda: fr.rollout_states(
        dyn, cfg, z0, 92, True, gen5, pb, "bfloat16"), iters=10)
    for k, v in counted_since(snap).items():
        MAIN_PATH[k] = MAIN_PATH.get(k, 0) + v
    times["bf16"] = bf_ms
    phase("throughput", f"sampled bf16 kernel B={B} H=92: {bf_ms:.3f} ms/call"
          f", {B * 92 / bf_ms * 1e3:,.0f} frames/s on {card}")


    note(fr.job(cfg, False, "float32", 4), err=max_err)
    note(fr.job(cfg, False, "float32", 16), ms=times[B], plain_ms=plain_ms,
         bound=(bound_ms, "operations"),
         shape={"model": "billiards", "B": B, "H": 92, "sample": True},
         ms_b65536=times.get(65536))

    act = avoidance_slice(card, dev)
    note(fr.job(acfg, False, "float32", 4), err=act["entry"]["max_abs_err"],
         err_rewards=act["entry"]["max_abs_err_rewards"])
    tr = training_slice(card, dev, cfg, model)
    note(fscan.job(cfg), ms=tr["scan_ms"], plain_ms=tr["scan_plain_ms"],
         bound=tr["scan_bound"], shape={"model": "billiards", "B": 256,
                                        "T2": 6})
    four = fourth_slice(card, dev)
    ti = four["timing"]
    note(fscan.job(acfg), err=four["scan_act_err"],
         err_rewards=four["scan_act_rew_err"], ms=ti["scan_avoid"][0],
         plain_ms=ti["scan_avoid"][1], bound=ti["scan_avoid"][2:],
         shape={"model": "avoidance", "B": 256, "T2": 10})
    note(fscan.job(gcfg), err=four["scan_grav_err"], ms=ti["scan_grav"][0],
         plain_ms=ti["scan_grav"][1], bound=ti["scan_grav"][2:],
         shape={"model": "gravity", "B": 256, "T2": 14})
    note(fr.job(gcfg, True, "float32", 16), err=four["open_std_err"],
         ms=ti["open"][0], plain_ms=ti["open"][1], bound=ti["open"][2:],
         shape={"model": "gravity", "B": 16384, "H": 92, "sample": True})
    note(fr.job(ocfg, True, "float32", 4), err=four["act_open_rew_err"],
         ms=four["act_open_ms"], plain_ms=four["act_open_plain_ms"],
         bound=four["act_open_bound"],
         shape={"model": "avoidance + random open head", "B": 576, "H": 10,
                "sample": True})
    five = fifth_slice(card, dev, model, z_post)
    six = sixth_slice(card, dev, model)
    seven = seventh_slice(card, dev, model, z_post, five.pop("posteriors"))

    # one entry per kernel library: the TPU kernel it replaces, its
    # launches on the main paths (every run through the entry points, and
    # the throughput measurement of phase (5)), its largest error against
    # its plain version in this run, and its time at the shape named
    names = {"rollout.cu": ("rollout", "stove_tpu/ops/pallas_rollout.py:"),
             "scan.cu": ("scan_fused", "stove_tpu/ops/pallas_scan.py:214"),
             "spn.cu": ("spn_log_prob_fused",
                        "stove_tpu/ops/pallas_spn.py:204"),
             "likelihood.cu": ("likelihood_fused",
                               "stove_tpu/ops/pallas_likelihood.py:233")}
    packs = {"spn.cu": ("spn_pack", "stove_tpu/ops/pallas_spn.py:39"),
             "likelihood.cu": ("likelihood_pack",
                               "stove_tpu/ops/pallas_likelihood.py:176")}
    kernels = []
    for (src, defines) in jobs:
        key = lib_key((src, defines))
        f = LIBS.get(key, {})
        d = " ".join(defines)
        name, rep = names[src]
        if src == "rollout.cu":
            act_ = "-DSTOVE_ACT=1" in d
            name = "rollout_act" if act_ else "rollout_states"
            rep += "484" if act_ else "433"
        launches = MAIN_PATH.get(key, 0)
        check("ms" in f and "err" in f, f"library {key} measured")
        b_ms, by = f["bound"]
        kernels.append({
            "name": f"{name}[{d}]", "route": "cuda",
            "source": f"stove_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": launches, "max_abs_err": f["err"], "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "shape": f.get("shape"),
            "ptxas": f.get("ptxas"), "smem_bytes": f.get("smem_bytes"),
            **{k: v for k, v in f.items()
               if k not in ("err", "ms", "plain_ms", "bound", "shape",
                            "ptxas", "smem_bytes", "pack")}})
        if src in packs:
            # the library's packing kernel (`prepare`), once a call
            pk = f.get("pack", {})
            check({"err", "ms", "plain_ms", "bound"} <= set(pk),
                  f"packing kernel of {key} measured")
            b_ms, by = pk["bound"]
            kernels.append({
                "name": f"{packs[src][0]}[{d}]", "route": "cuda",
                "source": f"stove_tpu_torch/csrc/{src}",
                "replaces": packs[src][1],
                "launches": MAIN_PATH.get(key + " pack", 0),
                "max_abs_err": pk["err"], "ms": pk["ms"],
                "plain_ms": pk["plain_ms"], "bound_ms": b_ms,
                "bound_by": by, "library_ms": None,
                "rel_err": pk["rel_err"]})
    on_path = [k for k in kernels if k["launches"] > 0]
    phase("kernels", f"{len(kernels)} libraries, {len(on_path)} launched on "
          f"the main paths: " + ", ".join(
              f"{k['name']} {k['launches']}" for k in kernels))
    check(all(MAIN_PATH.get(lib_key(j), 0) > 0 for j in (
        fr.job(cfg, False, "float32", 4), fr.job(acfg, False, "float32", 4),
        fr.job(acfg, False, "bfloat16", 4), fr.job(gcfg, True, "float32", 4),
        fscan.job(cfg, "bfloat16"), fscan.job(acfg, "bfloat16"),
        fscan.job(gcfg, "bfloat16"), fr.job(cfg, False, "bfloat16", 16),
        fspn.job(sspecs.obj), fspn.job(sspecs.bg), flik.job(cfg, sspecs),
        fr.job(cfg, False, "dense_bf16", 4),
        fr.job(acfg, False, "dense_bf16", 4),
        fr.job(gcfg, True, "dense_bf16", 4)))
        and all(MAIN_PATH.get(lib_key(j) + " pack", 0) > 0 for j in (
            fspn.job(sspecs.obj), fspn.job(sspecs.bg),
            flik.job(cfg, sspecs))),
        "every path launched its libraries")
    print(json.dumps({"kernels": kernels, "train_step_ms": {
        k: tr[f"step_{k}"] for k in ("kernels", "plain")},
        "resume": tr["resume"], "avoidance_eval": act["eval"],
        "planning": act["plan"], "planning_bf16_leaves": five["plan_bf16"],
        "avoidance_resume": four["avoid_resume"],
        "gravity_eval": four["grav_eval"],
        "gravity_eval_sampled": four["grav_eval_sampled"],
        "gravity_resume": four["grav_resume"],
        "rollout_timing": five["timing"], "sixth_slice": six,
        "seventh_slice": seven,
        "throughput_ms": {"float32": times[B], "bfloat16": times["bf16"]}},
        default=str))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def plain_rollout(dyn_params, c, z0, horizon, sample=True, generator=None,
                  prepared=None, actions=None, dtype="float32"):
    """fused_rollout.rollout's signature on the plain version, on the card."""
    import torch
    from stove_tpu_torch.ops import fused_rollout as fr
    noise = None
    if sample:
        noise = torch.randn((z0.shape[0], horizon) + tuple(z0.shape[1:]),
                            generator=generator, dtype=z0.dtype).to(z0)
    return fr.rollout_states_reference(dyn_params, c, z0, horizon, noise,
                                       actions, dtype)


def compare_plain_eval(name: str, m: dict, ecfg, edev, launches: int) -> dict:
    """mode=eval again with the plain rollout in place of the kernel's
    dispatch; every metric of the mean path against the kernel run's `m`.
    The mean-path metrics are held to 1e-4 relative, except the 80-step
    mean-rollout speed ratio: by step 80 the two float32 rollouts have
    drifted apart (phase 2 shows it), so that mean of displacements is
    held to 1e-2.  The sampled long-horizon metrics use different noise
    streams by design and are not compared.  Returns the plain run's
    metrics."""
    import torch
    from stove_tpu_torch import main as entry
    from stove_tpu_torch.ops import fused_rollout as fr

    kernel_dispatch = fr.rollout
    fr.rollout = plain_rollout
    try:
        t = time.perf_counter()
        mp = entry.run_eval(ecfg, edev)
        torch.cuda.synchronize()
        plain_eval_s = time.perf_counter() - t
    finally:
        fr.rollout = kernel_dispatch
    check(fr.launch_kernel.launches == launches,
          "the plain-rollout eval launched no kernel")
    worst, worst_lh = 0.0, 0.0
    for k, v in m.items():
        if k.startswith("longhorizon_sampled"):
            continue
        a, b = v.double(), mp[k].double()
        rel = ((a - b).abs() / b.abs().clamp_min(1e-12)).max().item()
        if k == "longhorizon_speed_ratio":
            worst_lh = rel
        else:
            worst = max(worst, rel)
        print(f"  plain {k}: {mp[k].detach().cpu().numpy()} (rel diff "
              f"{rel:.2e})")
    phase(name, f"plain-rollout eval {plain_eval_s:.2f} s; kernel vs plain "
          f"metrics: worst relative difference {worst:.2e} (8-step rollout, "
          f"rewards, baselines, in-frame share), 80-step speed ratio "
          f"{worst_lh:.2e}")
    check(worst <= 1e-4, f"eval metrics kernel vs plain rel diff {worst}")
    check(worst_lh <= 1e-2, f"80-step speed ratio rel diff {worst_lh}")
    return mp


# ---------------------------------------------------------------------------
# every kernel library: what the run measured of it, and its launches on
# the main paths
# ---------------------------------------------------------------------------

LIBS: dict = {}               # " ".join(source, defines) -> measured fields
MAIN_PATH: dict = {}          # the same key -> launches on the main paths


def lib_key(job) -> str:
    return " ".join((job[0],) + tuple(job[1]))


def note(job, **fields) -> None:
    """Record measured fields (err, ms, plain_ms, bound, shape, ...) of
    the library `job` builds."""
    LIBS.setdefault(lib_key(job), {}).update(fields)


def library_counts() -> dict:
    """Every wrapper's launch counts by library; the SPN and likelihood
    libraries' packing kernels under the library's key + " pack"."""
    from stove_tpu_torch.ops import fused_likelihood as flik
    from stove_tpu_torch.ops import fused_rollout as fr
    from stove_tpu_torch.ops import fused_scan as fscan
    from stove_tpu_torch.ops import fused_spn as fspn
    out = {f"rollout.cu {k}": v for k, v in fr.launch_kernel.by_library.items()}
    out.update({f"scan.cu {k}": v
                for k, v in fscan.launch_kernel.by_library.items()})
    out.update({f"spn.cu {k}": v
                for k, v in fspn.launch_kernel.by_library.items()})
    out.update({f"likelihood.cu {k}": v
                for k, v in flik.launch_kernel.by_library.items()})
    out.update({f"spn.cu {k} pack": v
                for k, v in fspn.prepare.by_library.items()})
    out.update({f"likelihood.cu {k} pack": v
                for k, v in flik.prepare.by_library.items()})
    return out


def counted_since(snap: dict) -> dict:
    now = library_counts()
    return {k: v - snap.get(k, 0) for k, v in now.items()
            if v - snap.get(k, 0)}


def count_main_paths() -> None:
    """Add the launches of every run through the entry points (mode=eval,
    mode=train, mode=mcts, mode=generate, mode=viz, mode=profile) to
    MAIN_PATH, by library."""
    from stove_tpu_torch import main as entry
    from stove_tpu_torch.planning import runner
    from stove_tpu_torch.utils import profiling

    def counted(fn):
        def run(*a, **k):
            snap = library_counts()
            try:
                return fn(*a, **k)
            finally:
                for key, v in counted_since(snap).items():
                    MAIN_PATH[key] = MAIN_PATH.get(key, 0) + v
        return run

    entry.run_eval = counted(entry.run_eval)
    entry.run_train = counted(entry.run_train)
    entry.run_generate = counted(entry.run_generate)
    entry.run_viz = counted(entry.run_viz)
    runner.run_planning = counted(runner.run_planning)
    profiling.profile_train_steps = counted(profiling.profile_train_steps)


@contextlib.contextmanager
def float32_scan():
    """Within the block, the scan dispatch (`scan_impl=pallas`) launches the
    scan's float32 library where a run launches its bfloat16 one
    (`fused_scan.scan_kernel`'s dtype): the gradient checks (9) and (18)
    hold the kernel path to the float32 plain path at float32's noise."""
    from stove_tpu_torch.ops import fused_scan as fscan
    real = fscan.scan_kernel
    fscan.scan_kernel = functools.partial(real, dtype="float32")
    try:
        yield
    finally:
        fscan.scan_kernel = real


def frames_floor(grads, batch, plain_cfg, paths, g_plain, absolute, dev):
    """The plain path's own gradient noise: the largest change, over the
    leaves not held `absolute`ly and per a leaf's largest entry, of the
    plain path's gradient when the frames move by 1e-5 (the scan kernel's
    distance from its plain version, phases (8) and (17)).  A bilinear
    glimpse's gradient jumps where a sample point crosses a pixel centre,
    and a batch holds ~10^6 sample points, so a forward that moves by
    float32 rounding moves the gradient by this much."""
    import torch
    clean = batch["frames"]
    batch["frames"] = clean + 1e-5 * torch.randn(
        clean.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(5))
    g_moved = grads(plain_cfg)
    batch["frames"] = clean
    floor = 0.0
    for path, b, q in zip(paths, g_plain, g_moved):
        if b is not None and not absolute(path):
            floor = max(floor, (q - b).abs().max().item()
                        / (b.abs().max().item() or 1.0))
    return floor


# ---------------------------------------------------------------------------
# the training slice: SPN, likelihood and scan kernels, training, resume
# ---------------------------------------------------------------------------

F32_PEAK, HBM_RATE = 67e12, 3.35e12        # H100 SXM, f32 CUDA cores, HBM3
BF16_PEAK = 989e12                         # dense bf16 tensor cores


def bound(flops: float, nbytes: float, peak: float = F32_PEAK):
    """(ms, "operations" | "bytes"): the least time for the work, its
    operations at `peak` FLOP/s or its bytes at the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rollout_bound(flops: float, nbytes: float, dtype: str):
    """The rollout library's bound: its matmul operations at their type's
    peak -- bf16 on the tensor cores (both bf16 precisions), f32 on the
    CUDA cores (the float32 library's FMA) -- or its bytes."""
    return bound(flops, nbytes,
                 F32_PEAK if dtype == "float32" else BF16_PEAK)


def spn_flops(spec) -> float:
    """Operations one sample's SPN needs: 6 per leaf term (with 1/sd and
    -log sd - log(2 pi)/2 per leaf, which depend on the parameters only:
    sub, mul, then two multiply-adds, c - t*t and the weighted sum); per
    level and (r, p): 2(c-1) max, 2c sub+exp, then per sum node c(2c)
    multiply-adds and c more, log and add; root: 4 per term."""
    R, V, I, S, D = (spec.num_reps, spec.num_vars, spec.num_leaves,
                     spec.num_sums, spec.depth)
    ops, c = 6.0 * R * V * I, I
    for d in range(D - 1, -1, -1):
        ops += R * 2 ** d * (2 * (c - 1) + 4 * c + S * (2 * c * c + 2 * c + 2))
        c = S
    return ops + 4.0 * R * S


def spn_param_bytes(spec) -> float:
    """mu, sd, log sd (R, V, I), the mixture weights and the root."""
    R, V, I, S, D = (spec.num_reps, spec.num_vars, spec.num_leaves,
                     spec.num_sums, spec.depth)
    n, c = 3 * R * V * I + R * S, I
    for d in range(D - 1, -1, -1):
        n += R * 2 ** d * S * c * c
        c = S
    return 4.0 * n


def lik_bound(cfg, specs, n: int):
    """The likelihood kernel's bound on n frames: its operations, or its
    bytes (frames, boxes and the log-densities, both SPNs' parameters)."""
    V = cfg.img_size ** 2
    return bound(n * lik_flops(cfg, specs),
                 4.0 * n * (V + 4 * cfg.num_obj + 1)
                 + spn_param_bytes(specs.obj) + spn_param_bytes(specs.bg))


def pack_err(got, ref, leaf: int):
    """The packing kernel's buffer against `fused_spn.pack_reference`'s:
    (largest |got - ref|, largest |got - ref| / max(|ref|, 1)) over the
    float entries; both inf unless the variables' bits (every fourth leaf
    entry) are equal."""
    import torch
    bits = torch.equal(got[3:leaf:4].view(torch.int32),
                       ref[3:leaf:4].view(torch.int32))
    mask = torch.ones_like(ref, dtype=torch.bool)
    mask[3:leaf:4] = False
    diff = (got - ref).abs()[mask]
    rel = (diff / ref.abs()[mask].clamp_min(1.0)).max().item()
    if not bits:
        return float("inf"), float("inf")
    return diff.max().item(), rel


def pack_bound(specs):
    """The packing kernel's bound for the SPNs `specs`: it reads mu, raw
    std (R, V, I), the permutations (R, V) and the logits once and writes
    the packed buffer once; 9 operations a leaf (sd from the raw std, 1/sd,
    log sd) and 5 a weight (softmax: max, sub, exp, sum, divide)."""
    from stove_tpu_torch.ops import fused_spn as fspn
    flops = nbytes = 0.0
    for spec in specs:
        R, V, I = spec.num_reps, spec.num_vars, spec.num_leaves
        params = spn_param_bytes(spec) / 4.0 - 3 * R * V * I  # the weights
        flops += 9.0 * R * V * I + 5.0 * params
        nbytes += 4.0 * (2 * R * V * I + R * V + params
                         + fspn.layout(spec)["floats"])
    return bound(flops, nbytes)


def lik_flops(cfg, specs) -> float:
    """Operations per frame.  The box edges are separable: the background
    weights need O (H + W) edges (~12 ops each: sub, abs, sub, mul, divide,
    a sigmoid) and a mul and a max per pixel and object; each object's
    claim weights 2P edges per earlier object and a mul and a max per
    patch pixel; then per object P² bilinear samples (~20 ops), the object
    SPN O times and the background SPN once."""
    O, P, H = cfg.num_obj, cfg.patch_size, cfg.img_size
    pairs = sum(o for o in range(O))
    return (O * 2 * H * 12.0 + H * H * O * 2.0
            + pairs * (2 * P * 12.0 + P * P * 2.0) + O * P * P * 20.0
            + O * spn_flops(specs.obj) + spn_flops(specs.bg))


def profile_step(trainer, batch_size: int, top: int = 12):
    """torch.profiler over one STOVE step (`utils/profiling.trace`): device
    time by kernel name, read from the trace it writes, the device's busy
    time against the step's wall time."""
    import os
    import tempfile

    import torch
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.utils import profiling

    b = data_lib.sample_windows(trainer.train_ep, trainer.cfg,
                                trainer.data_gen, batch_size)
    trainer.train_step(b)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            t0 = time.perf_counter()
            trainer.train_step(b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows, _ = profiling.device_times(os.path.join(d, profiling.TRACE_FILE))
    busy = sum(ms for ms, _ in rows.values())
    top_rows = sorted(rows.items(), key=lambda kv: kv[1][0], reverse=True)
    out = [f"profile of one kernel-path STOVE step: wall {wall:.1f} ms, "
           f"device busy {busy:.1f} ms ({100 * busy / wall:.0f}%), "
           f"{len(rows)} kernel names"]
    for name, (ms, n) in top_rows[:top]:
        out.append(f"  {ms:8.3f} ms x{n:<4d} {name[:90]}")
    return out


def rel_err(got, ref, floor: float) -> float:
    """max |got - ref| / max(|ref|, floor) over the elements."""
    return ((got.double() - ref.double()).abs()
            / ref.double().abs().clamp_min(floor)).max().item()


def training_slice(card: str, dev, cfg, model) -> dict:
    import os
    import tempfile

    import torch
    from stove_tpu_torch import main as entry
    from stove_tpu_torch import tree
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.models import dynamics as dyn_lib
    from stove_tpu_torch.models import spn as spn_lib
    from stove_tpu_torch.models import stove as stove_lib
    from stove_tpu_torch.models import supair as sup_lib
    from stove_tpu_torch.ops import fused_likelihood as flik
    from stove_tpu_torch.ops import fused_rollout as fr
    from stove_tpu_torch.ops import fused_scan as fscan
    from stove_tpu_torch.ops import fused_spn as fspn
    from stove_tpu_torch.ops import glimpse
    from stove_tpu_torch.train import checkpoint as ckpt_lib
    from stove_tpu_torch.train.trainer import Trainer

    out = {}
    specs = model.specs.supair
    sparams = model.params["supair"]
    B, T = cfg.batch_size, cfg.window                          # 256, 8
    gen = torch.Generator().manual_seed(6)
    ep = data_lib.generate(cfg.with_overrides(seq_len=T), B, gen, dev)
    frames = data_lib.normalize_frames(ep.frames)               # (B, T, H, W)
    flat = frames.reshape(B * T, cfg.img_size, cfg.img_size).contiguous()
    with torch.no_grad():
        inf = model.infer(frames, None, generator=gen)
    boxes = torch.cat([inf.z[..., 0:2], inf.z[..., 2:4]], -1).reshape(
        B * T, cfg.num_obj, 4).contiguous()

    # ---- (6) spn: the kernel vs the plain version on the patches and
    # frames of one training step.  Each log-density is a sum of 10^2-10^3
    # leaf terms of size ~1, so float32 rounding scales with that sum: the
    # limit is |err| <= 1e-5 * max(|log p|, 100).  The packing kernel
    # (fused_spn.prepare) against its plain version (pack_reference): 1e-6
    # relative to max(|value|, 1), the variables' bits equal.
    with torch.no_grad():
        patches = glimpse.extract_glimpses(flat, boxes, cfg.patch_size)
        pw, bgv = flik.patch_weights(cfg, boxes)
        P2 = cfg.patch_size ** 2
        spn_in = {
            "obj": (specs.obj, sparams["obj_spn"],
                    patches.reshape(-1, P2).contiguous(),
                    pw.reshape(-1, P2).contiguous()),
            "bg": (specs.bg, sparams["bg_spn"],
                   flat.reshape(B * T, -1).contiguous(),
                   bgv.reshape(B * T, -1).contiguous())}
        spn_err = 0.0
        for name, (spec, prm, x, w) in spn_in.items():
            packed = fspn.prepare(spec, prm)
            pe, pr = pack_err(packed, fspn.pack_reference(spec, prm),
                              fspn.layout(spec)["leaf"])
            got = fspn.launch_kernel(spec, packed, x, w)
            ref = spn_lib.spn_log_prob(spec, prm, x, w)
            ref64 = spn_lib.spn_log_prob(
                spec, {k: v.double() for k, v in prm.items()}, x.double(),
                w.double())
            torch.cuda.synchronize()
            e32, e64 = rel_err(got, ref, 100.0), rel_err(got, ref64, 100.0)
            err = (got - ref).abs().max().item()
            spn_err = max(spn_err, err)
            phase("spn", f"{name} SPN x {tuple(x.shape)}: max |kernel - "
                  f"plain| {err:.3e} (rel {e32:.2e}), vs float64 plain rel "
                  f"{e64:.2e}, float32 plain vs float64 rel "
                  f"{rel_err(ref, ref64, 100.0):.2e}; log p in "
                  f"[{ref.min().item():.1f}, {ref.max().item():.1f}]; "
                  f"packing kernel vs plain {pe:.2e} (rel {pr:.2e})")
            check(e32 <= 1e-5 and e64 <= 1e-5, f"{name} SPN kernel error")
            check(pr <= 1e-6, f"{name} SPN packing kernel error")
            note(fspn.job(spec), err=err,
                 pack={"err": pe, "rel_err": pr})
    out["spn_err"] = spn_err

    # ---- (7) likelihood: the kernel vs the plain version on 2048 rendered
    # frames with their posterior boxes; limits as in (6), the packing of
    # both SPNs in one launch (fused_likelihood.prepare) against
    # pack_reference
    with torch.no_grad():
        packed = flik.prepare(cfg, specs, sparams)
        pes = [pack_err(p_, fspn.pack_reference(s_, sparams[k]),
                        fspn.layout(s_)["leaf"]) for p_, s_, k in
               zip(packed, (specs.obj, specs.bg), ("obj_spn", "bg_spn"))]
        pe, pr = max(e[0] for e in pes), max(e[1] for e in pes)
        got = flik.launch_kernel(cfg, specs, packed, flat, boxes)
        ref = flik.likelihood_reference(cfg, specs, sparams, flat, boxes)
        ref64 = flik.likelihood_reference(
            cfg, specs, tree.map_leaves(lambda v: v.double(), sparams),
            flat.double(), boxes.double())
        torch.cuda.synchronize()
        e32, e64 = rel_err(got, ref, 100.0), rel_err(got, ref64, 100.0)
        out["lik_err"] = (got - ref).abs().max().item()
        phase("likelihood", f"{B * T} frames: max |kernel - plain| "
              f"{out['lik_err']:.3e} (rel {e32:.2e}), vs float64 plain rel "
              f"{e64:.2e}; log p in [{ref.min().item():.1f}, "
              f"{ref.max().item():.1f}]; packing kernel vs plain {pe:.2e} "
              f"(rel {pr:.2e})")
        check(e32 <= 1e-5 and e64 <= 1e-5, "likelihood kernel error")
        check(pr <= 1e-6, "likelihood packing kernel error")
        note(flik.job(cfg, specs), err=out["lik_err"],
             pack={"err": pe, "rel_err": pr})

    # ---- (8) scan: the kernel vs the plain version at B=256, T2=6 on the
    # trained weights with pre-drawn eps, then at B=255 (the small tile's
    # last block ragged) and B=2113 (16 samples a block, its last block one
    # sample; the window's inputs repeated).  Two float32 evaluations that
    # sum in different orders drift apart as the map amplifies rounding step
    # by step (phase (2): 8e-5 after 8 rollout steps); the limit on z and
    # z_mean is 1e-4 against the plain version in float32 and in float64.
    # The random-weight modes (a nonzero output layer, B=63, ragged)
    # amplify faster at steps 5-6 than the trained map (~2.5x a step, the
    # by-step line): 2e-4 there.  kl (a sum of ~800 log densities) to 2e-5
    # relative.
    with torch.no_grad():
        mean, std = sup_lib.encode(sparams, cfg, flat)
        mean = mean.reshape(B, T, cfg.num_obj, 4)
        std = std.reshape(B, T, cfg.num_obj, 4)
        m1, s1 = stove_lib.align_slots(mean[:, 0, :, 2:4], mean[:, 1, :, 2:4],
                                       mean[:, 1], std[:, 1])
        scan_args = [inf.z[:, 1].contiguous(), m1[..., 2:4].contiguous(),
                     s1[..., 2:4].contiguous(), mean[:, 2:].contiguous(),
                     std[:, 2:].contiguous()]
        eps = torch.randn((B, T - 2, cfg.num_obj, cfg.full_state_dim),
                          generator=gen).to(dev)
        acts = torch.zeros((B, T - 2), dtype=torch.long, device=dev)
        worst = {}
        trained = model.params["dynamics"]
        for label, c2, dyn, nb, lim in (
                ("trained, velocity_obs_full_std", cfg, trained, B, 1e-4),
                ("trained, ragged", cfg, trained, B - 1, 1e-4),
                ("trained, 16 samples a block", cfg, trained, 2113, 1e-4),
                *[(f"random, {k}", cfg.with_overrides(**kw), None, 63, 2e-4)
                  for k, kw in SCAN_MODES.items()]):
            if dyn is None:
                dyn = dyn_lib.init_params(c2, torch.Generator().manual_seed(8),
                                          dev)
                dyn["out"][-1]["w"] = 0.05 * torch.randn(
                    dyn["out"][-1]["w"].shape,
                    generator=torch.Generator().manual_seed(9)).to(dev)
            args = [batch_rows(a, nb) for a in scan_args]
            e_, a_ = batch_rows(eps, nb), batch_rows(acts, nb)
            z, zm, kl, _ = fscan.launch_kernel(fscan.prepare_params(dyn, c2),
                                               c2, *args, e_)
            rz, rzm, rkl, _ = fscan.scan_reference(dyn, c2, *args, a_, e_)
            d64 = ckpt_lib.params_from_numpy(dyn, dev, torch.float64)
            qz, qzm, qkl, _ = fscan.scan_reference(
                d64, c2, *[a.double() for a in args], a_, e_.double())
            torch.cuda.synchronize()
            ez = max((z - rz).abs().max().item(), (zm - rzm).abs().max().item())
            ez64 = max((z.double() - qz).abs().max().item(),
                       (zm.double() - qzm).abs().max().item())
            own64 = max((rz.double() - qz).abs().max().item(),
                        (rzm.double() - qzm).abs().max().item())
            ekl = ((kl - rkl).abs() / rkl.abs().clamp_min(1.0)).max().item()
            by_step = (z - rz).abs().amax(dim=(0, 2, 3))
            phase("scan", f"{label}, B={nb} (tile {fscan.tile_for(nb)}): "
                  f"max |kernel - plain| z, z_mean "
                  f"{ez:.3e} (float64 plain: kernel {ez64:.3e}, float32 "
                  f"plain {own64:.3e}); kl rel {ekl:.2e} (kl mean "
                  f"{rkl.mean().item():.3f}); by step " + " ".join(
                      f"{e:.1e}" for e in by_step.tolist()))
            check(ez <= lim and ez64 <= lim, f"scan kernel z error ({label})")
            check(ekl <= 2e-5, f"scan kernel kl error ({label})")
            worst[label] = ez
            key = fscan.job(c2, "float32", fscan.tile_for(nb))
            note(key, err=max(ez, LIBS.get(lib_key(key), {}).get("err", 0.0)))
    out["scan_err"] = max(worst["trained, velocity_obs_full_std"],
                          worst["trained, ragged"])

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")

    def counts():
        return (fscan.launch_kernel.launches, flik.launch_kernel.launches,
                fspn.launch_kernel.launches, fr.launch_kernel.launches)

    def zero():
        for k in (fscan, flik, fspn, fr):
            k.launch_kernel.launches = 0

    # ---- (9) train from scratch at full width through the entry point:
    # 2 warm-up and 3 STOVE steps with the scan and likelihood kernels (and
    # one evaluation, which rolls out through the rollout kernel), then one
    # warm-up and one STOVE step with the SPN kernel and the plain
    # likelihood; every loss finite, every kernel launched
    common = ["preset=stove_billiards", "num_train=64", "num_test=32",
              "steps_per_epoch=1", f"run_dir={tmp}", fresh_data()]
    zero()
    t = time.perf_counter()
    cfg_a, _, dev_a = entry.build_config(
        common + ["scan_impl=pallas", "likelihood_impl=pallas",
                  "num_epochs=5", "supair_only_epochs=2", "eval_every=5",
                  "run_name=scratch_kernels"])
    tr_a, res_a = entry.run_train(cfg_a, dev_a)
    torch.cuda.synchronize()
    n_scan, n_lik, n_spn, n_roll = counts()
    phase("train", f"from scratch, scan+likelihood kernels: 5 epochs of 1 "
          f"step in {time.perf_counter() - t:.1f} s; launches scan {n_scan}, "
          f"likelihood {n_lik}, spn {n_spn}, rollout {n_roll}; last "
          f"loss {res_a['loss']:.2f} elbo {res_a['elbo']:.2f} mse_final "
          f"{res_a['mse_final']:.4f}")
    check(n_scan > 0 and n_lik > 0, "training launched scan and likelihood")
    rows = [json.loads(ln) for ln in open(
        os.path.join(tr_a.run_dir, "metrics.jsonl"))]
    losses = [r["loss"] for r in rows if r["kind"] == "train"]
    check(len(losses) == 5 and all(math.isfinite(x) for x in losses),
          f"finite losses {losses}")
    zero()
    cfg_b, _, dev_b = entry.build_config(
        common + ["spn_impl=pallas", "likelihood_impl=xla", "num_epochs=2",
                  "supair_only_epochs=1", "eval_every=100",
                  "run_name=scratch_spn"])
    _, res_b = entry.run_train(cfg_b, dev_b)
    torch.cuda.synchronize()
    n_spn_b = counts()[2]
    phase("train", f"spn kernel path: 1 warm-up + 1 STOVE step, spn "
          f"launches {n_spn_b}, last loss {res_b['loss']:.2f}")
    check(n_spn_b > 0 and math.isfinite(res_b["loss"]), "spn path ran")
    out["launches"] = {"scan": n_scan, "likelihood": n_lik, "spn": n_spn_b}

    # one batch, the same noise: kernel-path gradients vs plain-path ones,
    # the scan on its float32 library (float32_scan; the bf16 forward the
    # weights were trained by is held by phase (24)).  The backward is the
    # plain version's VJP at the kernel forward's inputs, which differ from
    # the plain forward's by ~1e-5 (phase 8), and the gradient of a
    # bilinear glimpse jumps where a sample point crosses a pixel centre,
    # so the few samples that cross between the two forwards change the
    # box gradients, and through them the dynamics', in steps: each leaf is
    # held to 1e-3 of its largest entry, raised to the plain path's own
    # floor (frames_floor) where that is higher, as phase (18) does (one
    # run saw 1.13x of 1e-3 at weights trained by the bf16 forward).  A
    # mixture logit's gradient is a mean over the B*T frames of
    # (responsibility - weight), in [-1, 1] whatever its size (saturated
    # mixtures give ~1e-8), so the sum and root logits are held to 1e-6 of
    # that scale.
    tr = tr_a
    batch = data_lib.sample_windows(tr.train_ep, cfg_a,
                                    torch.Generator(device=dev).manual_seed(3),
                                    cfg_a.batch_size)
    noise = stove_lib.draw_elbo_noise(cfg_a, B, T,
                                      torch.Generator().manual_seed(4), dev)
    leaves = tree.leaves(tr.params)

    def grads(c):
        loss = stove_lib.elbo(tr.params, c, tr.model.specs, batch["frames"],
                              None, None, noise).loss
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    plain_cfg = cfg_a.with_overrides(scan_impl="xla", likelihood_impl="xla")
    with float32_scan():
        g_k = grads(cfg_a)
    g_p = grads(plain_cfg)
    g_p2 = grads(plain_cfg)
    g_s = grads(plain_cfg.with_overrides(spn_impl="pallas"))
    paths = [p for p, _ in tree.paths(tr.params)]
    logits = lambda path: "logits" in str(path[-1])  # noqa: E731
    floor = frames_floor(grads, batch, plain_cfg, paths, g_p, logits, dev)
    lim_rel = max(1e-3, floor)
    rows_g = []
    for path, a, b, b2, s in zip(paths, g_k, g_p, g_p2, g_s):
        if b is None:
            check(a is None and s is None, f"gradient presence {path}")
            continue
        scale = 1.0 if logits(path) else b.abs().max().item() or 1.0
        lim = 1e-6 if logits(path) else lim_rel
        rows_g.append(((a - b).abs().max().item() / scale / lim,
                       (s - b).abs().max().item() / scale / lim,
                       (b2 - b).abs().max().item() / scale, scale,
                       tree.keystr(path)))
    rows_g.sort(reverse=True)
    for r in rows_g[:4]:
        phase("train", f"gradient {r[4]}: max |kernel - plain| / scale "
              f"{r[0]:.2e} of its limit (spn kernel {r[1]:.2e}; plain run "
              f"twice {r[2]:.2e} of scale); scale {r[3]:.3e}")
    worst_g = max(r[0] for r in rows_g)
    worst_s = max(r[1] for r in rows_g)
    worst_rel = max(r[0] * lim_rel for r in rows_g if "logits" not in r[4])
    phase("train", f"gradients on one batch, same noise, {len(rows_g)} "
          f"leaves: the plain path's own floor (frames moved by 1e-5) "
          f"{floor:.2e} of a leaf's largest entry, limit {lim_rel:.2e}; "
          f"worst share of the limit, scan+likelihood kernels "
          f"{worst_g:.2e}, spn kernel {worst_s:.2e}; largest |kernel - "
          f"plain| of a leaf other than the logits {worst_rel:.2e} of its "
          f"largest entry")
    out["grad_floor"] = floor
    check(worst_g <= 1.0 and worst_s <= 1.0, "kernel-path gradients")

    # ---- (10) resume the trained run through the kernels for one epoch of
    # 20 steps.  elbo: the committed run's last 40 logged steps
    # (metrics.jsonl) have mean 1222.5, so [1197, 1248] is +-2%.  kl: that
    # log has -6.26 to -5.70, but the JAX package itself, in float32 on the
    # restored weights and its own training corpus, gives about -9.1
    # (tests/test_torch_resume.py measures it), so kl is held to
    # [-10.5, -7.5] around the reference's own value; overshoot < 0.02.
    before = {p: os.path.getmtime(p) for p in
              [os.path.join(RUN, f) for f in os.listdir(RUN)]}
    zero()
    t = time.perf_counter()
    cfg_r, _, dev_r = entry.build_config(
        [f"restore={RUN}", "mode=train", "scan_impl=pallas",
         "likelihood_impl=pallas", "num_epochs=361", f"run_dir={tmp}",
         fresh_data()])
    tr_r, _ = entry.run_train(cfg_r, dev_r)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    steps = [{k: float(v) for k, v in m.items()} for m in tr_r.epoch_metrics]
    mean = {k: sum(s[k] for s in steps) / len(steps)
            for k in ("elbo", "kl", "overshoot", "log_lik")}
    n_scan_r, n_lik_r = counts()[:2]
    phase("resume", f"{RUN} step 7200 -> {tr_r.step} in {resume_s:.1f} s, "
          f"{len(steps)} steps: mean elbo {mean['elbo']:.2f} (min "
          f"{min(s['elbo'] for s in steps):.2f}, max "
          f"{max(s['elbo'] for s in steps):.2f}), log_lik "
          f"{mean['log_lik']:.2f}, kl {mean['kl']:.3f}, overshoot "
          f"{mean['overshoot']:.5f}; launches scan {n_scan_r}, likelihood "
          f"{n_lik_r}; wrote {tr_r.run_dir}; elbo by step "
          + " ".join(f"{s['elbo']:.1f}" for s in steps))
    check(len(steps) == 20, "20 resumed steps")
    check(1197.0 <= mean["elbo"] <= 1248.0, f"resume elbo {mean['elbo']}")
    check(-10.5 <= mean["kl"] <= -7.5, f"resume kl {mean['kl']}")
    check(max(s["overshoot"] for s in steps) < 0.02, "resume overshoot")
    check(n_scan_r > 0 and n_lik_r > 0, "resume launched the kernels")
    after = {p: os.path.getmtime(p) for p in
             [os.path.join(RUN, f) for f in os.listdir(RUN)]}
    check(after == before, f"nothing written under {RUN}")
    out["resume"] = mean

    # ---- (11) timing at the training shapes (B=256 windows of 8 frames)
    def step_ms(trainer, fn, n=5):
        b = data_lib.sample_windows(trainer.train_ep, trainer.cfg,
                                    trainer.data_gen, B)
        fn(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def fwd_ms(trainer, n=5):
        b = data_lib.sample_windows(trainer.train_ep, trainer.cfg,
                                    trainer.data_gen, B)
        nz = stove_lib.draw_elbo_noise(trainer.cfg, B, T, trainer.noise_gen,
                                       dev)
        with torch.no_grad():
            trainer.model.elbo(trainer.params, b["frames"], None, None, nz)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                trainer.model.elbo(trainer.params, b["frames"], None, None, nz)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    timing = {}
    trainers = {}
    for label, kw in (("kernels", ["scan_impl=pallas", "likelihood_impl=pallas"]),
                      ("plain", [])):
        c, _, d = entry.build_config(common + kw + ["nolog=true",
                                                    fresh_data()])
        trainers[label] = Trainer(c, device=d)
    for label in ("plain", "kernels", "kernels", "plain"):
        trn = trainers[label]
        timing.setdefault(label, []).append(
            (step_ms(trn, trn.train_step), step_ms(trn, trn.supair_step),
             fwd_ms(trn)))
    # where the time of one kernel-path STOVE step goes, by CUDA kernel
    prof_lines = profile_step(trainers["kernels"], B)
    for ln in prof_lines:
        phase("timing", ln)
    for label, runs in timing.items():
        st = min(r[0] for r in runs)
        wu = min(r[1] for r in runs)
        fw = min(r[2] for r in runs)
        phase("timing", f"{label} path: STOVE step {st:.1f} ms, warm-up step "
              f"{wu:.1f} ms, ELBO forward alone {fw:.1f} ms (so backward + "
              f"update {st - fw:.1f} ms, {100 * (st - fw) / st:.0f}% of the "
              f"step); runs {[tuple(round(x, 1) for x in r) for r in runs]} "
              f"on {card}")
        out[f"step_{label}"] = (st, wu, fw)

    # each kernel alone at the training shapes vs its plain version (the
    # scan's float32 library; its bf16 one in phase (26)), and the scan's
    # weight packing, which `scan_kernel` does once a call
    with torch.no_grad():
        packed = fscan.prepare_params(model.params["dynamics"], cfg)
        for dt in fr.DTYPES:
            out[f"pack_ms_{dt}"] = time_cuda(lambda: fscan.prepare_params(
                model.params["dynamics"], cfg, dt), iters=10, warmup=2)
        (so, po, xo, wo), (sb, pb, xb, wb) = spn_in["obj"], spn_in["bg"]
        # the packing kernels (`prepare`, once a call) vs pack_reference
        pack = {"likelihood": (
            lambda: flik.prepare(cfg, specs, sparams),
            lambda: (fspn.pack_reference(so, po),
                     fspn.pack_reference(sb, pb)), (so, sb))}
        for name, spec, prm in (("obj", so, po), ("bg", sb, pb)):
            pack[name] = (lambda spec=spec, prm=prm: fspn.prepare(spec, prm),
                          lambda spec=spec, prm=prm: fspn.pack_reference(
                              spec, prm), (spec,))
        for k, (k_fn, p_fn, ss) in pack.items():
            pack[k] = (time_cuda(k_fn, iters=10, warmup=2),
                       time_cuda(p_fn, iters=10, warmup=2), pack_bound(ss))
        out["lik_pack_ms"] = pack["likelihood"][0]
        prep_o, prep_b = fspn.prepare(so, po), fspn.prepare(sb, pb)
        prep_l = flik.prepare(cfg, specs, sparams)
        kern = {
            "spn": (lambda: (fspn.launch_kernel(so, prep_o, xo, wo),
                             fspn.launch_kernel(sb, prep_b, xb, wb)),
                    lambda: (spn_lib.spn_log_prob(so, po, xo, wo),
                             spn_lib.spn_log_prob(sb, pb, xb, wb))),
            "likelihood": (lambda: flik.launch_kernel(cfg, specs, prep_l,
                                                      flat, boxes),
                           lambda: flik.likelihood_reference(
                               cfg, specs, sparams, flat, boxes)),
            "scan": (lambda: fscan.launch_kernel(packed, cfg, *scan_args,
                                                 eps),
                lambda: fscan.scan_reference(model.params["dynamics"], cfg,
                                             *scan_args, acts, eps)),
        }
        for name, (k_fn, p_fn) in kern.items():
            out[f"{name}_ms"] = time_cuda(k_fn, iters=20, warmup=2)
            out[f"{name}_plain_ms"] = time_cuda(p_fn, iters=5, warmup=1)
    macs = macs_per_frame(cfg) * B * (T - 2)
    scan_bytes = 4.0 * (sum(a.numel() for a in scan_args) + eps.numel()
                        + 2 * eps.numel() + B) + packed.numel()
    out["scan_bound"] = bound(2.0 * macs, scan_bytes)
    n_obj, n_bg = xo.shape[0], xb.shape[0]
    out["spn_bound"] = bound(
        n_obj * spn_flops(so) + n_bg * spn_flops(sb),
        4.0 * (2 * xo.numel() + 2 * xb.numel() + n_obj + n_bg)
        + spn_param_bytes(so) + spn_param_bytes(sb))
    out["lik_bound"] = lik_bound(cfg, specs, flat.shape[0])
    for name, key in (("spn", "spn_bound"), ("likelihood", "lik_bound"),
                      ("scan", "scan_bound")):
        ms, by = out[key]
        phase("timing", f"{name} kernel {out[name + '_ms']:.3f} ms, plain "
              f"{out[name + '_plain_ms']:.3f} ms, bound {ms:.4f} ms "
              f"({by}) on {card}")
    phase("timing", f"scan weight packing (fused_scan.prepare_params, once "
          f"a scan_kernel call): float32 {out['pack_ms_float32']:.3f} ms, "
          f"bfloat16 {out['pack_ms_bfloat16']:.3f} ms on {card}")
    for (label, job_), key in (
            (("likelihood (both SPNs, one launch)", flik.job(cfg, specs)),
             "likelihood"), (("object SPN", fspn.job(so)), "obj"),
            (("background SPN", fspn.job(sb)), "bg")):
        ms, plain_ms, (b_ms, by) = pack[key]
        phase("timing", f"{label} packing kernel (`prepare`, once a call) "
              f"{ms:.4f} ms, plain (pack_reference) {plain_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({by}) on {card}")
        LIBS[lib_key(job_)]["pack"].update(ms=ms, plain_ms=plain_ms,
                                           bound=(b_ms, by))
    note(flik.job(cfg, specs), ms=out["likelihood_ms"],
         plain_ms=out["likelihood_plain_ms"], bound=out["lik_bound"],
         shape={"frames": flat.shape[0], "objects": cfg.num_obj})
    for spec in (so, sb):
        note(fspn.job(spec), ms=out["spn_ms"],
             plain_ms=out["spn_plain_ms"], bound=out["spn_bound"],
             shape={"obj": list(xo.shape), "bg": list(xb.shape),
                    "timed": "obj and bg together"})
    return out


# ---------------------------------------------------------------------------
# the avoidance slice: the action-conditioned rollout kernel, eval, planning
# ---------------------------------------------------------------------------

def avoidance_slice(card: str, dev) -> dict:
    import torch
    from stove_tpu_torch import main as entry
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.models.bundle import StoveModel
    from stove_tpu_torch.ops import fused_rollout as fr
    from stove_tpu_torch.planning import runner
    from stove_tpu_torch.planning import simulators as sims
    from stove_tpu_torch.train import checkpoint as ckpt_lib

    cfg = ckpt_lib.load_config(AVOID)
    model = StoveModel.from_run(AVOID, device=dev)
    dyn, prep = model.params["dynamics"], model.prepared
    dyn64 = ckpt_lib.params_from_numpy(dyn, dev, torch.float64)
    A = cfg.num_actions
    # the planning run of phase (15): every round steps the E·K·A children
    # of its frontiers (H=1) and values each with one leaf rollout (H =
    # mcts_horizon); fewer rows only once some episodes' searches are done
    pcfg, _, pdev = entry.build_config(
        [f"restore={AVOID}", "mode=mcts", "mcts_episodes=16",
         "mcts_episode_len=40"])
    plan_B = pcfg.mcts_episodes * pcfg.mcts_frontier * A
    plan_shapes = ((plan_B * max(1, pcfg.mcts_eval_samples),
                    pcfg.mcts_horizon), (plan_B, 1))

    # ---- (12) mean rollout with actions and the reward head, z0 from the
    # posterior of rendered avoidance frames (with their random actions):
    # the checkpoint's own planner (10 episodes: B=360), the eval's batch
    # (B=100, H=8), then the planning run's shapes on further frames, and
    # after (14) and (15) any other mean shape that they launched
    gen = torch.Generator().manual_seed(12)
    wcfg = cfg.with_overrides(seq_len=cfg.window)

    def posterior(n):
        ep = data_lib.generate(wcfg, n, gen, dev)
        with torch.no_grad():
            inf = model.infer(data_lib.normalize_frames(ep.frames),
                              ep.actions, generator=gen)
        return inf.z_mean[:, -1].contiguous()                 # (n, O, D)

    z_post = posterior(360)
    n_rows = max(plan_shapes)[0]
    if n_rows > 360:
        z_post = torch.cat([z_post, posterior(n_rows - 360)])
    check(bool(torch.isfinite(z_post).all()), "avoidance posterior finite")
    agen = torch.Generator(device=dev).manual_seed(13)
    pgen = torch.Generator(device=dev).manual_seed(17)
    held, errs = set(), [0.0, 0.0]

    dyn_cpu = ckpt_lib.params_from_numpy(dyn, "cpu", torch.float32)

    def hold(B, H, name="act-mean", issue_shape=False):
        """Kernel vs plain mean rollout at (B, H), on the first B posterior
        states and random actions.  At every shape: step 1's states within
        1e-4 of the float32 and the float64 plain versions (the kernel's own
        rounding there is ~1e-5: a fault shows far above it), and the
        rewards within 1e-4 of both over steps 1-8 (over all steps printed
        beside the float32 plain version's distance from float64); over a
        long horizon (H > 20) phase (2)'s criterion too: the kernel's
        distance from float64 over all steps at most twice the float32 plain
        version's.  At the shapes named in the docstring (`issue_shape`),
        the states over steps 1-8 within 1e-4 of both plain versions as
        well.  Elsewhere that 8-step distance is printed beside the float32
        plain version's own, on the card and on the CPU: the trained map
        amplifies float32 rounding ~1.4x a step, so the largest of ~1e5
        entries reaches 1e-4 from float64 in any float32 evaluation."""
        held.add((B, H))
        z0 = z_post[torch.arange(B, device=dev) % z_post.shape[0]]
        acts = torch.randint(0, A, (B, H), device=dev,
                             generator=agen if B <= 360 else pgen)
        got, rew = fr.rollout(dyn, cfg, z0, H, False, None, prep, acts)
        ref, rref = fr.rollout_states_reference(dyn, cfg, z0, H, None, acts)
        ref64, rref64 = fr.rollout_states_reference(dyn64, cfg, z0.double(),
                                                    H, None, acts)
        cpu, _ = fr.rollout_states_reference(dyn_cpu, cfg, z0.cpu(), H, None,
                                             acts.cpu())
        torch.cuda.synchronize()
        n = min(H, 8)
        dist = lambda x, y, k: (x[:, :k].double()  # noqa: E731
                                - y[:, :k].double()).abs().max().item()
        s32, s64 = dist(got, ref, 1), dist(got, ref64, 1)
        e32, e64 = dist(got, ref, n), dist(got, ref64, n)
        p64, c64 = dist(ref, ref64, n), dist(cpu, ref64.cpu(), n)
        r32, r64 = dist(rew, rref, n), dist(rew, rref64, n)
        rk_all, rp_all = dist(rew, rref64, H), dist(rref, rref64, H)
        k_all, p_all = dist(got, ref64, H), dist(ref, ref64, H)
        errs[0] = max(errs[0], e32 if issue_shape else s32)
        errs[1] = max(errs[1], r32)
        phase(name, f"B={B} H={H}: states max |kernel - plain| at step 1 "
              f"{s32:.3e} (float64 {s64:.3e}), over steps 1-{n} {e32:.3e} "
              f"(float64 {e64:.3e}" + (f"; limit 1e-4, margin "
                                       f"{1e-4 / max(e32, e64):.2f}x"
                                       if issue_shape else "")
              + f"); float32 plain from float64 over steps 1-{n}: card "
              f"{p64:.3e}, CPU {c64:.3e}; over all {H} steps from float64: "
              f"kernel {k_all:.3e}, float32 plain {p_all:.3e}; rewards over "
              f"steps 1-{n} {r32:.3e} (float64 {r64:.3e}; over all {H} steps "
              f"from float64: kernel {rk_all:.3e}, float32 plain "
              f"{rp_all:.3e}), in "
              f"[{rref.min().item():.3f}, {rref.max().item():.3f}]; states "
              "by step " + " ".join(
                  f"{e:.1e}" for e in (got[:, :n] - ref[:, :n]).abs().amax(
                      dim=(0, 2, 3)).tolist()))
        check(s32 <= 1e-4 and s64 <= 1e-4,
              f"action rollout step-1 states error {s32} / {s64} at B={B} "
              f"H={H}")
        check(r32 <= 1e-4 and r64 <= 1e-4,
              f"action rollout rewards error {r32} / {r64} at B={B} H={H}")
        if issue_shape:
            check(e32 <= 1e-4 and e64 <= 1e-4,
                  f"action rollout states error {e32} / {e64} at B={B} H={H}")
        if H > 20:
            check(k_all <= 2 * p_all,
                  f"action rollout's distance from float64 {k_all} > 2x the "
                  f"float32 plain version's {p_all} at B={B} H={H}")

    for B, H in ((360, 10), (360, 1), (100, 8)):
        hold(B, H, issue_shape=True)
    for B, H in plan_shapes:
        if (B, H) not in held:
            hold(B, H)

    real_launch = fr.launch_kernel

    def hold_launched(shapes, name):
        """Hold every mean shape a path launched that (12) did not; the
        sampled ones are held in distribution by (13)."""
        phase(name, "rollout launches by (B, H, sampled, open head): "
              + ", ".join(f"{k}: {v}" for k, v in sorted(shapes.items())))
        for B, H, smp, _ in sorted(shapes):
            if not smp and (B, H) not in held:
                hold(B, H, name)

    # ---- (13) sampled, in distribution: one start, one action sequence
    Bd, Hd = 8192, 92
    z_one = z_post[:1].expand(Bd, -1, -1).contiguous()
    acts = torch.randint(0, A, (1, Hd), generator=agen,
                         device=dev).expand(Bd, -1).contiguous()
    got, _ = fr.rollout(dyn, cfg, z_one, Hd, True,
                        torch.Generator().manual_seed(14), prep, acts)
    noise = torch.randn((Bd, Hd) + tuple(z_one.shape[1:]), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(15))
    ref, _ = fr.rollout_states_reference(dyn, cfg, z_one, Hd, noise, acts)
    disp = lambda x: x[:, -1, :, 2:4].std(dim=0).mean().item()  # noqa: E731
    ratio = disp(got) / max(disp(ref), 1e-12)
    phase("act-sampled", f"H={Hd} B={Bd} position dispersion kernel/plain "
          f"= {ratio:.4f} ({disp(got):.4f} / {disp(ref):.4f})")
    check(0.9 <= ratio <= 1.1, f"action rollout dispersion ratio {ratio}")

    # ---- (14) mode=eval of the avoidance model through the entry point
    ecfg, _, edev = entry.build_config([f"restore={AVOID}", "mode=eval",
                                        fresh_data()])
    torch.backends.cudnn.allow_tf32 = True
    eval_shapes = {}
    real_launch.launches = 0
    t = time.perf_counter()
    with recording_rollouts(eval_shapes):
        m = entry.run_eval(ecfg, edev)
        torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    eval_launches = real_launch.launches
    for k, v in m.items():
        print(f"  {k}: {v.detach().cpu().numpy()}")
    phase("avoid-eval", f"mode=eval of {AVOID} on the card {eval_s:.2f} s; "
          f"rollout kernel launches {eval_launches}")
    check(eval_launches > 0, "avoidance eval launched the rollout kernel")
    check(not (torch.backends.cudnn.allow_tf32
               or torch.backends.cuda.matmul.allow_tf32),
          "the entry point runs with TF32 off")
    mse, lin = m["mse_final"].item(), m["linear_mse_final"].item()
    check(math.isfinite(mse) and mse < lin,
          f"mse_final {mse} finite and below linear baseline {lin}")
    compare_plain_eval("avoid-eval", m, ecfg, edev, eval_launches)
    for k, (lo, hi) in AVOID_BAND.items():
        v = m[k].item()
        phase("avoid-eval", f"{k} {v:.6g} in [{lo}, {hi}] (the JAX "
              f"package's range on this corpus, widened)")
        check(lo <= v <= hi, f"{k} {v} outside [{lo}, {hi}]")
    hold_launched(eval_shapes, "avoid-eval")

    # ---- (15) planning from pixels: model vs oracle vs random, with the
    # shape of every rollout launch recorded
    rounds, shapes = [0], {}
    real_round = sims.LearnedSimulator._round

    def counted(self, *a, **k):
        rounds[0] += 1
        return real_round(self, *a, **k)

    sims.LearnedSimulator._round = counted
    real_launch.launches = 0
    t = time.perf_counter()
    try:
        with recording_rollouts(shapes):
            res = runner.run_planning(pcfg, device=pdev)
            torch.cuda.synchronize()
    finally:
        sims.LearnedSimulator._round = real_round
    plan_s = time.perf_counter() - t
    plan_launches = real_launch.launches
    sc = {k: torch.tensor(v, dtype=torch.float64)
          for k, v in res["episode_scores"].items()}
    gain = sc["model"] - sc["random"]
    gain_sem = (gain.std(unbiased=False) / len(gain) ** 0.5).item()
    share = ((sc["model"].mean() - sc["random"].mean())
             / (sc["oracle"].mean() - sc["random"].mean())).item()
    plan = {"model": res["model_mean_reward"],
            "oracle": res["oracle_mean_reward"],
            "random": res["random_mean_reward"],
            "model_minus_random": gain.mean().item(),
            "model_minus_random_sem": gain_sem,
            "model_minus_oracle": res["model_oracle_gap_mean"],
            "model_minus_oracle_sem": res["model_oracle_gap_sem"],
            "share_closed": share, "seconds": plan_s, "rounds": rounds[0],
            "launches": plan_launches}
    phase("plan", f"{len(gain)} episodes x {pcfg.mcts_episode_len} steps in "
          f"{plan_s:.1f} s: mean reward oracle {plan['oracle']:.3f} > model "
          f"{plan['model']:.3f} > random {plan['random']:.3f}; model - random "
          f"{gain.mean().item():.3f} +- {gain_sem:.3f} (paired SEM); model - "
          f"oracle {plan['model_minus_oracle']:.3f} +- "
          f"{plan['model_minus_oracle_sem']:.3f}; the model closes "
          f"{100 * share:.1f}% of the oracle - random gap; {rounds[0]} "
          f"model rounds, {plan_launches} rollout launches "
          f"({plan_launches / max(rounds[0], 1):.2f} per round) on {card}")
    check(plan["oracle"] > plan["model"] > plan["random"],
          f"planning order oracle > model > random: {plan}")
    check(gain.mean().item() > 2 * gain_sem,
          f"model gain over random {gain.mean().item()} <= 2 SEM {gain_sem}")
    check(plan_launches == 2 * rounds[0] and rounds[0] > 0,
          "two rollout launches per planning round")
    hold_launched(shapes, "plan")

    # ---- (16) timing: the planning run's leaf and step shapes, the
    # checkpoint's own leaf (10 episodes) and the large sampled shape
    macs = macs_per_frame(cfg)
    times = {}
    leaf, step = plan_shapes
    for B, H, smp in (leaf + (False,), step + (False,), (360, 10, False),
                      (16384, 92, True)):
        if (B, H) in times:
            continue
        z0 = z_post[torch.arange(B, device=dev) % z_post.shape[0]]
        acts = torch.randint(0, A, (B, H), generator=agen, device=dev)
        g16 = torch.Generator().manual_seed(16)
        k_ms = time_cuda(lambda: fr.rollout(dyn, cfg, z0, H, smp, g16, prep,
                                            acts),
                         iters=50 if B < 1000 else 10, warmup=2)
        noise = torch.randn((B, H) + tuple(z0.shape[1:]), device=dev) \
            if smp else None
        p_ms = time_cuda(lambda: fr.rollout_states_reference(
            dyn, cfg, z0, H, noise, acts), iters=5 if B < 1000 else 2)
        flops = 2.0 * macs * B * H
        nbytes = 4.0 * (z0.numel() * (1 + H) + B * H * 2) + prep.numel()
        b_ms, by = rollout_bound(flops, nbytes, "float32")
        times[(B, H)] = (k_ms, p_ms, b_ms, by)
        phase("act-timing", f"B={B} H={H} {'sampled' if smp else 'mean'}: "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} "
              f"ms ({by}; {macs} MACs/frame), kernel at {100 * b_ms / k_ms:.1f}"
              f"% of the bound, {flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s, "
              f"{-(-B // fr.tile_for(B))} blocks on {card}")
    k_ms, p_ms, b_ms, by = times[leaf]
    entry_ = {
        "name": "rollout_act", "route": "cuda",
        "source": "stove_tpu_torch/csrc/rollout.cu",
        "replaces": "stove_tpu/ops/pallas_rollout.py:484",
        "launches": eval_launches + plan_launches,
        "max_abs_err": errs[0], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
        "shape": {"B": leaf[0], "H": leaf[1], "sample": False},
        "launches_eval": eval_launches, "launches_plan": plan_launches,
        "launches_by_shape": {
            f"{path} B={b} H={h}{' sampled' if smp else ''}": v
            for path, d in (("eval", eval_shapes), ("plan", shapes))
            for (b, h, smp, _), v in sorted(d.items())},
        "max_abs_err_rewards": errs[1],
        "step_ms": times[step][0], "step_plain_ms": times[step][1],
        "step_bound_ms": times[step][2],
        "ms_b360_h10": times[(360, 10)][0],
        "bound_ms_b360_h10": times[(360, 10)][2],
        "ms_b16384_h92_sampled": times[(16384, 92)][0],
        "plain_ms_b16384_h92_sampled": times[(16384, 92)][1],
        "bound_ms_b16384_h92": times[(16384, 92)][2]}
    return {"entry": entry_, "plan": plan,
            "eval": {k: m[k].item() for k in AVOID_BAND}}


# ---------------------------------------------------------------------------
# the fourth slice: avoidance training through the scan kernel with actions
# and the reward head; the gravity model through the rollout kernel's
# open-loop std head
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording_rollouts(shapes):
    """Count the rollout launches by (B, H, sampled, open-loop head) -- and
    precision, where it is bf16 -- while the block runs.  The wrapper stands
    in for fused_rollout.launch_kernel; the launch counter that
    launch_kernel increments is the wrapper's while it stands, and is
    handed back after (its counts by library stay launch_kernel's)."""
    from stove_tpu_torch.ops import fused_rollout as fr
    real = fr.launch_kernel

    def recorded(prepared, c, z0, horizon, sample, seed, actions=None,
                 open_head=False, dtype="float32"):
        key = (z0.shape[0], horizon, bool(sample), bool(open_head))
        if dtype != "float32":
            key += (dtype,)
        shapes[key] = shapes.get(key, 0) + 1
        return real(prepared, c, z0, horizon, sample, seed, actions,
                    open_head, dtype)
    recorded.launches = real.launches
    recorded.by_library = real.by_library
    fr.launch_kernel = recorded
    try:
        yield
    finally:
        fr.launch_kernel = real
        real.launches = recorded.launches


def scan_inputs(model, cfg, B: int, gen, dev):
    """The scan kernel's inputs on B rendered windows of the model's task,
    as `stove.infer` hands them over: (z1, carry means, carry stds, encoder
    box means, stds), the actions a_{t-1} (B, T2) and pre-drawn eps."""
    import torch
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.models import stove as stove_lib
    from stove_tpu_torch.models import supair as sup_lib
    T, O = cfg.window, cfg.num_obj
    ep = data_lib.generate(cfg.with_overrides(seq_len=T), B, gen, dev)
    frames = data_lib.normalize_frames(ep.frames)
    with torch.no_grad():
        inf = model.infer(frames, ep.actions if cfg.action_conditioned
                          else None, generator=gen)
        mean, std = sup_lib.encode(model.params["supair"], cfg,
                                   frames.reshape(B * T, cfg.img_size,
                                                  cfg.img_size))
        mean, std = mean.reshape(B, T, O, 4), std.reshape(B, T, O, 4)
        m1, s1 = stove_lib.align_slots(mean[:, 0, :, 2:4], mean[:, 1, :, 2:4],
                                       mean[:, 1], std[:, 1])
    args = [inf.z[:, 1].contiguous(), m1[..., 2:4].contiguous(),
            s1[..., 2:4].contiguous(), mean[:, 2:].contiguous(),
            std[:, 2:].contiguous()]
    acts = ep.actions[:, 1:T - 1].contiguous()
    eps = torch.randn((B, T - 2, O, cfg.full_state_dim),
                      generator=gen).to(dev)
    return args, acts, eps


def hold_scan(name, dyn, cfg, args, acts, eps, lim=1e-4):
    """The scan kernel against the plain version in float32 and float64 on
    the same inputs: z and z_mean within `lim` of both over every step,
    kl within 2e-5 relative (phase (8)'s limits), rewards within 1e-4 of
    both.  Returns (max z error vs float32, max reward error, the
    kernel's rewards)."""
    import torch
    from stove_tpu_torch.ops import fused_rollout as fr
    from stove_tpu_torch.ops import fused_scan as fscan
    from stove_tpu_torch.train import checkpoint as ckpt_lib
    dev = eps.device
    z, zm, kl, rew = fscan.launch_kernel(fscan.prepare_params(dyn, cfg), cfg,
                                         *args, eps, acts)
    rz, rzm, rkl, rrew = fscan.scan_reference(dyn, cfg, *args, acts, eps)
    d64 = ckpt_lib.params_from_numpy(dyn, dev, torch.float64)
    qz, qzm, qkl, qrew = fscan.scan_reference(
        d64, cfg, *[a.double() for a in args], acts, eps.double())
    torch.cuda.synchronize()
    dist = lambda a, b: (a.double() - b.double()).abs().max().item()  # noqa
    ez = max(dist(z, rz), dist(zm, rzm))
    ez64 = max(dist(z, qz), dist(zm, qzm))
    own64 = max(dist(rz, qz), dist(rzm, qzm))
    ekl = ((kl - rkl).abs() / rkl.abs().clamp_min(1.0)).max().item()
    er, er64 = dist(rew, rrew), dist(rew, qrew)
    phase(name, f"B={z.shape[0]} T2={z.shape[1]}: max |kernel - plain| z, "
          f"z_mean {ez:.3e} (float64 plain: kernel {ez64:.3e}, float32 plain "
          f"{own64:.3e}); kl rel {ekl:.2e} (kl mean {rkl.mean().item():.3f}); "
          f"rewards {er:.3e} (float64 {er64:.3e}) in [{rrew.min().item():.4f}"
          f", {rrew.max().item():.4f}]; z by step " + " ".join(
              f"{e:.1e}" for e in (z - rz).abs().amax(dim=(0, 2, 3)).tolist()))
    check(ez <= lim and ez64 <= lim, f"scan kernel z error {ez} / {ez64}")
    check(ekl <= 2e-5, f"scan kernel kl error {ekl}")
    check(er <= 1e-4 and er64 <= 1e-4, f"scan kernel rewards error {er}")
    return ez, er, rew


def hold_mean_rollout(name, dyn, cfg, z_post, prepared):
    """Phase (2): the mean kernel rollout from posterior states at (256, 8),
    (100, 8) and (32, 80).  Steps 1-8 are held to 1e-4, against the plain
    version in float32 (cuBLAS) and evaluated in float64 (the kernel's own
    error).  The latent rows reach |15| and the trained map amplifies
    float32 rounding ~1.4x a step, so two float32 evaluations summing in
    different orders drift apart.  Over a whole longer horizon the kernel's
    distance from the float64 version is held to at most twice the float32
    plain version's own distance from it.  Returns the largest 8-step error
    against float32."""
    import torch
    from stove_tpu_torch.ops import fused_rollout as fr
    from stove_tpu_torch.train import checkpoint as ckpt_lib
    dyn64 = ckpt_lib.params_from_numpy(dyn, z_post.device, torch.float64)
    max_err = 0.0
    for B, H in ((256, 8), (100, 8), (32, 80)):
        z0 = z_post[:B].contiguous()
        got = fr.rollout_states(dyn, cfg, z0, H, sample=False,
                                prepared=prepared)
        ref, _ = fr.rollout_states_reference(dyn, cfg, z0, H)
        ref64, _ = fr.rollout_states_reference(dyn64, cfg, z0.double(), H)
        torch.cuda.synchronize()
        err8 = (got[:, :8] - ref[:, :8]).abs().max().item()
        own8 = (got[:, :8].double() - ref64[:, :8]).abs().max().item()
        max_err = max(max_err, err8)
        per_step = (got[:, :8] - ref[:, :8]).abs().amax(dim=(0, 2, 3))
        phase(name, f"B={B} H={H}: max |kernel - plain| over steps 1-8: "
              f"{err8:.3e} vs float32 plain, {own8:.3e} vs float64 plain; "
              f"by step vs float32: "
              + " ".join(f"{e:.1e}" for e in per_step.tolist()))
        check(err8 <= 1e-4 and own8 <= 1e-4,
              f"{name} mean rollout error {err8} / {own8} > 1e-4 at B={B}")
        if H > 8:
            k64 = (got.double() - ref64).abs().amax(dim=(0, 2, 3))
            p64 = (ref.double() - ref64).abs().amax(dim=(0, 2, 3))
            k_all, p_all = k64.max().item(), p64.max().item()
            phase(name, f"B={B} H={H}: max distance from float64 plain "
                  f"over all {H} steps: kernel {k_all:.3e}, float32 plain "
                  f"{p_all:.3e} (ratio {k_all / max(p_all, 1e-30):.3f}); "
                  "by step 10, 20, ...: kernel " + " ".join(
                      f"{e:.1e}" for e in k64[9::10].tolist())
                  + "; float32 plain " + " ".join(
                      f"{e:.1e}" for e in p64[9::10].tolist()))
            check(k_all <= 2 * p_all,
                  f"{name} kernel's {H}-step distance from float64 {k_all} "
                  f"> 2x the float32 plain version's {p_all}")
    return max_err


def eps_moments(name, eps, what):
    """Recovered normals: |mean| and |std - 1| < 0.01, share beyond 5 sigma
    < 1e-5 (phase (3)'s limits)."""
    m, s = eps.mean().item(), eps.std().item()
    tail = (eps.abs() > 5).double().mean().item()
    phase(name, f"{what}: eps over {eps.numel()} draws: mean {m:+.5f} std "
          f"{s:.5f} share>5sigma {tail:.2e} max|eps| "
          f"{eps.abs().max().item():.3f}")
    check(abs(m) < 0.01 and abs(s - 1) < 0.01 and tail < 1e-5,
          f"{name} sampled normals' moments ({what})")


def fourth_slice(card: str, dev) -> dict:
    import os
    import tempfile

    import torch
    from stove_tpu_torch import main as entry
    from stove_tpu_torch import tree
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.models import dynamics as dyn_lib
    from stove_tpu_torch.models import stove as stove_lib
    from stove_tpu_torch.models.bundle import StoveModel
    from stove_tpu_torch.ops import fused_likelihood as flik
    from stove_tpu_torch.ops import fused_rollout as fr
    from stove_tpu_torch.ops import fused_scan as fscan
    from stove_tpu_torch.train import checkpoint as ckpt_lib

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_4_")
    acfg = ckpt_lib.load_config(AVOID)
    amodel = StoveModel.from_run(AVOID, device=dev)
    gcfg = ckpt_lib.load_config(GRAV)
    gmodel = StoveModel.from_run(GRAV, device=dev)

    def zero():
        for k in (fscan, flik, fr):
            k.launch_kernel.launches = 0

    def counts():
        return {"scan": fscan.launch_kernel.launches,
                "likelihood": flik.launch_kernel.launches,
                "rollout": fr.launch_kernel.launches}

    def files(run):
        return {p: os.path.getmtime(p) for p in
                [os.path.join(run, f) for f in os.listdir(run)]}

    # ---- (17) scan-act: the scan kernel with actions and the reward head
    # at the avoidance training shape (B=256, T2=10), the checkpoint's
    # weights, posterior inputs of rendered avoidance frames and their
    # actions; then the gravity model's window (T2=14, no new code, a
    # longer loop), held as phase (8) and, past its sixth step, by phase
    # (2)'s float64 criterion (printed in the by-step line); each again at
    # B=255, the small tile's last block ragged
    gen = torch.Generator().manual_seed(17)
    a_args, a_acts, a_eps = scan_inputs(amodel, acfg, 256, gen, dev)
    check(a_acts.min().item() >= 0 and len(torch.unique(a_acts)) > 1,
          "the windows' actions vary")
    out["scan_act_err"], out["scan_act_rew_err"], rew = hold_scan(
        "scan-act", amodel.params["dynamics"], acfg, a_args, a_acts, a_eps)
    check(rew.min().item() < 0.5 < rew.max().item(),
          "the kernel's rewards span both classes")
    g_args, g_acts, g_eps = scan_inputs(gmodel, gcfg, 256, gen, dev)
    out["scan_grav_err"], _, _ = hold_scan(
        "scan-act", gmodel.params["dynamics"], gcfg, g_args, g_acts, g_eps)
    for mdl, c, args, acts, eps, key in (
            (amodel, acfg, a_args, a_acts, a_eps, "scan_act"),
            (gmodel, gcfg, g_args, g_acts, g_eps, "scan_grav")):
        ez, er, _ = hold_scan("scan-act", mdl.params["dynamics"], c,
                              [a[:255] for a in args], acts[:255], eps[:255])
        out[f"{key}_err"] = max(out[f"{key}_err"], ez)
        if c.reward_head:
            out["scan_act_rew_err"] = max(out["scan_act_rew_err"], er)

    # ---- (18) avoid-train: preset=stove_avoidance from scratch at full
    # width (only the corpus cut), 2 warm-up + 3 STOVE steps through the
    # scan and likelihood kernels; every loss finite, reward terms too
    common = ["preset=stove_avoidance", "num_train=64", "num_test=32",
              "steps_per_epoch=1", f"run_dir={tmp}", fresh_data()]
    zero()
    t = time.perf_counter()
    cfg_a, _, dev_a = entry.build_config(
        common + ["scan_impl=pallas", "likelihood_impl=pallas",
                  "num_epochs=5", "supair_only_epochs=2", "eval_every=5",
                  "run_name=avoid_scratch"])
    tr_a, res_a = entry.run_train(cfg_a, dev_a)
    torch.cuda.synchronize()
    n = counts()
    rows = [json.loads(ln) for ln in open(
        os.path.join(tr_a.run_dir, "metrics.jsonl"))]
    train_rows = [r for r in rows if r["kind"] == "train"]
    phase("avoid-train", f"from scratch: 5 epochs of 1 step in "
          f"{time.perf_counter() - t:.1f} s; launches {n}; last loss "
          f"{res_a['loss']:.2f} elbo {res_a['elbo']:.2f} reward_loss "
          f"{res_a['reward_loss']:.4f} overshoot_reward "
          f"{res_a['overshoot_reward']:.4f} reward_auc "
          f"{res_a['reward_auc']:.3f}")
    check(n["scan"] > 0 and n["likelihood"] > 0 and n["rollout"] > 0,
          "avoidance training launched scan, likelihood and rollout")
    check(len(train_rows) == 5 and all(
        math.isfinite(r[k]) for r in train_rows for k in r
        if isinstance(r[k], float)), "finite avoidance training losses")
    stove_rows = train_rows[2:]
    check(all(r["reward_loss"] > 0 and r["overshoot_reward"] > 0
              for r in stove_rows), "reward losses in the STOVE steps")
    out["launches_avoid_train"] = n

    # one batch, the same noise: kernel-path gradients against plain-path
    # ones (the scan on its float32 library, float32_scan), leaf by leaf,
    # to phase (9)'s limits, raised to the plain path's own noise floor
    # where that is higher (frames_floor); the reward heads' and the
    # action rows' gradients must be nonzero.  On the card the floor was
    # 1.7e-3 of a leaf's largest entry for frames moved by 1e-6 and 2.9e-3
    # for 1e-5, above phase (9)'s 1e-3, and the plain path run twice gave
    # 1.4e-6.  The reward attention's last bias shifts every object's
    # softmax logit alike, so its gradient is zero up to rounding (~2e-9):
    # like a mixture logit, it is held to 1e-6 absolute.
    B, T = cfg_a.batch_size, cfg_a.window
    batch = data_lib.sample_windows(tr_a.train_ep, cfg_a,
                                    torch.Generator(device=dev).manual_seed(3),
                                    B)
    noise = stove_lib.draw_elbo_noise(cfg_a, B, T,
                                      torch.Generator().manual_seed(4), dev)
    leaves = tree.leaves(tr_a.params)

    def grads(c):
        loss = stove_lib.elbo(tr_a.params, c, tr_a.model.specs,
                              batch["frames"], batch["actions"],
                              batch["rewards"], noise).loss
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    plain_a = cfg_a.with_overrides(scan_impl="xla", likelihood_impl="xla")
    with float32_scan():
        g_k = grads(cfg_a)
    g_p = grads(plain_a)
    paths = [p for p, _ in tree.paths(tr_a.params)]
    absolute = lambda path: ("logits" in str(path[-1])  # noqa: E731
                             or tree.keystr(path).endswith(
                                 "['reward_att'][2]['b']"))
    floor = frames_floor(grads, batch, plain_a, paths, g_p, absolute, dev)
    rows_g, named = [], {}
    for path, a, b in zip(paths, g_k, g_p):
        key = tree.keystr(path)
        named[key] = a
        if b is None:
            check(a is None, f"gradient presence {key}")
            continue
        scale = 1.0 if absolute(path) else (b.abs().max().item() or 1.0)
        rows_g.append(((a - b).abs().max().item() / scale, scale, key,
                       absolute(path)))
    lim_rel = max(1e-3, floor)
    worst_rel = max(d for d, _, _, ab in rows_g if not ab)
    rows_g = sorted(((d / (1e-6 if ab else lim_rel), sc, k)
                     for d, sc, k, ab in rows_g), reverse=True)
    for r in rows_g[:3]:
        phase("avoid-train", f"gradient {r[2]}: max |kernel - plain| / scale "
              f"{r[0]:.2e} of its limit; scale {r[1]:.3e}")
    phase("avoid-train", f"the plain path's own floor (frames moved by "
          f"1e-5): {floor:.2e} of a leaf's largest entry; limit "
          f"{lim_rel:.2e}; largest |kernel - plain| of a leaf held "
          f"relatively {worst_rel:.2e} of its largest entry")
    # every reward-head leaf but the attention's last bias, which shifts
    # all objects' softmax logits alike and so has no gradient
    reward_g = [v for k, v in named.items() if "reward" in k
                and not k.endswith("['reward_att'][2]['b']")]
    e0 = [v for k, v in named.items()
          if "embed" in k and "[0]" in k and k.endswith("['w']")][0]
    act_rows = e0[acfg.full_state_dim:].abs().max().item()
    phase("avoid-train", f"gradients on one batch, {len(rows_g)} leaves: "
          f"worst share of the limit {rows_g[0][0]:.2e}; reward-head leaves "
          f"{len(reward_g)}, smallest max |g| "
          f"{min(v.abs().max().item() for v in reward_g):.3e}; action rows "
          f"max |g| {act_rows:.3e}")
    check(rows_g[0][0] <= 1.0, "avoidance kernel-path gradients")
    check(reward_g and all(v.abs().max().item() > 0 for v in reward_g),
          "reward-head gradients nonzero")
    check(act_rows > 0, "action-row gradients nonzero")

    # ---- (19) avoid-resume: 20 steps from ckpts/r4a_dense_s2 with its
    # Adam state through the kernels; means in AVOID_RESUME_BAND
    before = files(AVOID)
    zero()
    t = time.perf_counter()
    cfg_r, _, dev_r = entry.build_config(
        [f"restore={AVOID}", "mode=train", "scan_impl=pallas",
         "likelihood_impl=pallas", f"num_epochs={acfg.num_epochs + 1}",
         f"run_dir={tmp}", fresh_data()])
    tr_r, _ = entry.run_train(cfg_r, dev_r)
    torch.cuda.synchronize()
    n = counts()
    steps = [{k: float(v) for k, v in m.items()} for m in tr_r.epoch_metrics]
    mean = {k: sum(s[k] for s in steps) / len(steps)
            for k in ("elbo", "kl", "reward_loss", "overshoot",
                      "overshoot_reward")}
    phase("avoid-resume", f"{AVOID} step {tr_r.step - len(steps)} -> "
          f"{tr_r.step} in {time.perf_counter() - t:.1f} s, {len(steps)} "
          f"steps: mean elbo {mean['elbo']:.2f}, kl {mean['kl']:.3f}, "
          f"reward_loss {mean['reward_loss']:.4f}, overshoot "
          f"{mean['overshoot']:.5f}, overshoot_reward "
          f"{mean['overshoot_reward']:.4f}; launches {n}; elbo by step "
          + " ".join(f"{s['elbo']:.1f}" for s in steps))
    check(len(steps) == 20, "20 resumed avoidance steps")
    check(n["scan"] > 0 and n["likelihood"] > 0,
          "avoidance resume launched the kernels")
    for k, (lo, hi) in AVOID_RESUME_BAND.items():
        check(lo <= mean[k] <= hi,
              f"avoidance resume {k} {mean[k]} outside [{lo}, {hi}]")
    check(files(AVOID) == before, f"nothing written under {AVOID}")
    out["avoid_resume"] = mean
    out["launches_avoid_resume"] = n

    # ---- (20) open-sampled: the open-loop std head in the sampled kernel,
    # r4rp_grav_s32 weights, z0 from the posterior of rendered gravity
    # frames.  H=1: eps recovered with the plain version's
    # rollout_sigma_temp * std_open; H=92: dispersion kernel/plain; the
    # mean rollout of this model by phase (2)'s criterion.
    gdyn, gprep = gmodel.params["dynamics"], gmodel.prepared
    check(fr.has_open_head(gcfg, gdyn), "the gravity model has the head")
    wcfg = gcfg.with_overrides(seq_len=gcfg.window)
    ep = data_lib.generate(wcfg, 4096, gen, dev)
    with torch.no_grad():
        inf = gmodel.infer(data_lib.normalize_frames(ep.frames), None,
                           generator=gen)
    z_post = inf.z_mean[:, -1].contiguous()
    check(bool(torch.isfinite(z_post).all()), "gravity posterior finite")
    z0 = z_post.repeat(4, 1, 1).contiguous()                  # 16384
    s, _ = fr.rollout(gdyn, gcfg, z0, 1, True,
                      torch.Generator().manual_seed(20), gprep)
    d = dyn_lib.apply(gdyn, gcfg, z0)
    check(s.numel() >= 10 ** 6, "at least 1e6 draws")
    temp = gcfg.rollout_sigma_temp
    eps_moments("open-sampled", (s[:, 0] - d.mean) / (temp * d.std_open),
                "B=16384 H=1")
    # the same seed through the library without the head draws the same
    # normals (Philox counters): the std the open library injected, implied
    # from its sample and those normals, against temp * std_open of the
    # plain head, where the normal is well above rounding (|eps| > 0.5)
    seed = int(torch.randint(0, 2 ** 62, (1,),
                             generator=torch.Generator().manual_seed(20)))
    mean_k, _ = fr.launch_kernel(gprep, gcfg, z0, 1, False, 0)
    s_f, _ = fr.launch_kernel(gprep, gcfg, z0, 1, True, seed)
    s_o, _ = fr.launch_kernel(gprep, gcfg, z0, 1, True, seed, None, True)
    check(torch.equal(s_o, s), "the open library is what rollout launched")
    eps_k = (s_f - mean_k)[:, 0] / (temp * d.std)
    implied = (s_o - mean_k)[:, 0] / eps_k
    want = temp * d.std_open
    mask = eps_k.abs() > 0.5
    mask[..., :2] = False
    err = (implied - want).abs()[mask]
    rel = err / want[mask]
    out["open_std_err"] = err.max().item()
    phase("open-sampled", f"same normals through both libraries: implied "
          f"std vs temp * std_open over {int(mask.sum())} entries: max |err| "
          f"{err.max().item():.3e}, relative max {rel.max().item():.2e} "
          f"median {rel.median().item():.2e}")
    check(rel.max().item() <= 1e-2, f"open-loop std error {rel.max()}")
    phase("open-sampled", f"std_open / std on these states: "
          f"{(d.std_open[..., 2:] / d.std[..., 2:]).mean().item():.4f} mean,"
          f" std_open in [{d.std_open[..., 2:].min().item():.4g}, "
          f"{d.std_open[..., 2:].max().item():.4g}]")
    Bd, Hd = 8192, 92
    z_one = z_post[:1].expand(Bd, -1, -1).contiguous()
    got, _ = fr.rollout(gdyn, gcfg, z_one, Hd, True,
                        torch.Generator().manual_seed(21), gprep)
    noise = torch.randn((Bd, Hd) + tuple(z_one.shape[1:]), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(22))
    ref, _ = fr.rollout_states_reference(gdyn, gcfg, z_one, Hd, noise)
    disp = lambda x: x[:, -1, :, 2:4].std(dim=0).mean().item()  # noqa: E731
    ratio = disp(got) / max(disp(ref), 1e-12)
    phase("open-sampled", f"H={Hd} B={Bd} position dispersion kernel/plain "
          f"= {ratio:.4f} ({disp(got):.4f} / {disp(ref):.4f})")
    check(0.9 <= ratio <= 1.1, f"open-head dispersion ratio {ratio}")
    out["open_err"] = hold_mean_rollout("open-sampled", gdyn, gcfg, z_post,
                                        gprep)

    # the library with actions, the reward head and the open head
    # (rollout_act's sampled case, pallas_rollout.py:510): no committed run
    # has it, so a random open head is added to r4a_dense_s2's dynamics; at
    # the planner's B=576, H=10, sampled, the eps of every step recovered
    # from the kernel's own previous state, and its rewards against the
    # plain reward head on that state
    ocfg = acfg.with_overrides(open_loop_sigma=True)
    odyn = dict(amodel.params["dynamics"], open=dyn_lib.init_params(
        acfg.with_overrides(open_loop_sigma=True),
        torch.Generator().manual_seed(23), dev)["open"])
    oprep = fr.prepare_params(odyn, ocfg)
    check(oprep.numel() == fr.kernel_bytes(ocfg, True)
          > fr.kernel_bytes(acfg), "the open head's packed buffer")
    a_post = a_args[0]                               # posterior z1, 256 rows
    z0 = a_post[torch.arange(576, device=dev) % a_post.shape[0]].contiguous()
    acts = torch.randint(0, acfg.num_actions, (576, 10), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(24))
    zero()
    s, r = fr.rollout(odyn, ocfg, z0, 10, True,
                      torch.Generator().manual_seed(25), oprep, acts)
    check(fr.launch_kernel.launches == 1, "one launch of the open library")
    prev, eps, rerr = z0, [], 0.0
    for t_ in range(10):
        d = dyn_lib.apply(odyn, ocfg, prev, acts[:, t_])
        eps.append((s[:, t_] - d.mean) / (ocfg.rollout_sigma_temp
                                          * d.std_open))
        rerr = max(rerr, (r[:, t_] - d.reward).abs().max().item())
        prev = s[:, t_]
    eps_moments("open-sampled", torch.stack(eps),
                "actions + reward head + open head, B=576 H=10, every step")
    phase("open-sampled", f"its rewards vs the plain head on the kernel's "
          f"states: max |err| {rerr:.3e}")
    check(rerr <= 1e-4, f"open library rewards error {rerr}")
    out["act_open_rew_err"] = rerr
    g25 = torch.Generator().manual_seed(25)
    out["act_open_ms"] = time_cuda(lambda: fr.rollout(
        odyn, ocfg, z0, 10, True, g25, oprep, acts), iters=50, warmup=2)
    noise = torch.randn((576, 10) + tuple(z0.shape[1:]), device=dev)
    out["act_open_plain_ms"] = time_cuda(lambda: fr.rollout_states_reference(
        odyn, ocfg, z0, 10, noise, acts), iters=5)
    out["act_open_bound"] = rollout_bound(
        2.0 * macs_per_frame(ocfg, open_head=True) * 576 * 10,
        4.0 * (z0.numel() * 11 + 2 * 576 * 10) + oprep.numel(), "float32")
    zero()

    # ---- (21) grav-eval: mode=eval of r4rp_grav_s32 through the entry
    # point, launches by (B, H, sampled, open head); then with the plain
    # rollout; the JAX band; the sampled metrics beside 8 plain draws
    ecfg, _, edev = entry.build_config([f"restore={GRAV}", "mode=eval",
                                        fresh_data()])
    torch.backends.cudnn.allow_tf32 = True
    shapes = {}
    fr.launch_kernel.launches = 0
    t = time.perf_counter()
    with recording_rollouts(shapes):
        m = entry.run_eval(ecfg, edev)
        torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    launches = fr.launch_kernel.launches
    for k, v in m.items():
        print(f"  {k}: {v.detach().cpu().numpy()}")
    phase("grav-eval", f"mode=eval of {GRAV} on the card {eval_s:.2f} s; "
          f"rollout launches {launches} by (B, H, sampled, open head): "
          + ", ".join(f"{k}: {v}" for k, v in sorted(shapes.items())))
    check(launches > 0 and any(k[3] for k in shapes),
          "gravity eval launched the open-head library")
    check(not (torch.backends.cudnn.allow_tf32
               or torch.backends.cuda.matmul.allow_tf32),
          "the entry point runs with TF32 off")
    mse, lin = m["mse_final"].item(), m["linear_mse_final"].item()
    check(math.isfinite(mse) and mse < lin,
          f"mse_final {mse} finite and below linear baseline {lin}")
    mp = compare_plain_eval("grav-eval", m, ecfg, edev, launches)
    for k, (lo, hi) in GRAV_EVAL_BAND.items():
        v = m[k].item()
        phase("grav-eval", f"{k} {v:.6g} in [{lo}, {hi}] (the JAX package's "
              f"range on this corpus, widened)")
        check(lo <= v <= hi, f"{k} {v} outside [{lo}, {hi}]")
    # sampled 80-step metrics: the plain path's spread over 8 draws; the
    # kernel's value within the draws' range widened by its width
    from stove_tpu_torch.train import evaluate as eval_lib
    test_ep = data_lib.split(ecfg, "test", dev)
    emodel = StoveModel.from_run(GRAV, cfg=ecfg, device=dev)
    kernel_dispatch = fr.rollout
    fr.rollout = plain_rollout
    try:
        draws = [eval_lib.longhorizon_metrics(
            emodel, test_ep, torch.Generator().manual_seed(ecfg.seed + 100 + k),
            t_pred=80, sample=True) for k in range(8)]
    finally:
        fr.rollout = kernel_dispatch
    sampled = {}
    for k in ("speed_ratio", "frac_in_frame"):
        v = [float(dr[k]) for dr in draws]
        lo, hi = min(v), max(v)
        w = hi - lo
        got_v = m[f"longhorizon_sampled_{k}"].item()
        plain_v = mp[f"longhorizon_sampled_{k}"].item()
        phase("grav-eval", f"sampled 80-step {k}: kernel {got_v:.5f}, plain "
              f"path {plain_v:.5f}; 8 plain draws {lo:.5f} to {hi:.5f} (mean "
              f"{sum(v) / 8:.5f}); limit [{lo - w:.5f}, {hi + w:.5f}]")
        check(lo - w <= got_v <= hi + w,
              f"sampled {k} {got_v} outside the plain draws' limit")
        sampled[k] = (got_v, plain_v, lo, hi)
    out["grav_eval"] = {k: m[k].item() for k in GRAV_EVAL_BAND}
    out["grav_eval_sampled"] = sampled
    out["launches_grav_eval"] = {str(k): v for k, v in shapes.items()}
    out["open_launches_eval"] = sum(v for k, v in shapes.items() if k[3])

    # ---- (22) grav-train: 20 steps resumed from ckpt_00005200 through the
    # kernels, and the Trainer's evaluation after them (eval_every=1: its
    # 80-step sampled rollouts launch the open-head library); means in
    # GRAV_RESUME_BAND
    before = files(GRAV)
    zero()
    shapes = {}
    t = time.perf_counter()
    cfg_g, _, dev_g = entry.build_config(
        [f"restore={GRAV}", "mode=train", "scan_impl=pallas",
         "likelihood_impl=pallas", f"num_epochs={gcfg.num_epochs + 1}",
         "eval_every=1", f"run_dir={tmp}", fresh_data()])
    with recording_rollouts(shapes):
        tr_g, res_g = entry.run_train(cfg_g, dev_g)
        torch.cuda.synchronize()
    n = counts()
    steps = [{k: float(v) for k, v in m_.items()} for m_ in tr_g.epoch_metrics]
    gmean = {k: sum(s_[k] for s_ in steps) / len(steps)
             for k in ("elbo", "kl", "overshoot", "open_sigma_nll",
                       "log_lik")}
    gmean["overshoot_loss"] = gmean.pop("overshoot")
    phase("grav-train", f"{GRAV} step {tr_g.step - len(steps)} -> "
          f"{tr_g.step} in {time.perf_counter() - t:.1f} s, {len(steps)} "
          f"steps: mean elbo {gmean['elbo']:.2f}, kl {gmean['kl']:.3f}, "
          f"overshoot {gmean['overshoot_loss']:.5f}, open_sigma_nll "
          f"{gmean['open_sigma_nll']:.3f}; eval mse_final "
          f"{res_g['mse_final']:.5f} val_speed_ratio "
          f"{res_g['val_speed_ratio']:.4f} sampled "
          f"{res_g['val_speed_ratio_sampled']:.4f}; launches {n}, rollouts "
          f"by (B, H, sampled, open head): " + ", ".join(
              f"{k}: {v}" for k, v in sorted(shapes.items())))
    check(len(steps) == 20, "20 resumed gravity steps")
    check(n["scan"] > 0 and n["likelihood"] > 0 and any(
        k[3] for k in shapes), "gravity training launched scan, likelihood "
          "and the open-head rollout")
    for k, (lo, hi) in GRAV_RESUME_BAND.items():
        check(lo <= gmean[k] <= hi,
              f"gravity resume {k} {gmean[k]} outside [{lo}, {hi}]")
    check(files(GRAV) == before, f"nothing written under {GRAV}")
    out["grav_resume"] = gmean
    out["launches_grav_train"] = n
    out["open_launches_train"] = sum(v for k, v in shapes.items() if k[3])

    # ---- (23) timing: the scan kernel with actions and the reward head at
    # (256, 10), the gravity scan at (256, 14), the open-head sampled
    # rollout at B=16384, H=92, each beside its bound and plain version
    def scan_bound(cfg, args, acts, eps, packed):
        B_, T2 = acts.shape
        flops = 2.0 * macs_per_frame(cfg) * B_ * T2
        nbytes = 4.0 * (sum(a.numel() for a in args) + 3 * eps.numel() + B_
                        + 2 * B_ * T2) + packed.numel()
        return bound(flops, nbytes)

    timing = {}
    with torch.no_grad():
        for label, mdl, c, args, acts, eps in (
                ("avoid", amodel, acfg, a_args, a_acts, a_eps),
                ("grav", gmodel, gcfg, g_args, g_acts, g_eps)):
            dyn = mdl.params["dynamics"]
            packed = fscan.prepare_params(dyn, c)
            k_ms = time_cuda(lambda: fscan.launch_kernel(
                packed, c, *args, eps, acts), iters=20, warmup=2)
            p_ms = time_cuda(lambda: fscan.scan_reference(
                dyn, c, *args, acts, eps), iters=5)
            b_ms, by = scan_bound(c, args, acts, eps, packed)
            timing[f"scan_{label}"] = (k_ms, p_ms, b_ms, by)
            phase("timing4", f"scan kernel {label} B=256 T2={acts.shape[1]}:"
                  f" {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms "
                  f"({by}, {macs_per_frame(c)} MACs/frame) on {card}")
        z0 = z_post.repeat(4, 1, 1).contiguous()
        g26 = torch.Generator().manual_seed(26)
        k_ms = time_cuda(lambda: fr.rollout(gdyn, gcfg, z0, 92, True, g26,
                                            gprep), iters=10)
        noise = torch.randn((16384, 92) + tuple(z0.shape[1:]), device=dev)
        p_ms = time_cuda(lambda: fr.rollout_states_reference(
            gdyn, gcfg, z0, 92, noise), iters=2)
        macs = macs_per_frame(gcfg, open_head=True)
        flops = 2.0 * macs * 16384 * 92
        nbytes = 4.0 * z0.numel() * 93 + gprep.numel()
        b_ms, by = rollout_bound(flops, nbytes, "float32")
        timing["open"] = (k_ms, p_ms, b_ms, by)
        phase("timing4", f"open-head sampled rollout B=16384 H=92: "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({by},"
              f" {macs} MACs/frame), {flops / (k_ms * 1e-3) / 1e12:.2f} "
              f"TFLOP/s, {16384 * 92 / k_ms * 1e3:,.0f} frames/s on {card}")
    out["timing"] = timing
    phase("timing4", "launches by path: avoid-train "
          f"{out['launches_avoid_train']}, avoid-resume "
          f"{out['launches_avoid_resume']}, grav-eval "
          f"{out['launches_grav_eval']}, grav-train "
          f"{out['launches_grav_train']} (open head "
          f"{out['open_launches_train']})")
    return out


# ---------------------------------------------------------------------------
# the fifth slice: the rollout kernel on the tensor cores in both of the TPU
# kernel's precisions (and a small tile for small batches), the scan's
# bfloat16 forward, the planner's bfloat16 leaves
# ---------------------------------------------------------------------------

BF16_STATES = dict(max_ratio=2.0, share=1e-2)   # as tests/bf16_parity.py
BF16_REWARDS = dict(max_ratio=2.0, share=3e-2)


def hold_bf16(name, got, ref_bf16, ref_f32, steps=4,
              max_ratio=BF16_STATES["max_ratio"], share=BF16_STATES["share"]):
    """A bf16 library's output against the plain version at bf16 over steps
    1..`steps` (dim 1): the median of |got - plain bf16| over the step, and
    its median over the (sample, object) entries of each last-dim column,
    at most 0.1x that of |plain bf16 - plain f32| (the same rounding
    points: a missing or wrong one moves every sample).  Two f32 sums of
    the same bf16 products in another order now and then round an
    activation to the neighbouring bf16 value, which moves that one row
    (tests/test_torch_rollout_bf16.py); such rows are held apart: the
    largest |got - plain bf16| at most `max_ratio` times the largest |plain
    bf16 - plain f32|, and at most `share` of the step's entries (or one
    (sample, object) row's, where that is more) above 0.1x that largest
    distance, so a fault in a share of the rows (one sample of a block,
    one warp's rows) fails.  Returns (the largest |got - plain bf16|, the
    largest median ratio, the ratio of the maxima)."""
    import torch
    emax = worst_med = worst_max = 0.0
    for t in range(steps):
        d = (got[:, t] - ref_bf16[:, t]).abs().double()
        r = (ref_bf16[:, t] - ref_f32[:, t]).abs().double()
        cols = d.shape[-1] if d.dim() > 1 else 1
        cd = d.reshape(-1, cols).median(0).values
        cr = r.reshape(-1, cols).median(0).values
        dm, rm = d.median().item(), r.median().item()
        ratio_cols = torch.where(cr > 0, cd / cr.clamp_min(1e-30),
                                 torch.where(cd > 0, torch.inf, 0.0))
        ratio = d.max().item() / max(r.max().item(), 1e-30)
        moved = (d > 0.1 * r.max()).double().mean().item()
        worst_med = max(worst_med, dm / max(rm, 1e-30),
                        ratio_cols.max().item())
        worst_max = max(worst_max, ratio)
        emax = max(emax, d.max().item())
        phase(name, f"step {t + 1}: |kernel - plain bf16| median {dm:.2e} "
              f"max {d.max().item():.2e}; |plain bf16 - plain f32| median "
              f"{rm:.2e} max {r.max().item():.2e}; largest column median "
              f"ratio {ratio_cols.max().item():.3f}; ratio of the maxima "
              f"{ratio:.3f}; share of entries above 0.1x the bf16 - f32 "
              f"maximum {moved:.2e}")
        check(rm > 0, f"{name}: the bf16 plain version differs from f32")
        check(dm <= 0.1 * rm and ratio_cols.max().item() <= 0.1,
              f"{name} step {t + 1}: kernel vs plain bf16 medians")
        check(ratio <= max_ratio, f"{name} step {t + 1}: kernel vs plain "
              f"bf16 maximum {ratio:.3f}x the bf16 - f32 maximum")
        check(moved <= max(share, cols / d.numel()), f"{name} step {t + 1}: "
              f"share of moved entries {moved:.2e}")
    return emax, worst_med, worst_max


def hold_f32_large(name, dyn, cfg, z0, H, acts, prep):
    """The float32 library at 16 samples a block: step 1 within 1e-4 of the
    plain version in float32 and float64 (phase (12)'s limit), over all H
    steps its distance from float64 at most twice the float32 plain
    version's (phase (2)'s long-horizon criterion), rewards within 1e-4
    at step 1.  Returns the largest step-1 error."""
    import torch
    from stove_tpu_torch.ops import fused_rollout as fr
    from stove_tpu_torch.train import checkpoint as ckpt_lib
    d64 = ckpt_lib.params_from_numpy(dyn, z0.device, torch.float64)
    got, rew = fr.rollout(dyn, cfg, z0, H, False, None, prep, acts)
    ref, rref = fr.rollout_states_reference(dyn, cfg, z0, H, None, acts)
    q, qr = fr.rollout_states_reference(d64, cfg, z0.double(), H, None, acts)
    torch.cuda.synchronize()
    dist = lambda a, b, k: (a[:, :k].double()  # noqa: E731
                            - b[:, :k].double()).abs().max().item()
    s32, s64 = dist(got, ref, 1), dist(got, q, 1)
    k_all, p_all = dist(got, q, H), dist(ref, q, H)
    r1 = max(dist(rew[:, :, None], rref[:, :, None], 1),
             dist(rew[:, :, None], qr[:, :, None], 1))
    phase(name, f"float32 library B={z0.shape[0]} H={H} (tile "
          f"{fr.tile_for(z0.shape[0])}): step 1 vs float32 {s32:.3e}, vs "
          f"float64 {s64:.3e}; over {H} steps from float64: kernel "
          f"{k_all:.3e}, float32 plain {p_all:.3e}; rewards step 1 {r1:.2e}")
    check(s32 <= 1e-4 and s64 <= 1e-4, f"{name} step-1 error {s32} / {s64}")
    check(k_all <= 2 * p_all, f"{name} distance from float64 {k_all} > 2x "
          f"the float32 plain version's {p_all}")
    check(r1 <= 1e-4, f"{name} step-1 rewards error {r1}")
    return s32


def implied_open_std(name, dyn, cfg, z0, dtype, prep, lim):
    """The open-loop std head of the `dtype` library at B = len(z0), H=1:
    the same seed through the library without the head draws the same
    normals, so the std the head's library injected is implied; against
    rollout_sigma_temp * std_open of the plain head at that precision,
    where |eps| > 0.5: the median relative error within `lim` (and, for
    float32, phase (20)'s maximum within 1e-2).  Returns the max |err|."""
    import torch
    from stove_tpu_torch.models import dynamics as dyn_lib
    from stove_tpu_torch.ops import fused_rollout as fr
    temp = cfg.rollout_sigma_temp
    d = dyn_lib.apply(dyn, cfg, z0, None, dtype)
    mean_k, _ = fr.launch_kernel(prep, cfg, z0, 1, False, 0, None, False,
                                 dtype)
    s_f, _ = fr.launch_kernel(prep, cfg, z0, 1, True, 29, None, False, dtype)
    s_o, _ = fr.launch_kernel(prep, cfg, z0, 1, True, 29, None, True, dtype)
    eps_k = (s_f - mean_k)[:, 0] / (temp * d.std)
    mask = eps_k.abs() > 0.5
    mask[..., :2] = False
    want = (temp * d.std_open)[mask]
    err = ((s_o - mean_k)[:, 0] / eps_k)[mask] - want
    rel = err.abs() / want
    phase(name, f"{dtype} open-head library B={z0.shape[0]} (tile "
          f"{fr.tile_for(z0.shape[0])}): implied std vs temp * std_open over "
          f"{int(mask.sum())} entries: relative median {rel.median().item():.2e}"
          f" max {rel.max().item():.2e}")
    check(rel.median().item() <= lim, f"{name} open-head std ({dtype})")
    if dtype == "float32":
        check(rel.max().item() <= 1e-2, f"{name} open-head std max")
    return err.abs().max().item()


def fifth_slice(card: str, dev, model, z_post) -> dict:
    import torch
    from stove_tpu_torch import main as entry
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.models.bundle import StoveModel
    from stove_tpu_torch.ops import fused_rollout as fr
    from stove_tpu_torch.ops import fused_scan as fscan
    from stove_tpu_torch.planning import runner
    from stove_tpu_torch.planning import simulators as sims
    from stove_tpu_torch.train import checkpoint as ckpt_lib

    out = {}
    cfg, dyn = model.cfg, model.params["dynamics"]
    acfg = ckpt_lib.load_config(AVOID)
    amodel = StoveModel.from_run(AVOID, device=dev)
    adyn = amodel.params["dynamics"]
    gcfg = ckpt_lib.load_config(GRAV)
    gmodel = StoveModel.from_run(GRAV, device=dev)
    gdyn = gmodel.params["dynamics"]
    gen = torch.Generator().manual_seed(30)
    agen = torch.Generator(device=dev).manual_seed(31)

    def posterior(mdl, c, n):
        ep = data_lib.generate(c.with_overrides(seq_len=c.window), n, gen, dev)
        with torch.no_grad():
            inf = mdl.infer(data_lib.normalize_frames(ep.frames),
                            ep.actions if c.action_conditioned else None,
                            generator=gen)
        return inf.z_mean[:, -1].contiguous()

    a_post = posterior(amodel, acfg, 1024)
    g_post = posterior(gmodel, gcfg, 1024)
    rows = lambda zp, B: zp[torch.arange(B, device=dev)  # noqa: E731
                            % zp.shape[0]].contiguous()

    # ---- (24) bf16: every bf16 rollout library against the plain version
    # at bf16, at 16 samples a block (B=16384) and at the small tile (the
    # planner's B=576), billiards from the posterior states of phase (2),
    # avoidance with random actions and its rewards; the float32 libraries
    # at B=16384 (16 samples a block; phases (2) and (12) hold the small
    # tile); the open-loop head of both precisions; the bf16 scan library
    # against the plain loop at bf16 on the windows of each model
    with torch.no_grad():
        for label, mdl, c, zp in (("billiards", model, cfg, z_post),
                                  ("avoidance", amodel, acfg, a_post)):
            d_ = mdl.params["dynamics"]
            pb = mdl.prepared_for("bfloat16")
            for B in (16384, 576):
                z0 = rows(zp, B)
                acts = (torch.randint(0, c.num_actions, (B, 4), device=dev,
                                      generator=agen)
                        if c.action_conditioned else None)
                got, rew = fr.rollout(d_, c, z0, 4, False, None, pb, acts,
                                      "bfloat16")
                rb, rrb = fr.rollout_states_reference(d_, c, z0, 4, None,
                                                      acts, "bfloat16")
                rf, rrf = fr.rollout_states_reference(d_, c, z0, 4, None,
                                                      acts)
                torch.cuda.synchronize()
                name = f"bf16 {label} B={B}"
                e, med, mx = hold_bf16(name, got, rb, rf)
                key = fr.job(fr.kernel_config(c, d_), False, "bfloat16",
                             fr.tile_for(B))
                fields = {"err": e, "median_ratio": med, "max_ratio": mx}
                if c.reward_head:
                    e_r, med_r, mx_r = hold_bf16(name + " rewards",
                                                 rew[..., None], rrb[..., None],
                                                 rrf[..., None], **BF16_REWARDS)
                    fields.update(err_rewards=e_r, median_ratio_rewards=med_r,
                                  max_ratio_rewards=mx_r)
                note(key, **fields)
                out[f"bf16_{label}_{B}"] = fields
            z0 = rows(zp, 16384)
            acts = (torch.randint(0, c.num_actions, (16384, 8), device=dev,
                                  generator=agen)
                    if c.action_conditioned else None)
            e = hold_f32_large("f32-large", d_, c, z0, 8, acts, mdl.prepared)
            note(fr.job(fr.kernel_config(c, d_), False, "float32", 16), err=e)
        gz = rows(g_post, 16384)
        note(fr.job(gcfg, True, "bfloat16", 16), err=implied_open_std(
            "bf16", gdyn, gcfg, gz, "bfloat16",
            gmodel.prepared_for("bfloat16"), 1e-2))
        note(fr.job(gcfg, True, "float32", 4), err=implied_open_std(
            "bf16", gdyn, gcfg, rows(g_post, 576), "float32", gmodel.prepared,
            1e-2))
        for label, mdl, c, sizes in (("billiards", model, cfg, (256, 255, 2113)),
                                     ("avoidance", amodel, acfg, (256, 255)),
                                     ("gravity", gmodel, gcfg, (256, 255))):
            args256, acts256, eps256 = scan_inputs(mdl, c, 256, gen, dev)
            d_ = mdl.params["dynamics"]
            prep = fscan.prepare_params(d_, c, "bfloat16")
            for nb in sizes:
                # B=255: the small tile's last block ragged; 2113: 16
                # samples a block, the last block one sample (the window's
                # inputs repeated)
                args = [batch_rows(a, nb) for a in args256]
                acts, eps = batch_rows(acts256, nb), batch_rows(eps256, nb)
                k = fscan.launch_kernel(prep, c, *args, eps, acts, "bfloat16")
                rb = fscan.scan_reference(d_, c, *args, acts, eps,
                                          dtype="bfloat16")
                rf = fscan.scan_reference(d_, c, *args, acts, eps)
                torch.cuda.synchronize()
                name = f"bf16 scan {label} B={nb}"
                fields = {}
                for i, what in ((0, "z"), (1, "z_mean")):
                    e, med, mx = hold_bf16(f"{name} {what}", k[i], rb[i],
                                           rf[i], steps=min(4, acts.shape[1]))
                    fields[what] = (e, med, mx)
                if c.reward_head:
                    fields["rewards"] = hold_bf16(
                        f"{name} rewards", k[3][..., None], rb[3][..., None],
                        rf[3][..., None], **BF16_REWARDS)
                dk, rk = (k[2] - rb[2]).abs(), (rb[2] - rf[2]).abs()
                phase("bf16", f"scan {label} B={nb} (tile "
                      f"{fscan.tile_for(nb)}): kl |kernel - plain bf16| "
                      f"median {dk.median().item():.2e} max "
                      f"{dk.max().item():.2e}; |plain bf16 - f32| median "
                      f"{rk.median().item():.2e} max {rk.max().item():.2e}")
                check(dk.median().item() <= 0.1 * rk.median().item(),
                      f"{name} kl medians")
                check(dk.max().item()
                      <= BF16_STATES["max_ratio"] * rk.max().item(),
                      f"{name} kl maximum")
                key = fscan.job(c, "bfloat16", fscan.tile_for(nb))
                was = LIBS.get(lib_key(key), {})
                note(key, err=max(fields["z"][0], was.get("err", 0.0)),
                     median_ratio=max([v[1] for v in fields.values()]
                                      + [was.get("median_ratio", 0.0)]),
                     max_ratio=max([v[2] for v in fields.values()]
                                   + [was.get("max_ratio", 0.0)]))
                if nb == 256:
                    out[f"scan_bf16_{label}"] = {w: v[0]
                                                 for w, v in fields.items()}
            out[f"scan_inputs_{label}"] = (args256, acts256, eps256)

    # ---- (25) plan-bf16: mode=mcts of r4a_dense_s2 with
    # mcts_rollout_impl=pallas: leaves valued by the bf16 rollout (the JAX
    # planner's pallas path), steps in float32; phase (15)'s limits
    rounds = [0]
    real_round = sims.LearnedSimulator._round

    def counted(self, *a, **k):
        rounds[0] += 1
        return real_round(self, *a, **k)

    pcfg, _, pdev = entry.build_config(
        [f"restore={AVOID}", "mode=mcts", "mcts_episodes=16",
         "mcts_episode_len=40", "mcts_rollout_impl=pallas"])
    sims.LearnedSimulator._round = counted
    snap = library_counts()
    t = time.perf_counter()
    try:
        res = runner.run_planning(pcfg, device=pdev)
        torch.cuda.synchronize()
    finally:
        sims.LearnedSimulator._round = real_round
    plan_s = time.perf_counter() - t
    by_lib = counted_since(snap)
    sc = {k: torch.tensor(v, dtype=torch.float64)
          for k, v in res["episode_scores"].items()}
    gain = sc["model"] - sc["random"]
    gain_sem = (gain.std(unbiased=False) / len(gain) ** 0.5).item()
    share = ((sc["model"].mean() - sc["random"].mean())
             / (sc["oracle"].mean() - sc["random"].mean())).item()
    plan_B = pcfg.mcts_episodes * pcfg.mcts_frontier * acfg.num_actions
    leaf_lib = lib_key(fr.job(acfg, False, "bfloat16", fr.tile_for(plan_B)))
    step_lib = lib_key(fr.job(acfg, False, "float32", fr.tile_for(plan_B)))
    plan = {"model": res["model_mean_reward"],
            "oracle": res["oracle_mean_reward"],
            "random": res["random_mean_reward"],
            "model_minus_random": gain.mean().item(),
            "model_minus_random_sem": gain_sem, "share_closed": share,
            "seconds": plan_s, "rounds": rounds[0], "launches": by_lib}
    phase("plan-bf16", f"mcts_rollout_impl=pallas, {len(gain)} episodes x "
          f"{pcfg.mcts_episode_len} steps in {plan_s:.1f} s: mean reward "
          f"oracle {plan['oracle']:.3f} > model {plan['model']:.3f} > random "
          f"{plan['random']:.3f}; model - random {gain.mean().item():.3f} +- "
          f"{gain_sem:.3f} (paired SEM); the model closes {100 * share:.1f}% "
          f"of the oracle - random gap; {rounds[0]} rounds; launches by "
          f"library {by_lib}")
    check(plan["oracle"] > plan["model"] > plan["random"],
          f"bf16-leaf planning order oracle > model > random: {plan}")
    check(gain.mean().item() > 2 * gain_sem,
          f"bf16-leaf model gain {gain.mean().item()} <= 2 SEM {gain_sem}")
    check(by_lib.get(leaf_lib, 0) == rounds[0] > 0
          and by_lib.get(step_lib, 0) == rounds[0],
          "each round: one bf16 leaf launch (small tile), one float32 step")
    out["plan_bf16"] = plan

    # ---- (26) timing5: every rollout library at the launch shapes of its
    # paths, float32 and bf16 in turns (f32, bf16, bf16, f32), each beside
    # its plain version at that precision and its bound (bf16: operations
    # at 989 TFLOP/s; float32: three TF32 passes at 495 TFLOP/s; or bytes)
    timing = {}
    shapes = [("billiards", model, cfg, z_post, False, 16384, 92, True),
              ("billiards", model, cfg, z_post, False, 16384, 92, False),
              ("billiards", model, cfg, z_post, False, 100, 8, False),
              ("billiards", model, cfg, z_post, False, 32, 80, False),
              ("avoidance", amodel, acfg, a_post, False, 576, 10, False),
              ("avoidance", amodel, acfg, a_post, False, 576, 1, False),
              ("avoidance", amodel, acfg, a_post, False, 16384, 92, True),
              ("avoidance", amodel, acfg, a_post, False, 100, 8, False),
              ("gravity", gmodel, gcfg, g_post, True, 16384, 92, True),
              ("gravity", gmodel, gcfg, g_post, True, 32, 80, True)]
    with torch.no_grad():
        for label, mdl, c, zp, op, B, H, smp in shapes:
            d_ = mdl.params["dynamics"]
            z0 = rows(zp, B)
            acts = (torch.randint(0, c.num_actions, (B, H), device=dev,
                                  generator=agen)
                    if c.action_conditioned else None)
            g_ = torch.Generator().manual_seed(26)
            preps = {dt: mdl.prepared_for(dt) for dt in fr.DTYPES}
            ms = {dt: [] for dt in fr.DTYPES}
            for dt in ("float32", "bfloat16", "bfloat16", "float32"):
                ms[dt].append(time_cuda(
                    lambda: fr.rollout(d_, c, z0, H, smp, g_, preps[dt], acts,
                                       dt),
                    iters=50 if B < 1000 else 5, warmup=2))
            noise = (torch.randn((B, H) + tuple(z0.shape[1:]), device=dev)
                     if smp else None)
            macs = macs_per_frame(c, open_head=op and smp)
            flops = 2.0 * macs * B * H
            for dt in fr.DTYPES:
                p_ms = time_cuda(lambda: fr.rollout_states_reference(
                    d_, c, z0, H, noise, acts, dt),
                    iters=5 if B < 1000 else 2)
                k_ms = sum(ms[dt]) / len(ms[dt])
                nbytes = 4.0 * (z0.numel() * (1 + H)
                                + (2 * B * H if c.action_conditioned else 0)
                                ) + preps[dt].numel()
                b_ms, by = rollout_bound(flops, nbytes, dt)
                key = fr.job(fr.kernel_config(c, d_), op and smp, dt,
                             fr.tile_for(B))
                shape = {"model": label, "B": B, "H": H, "sample": smp}
                timing[(label, B, H, smp, dt)] = (k_ms, p_ms, b_ms, by)
                if lib_key(key) not in LIBS or "ms" not in LIBS[lib_key(key)]:
                    note(key, ms=k_ms, plain_ms=p_ms, bound=(b_ms, by),
                         shape=shape)
                phase("timing5", f"{label} {dt} B={B} H={H} "
                      f"{'sampled' if smp else 'mean'} (tile "
                      f"{fr.tile_for(B)}{', open head' if op and smp else ''}"
                      f"): kernel {k_ms:.3f} ms (runs "
                      + ", ".join(f"{x:.3f}" for x in ms[dt])
                      + f"), plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({by}),"
                      f" kernel at {100 * b_ms / k_ms:.1f}% of it, "
                      f"{flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s on {card}")
        # the bf16 and velocity-mode scan libraries at their training
        # shapes, the 16-sample tile at B=4096, and the weight packing each
        # scan_kernel call does
        for label, mdl, c in (("billiards", model, cfg),
                              ("avoidance", amodel, acfg),
                              ("gravity", gmodel, gcfg)):
            args, acts, eps = out.pop(f"scan_inputs_{label}")
            d_ = mdl.params["dynamics"]
            preps = {dt: fscan.prepare_params(d_, c, dt) for dt in fr.DTYPES}
            pack = {dt: time_cuda(lambda: fscan.prepare_params(d_, c, dt),
                                  iters=10, warmup=2) for dt in fr.DTYPES}
            phase("timing5", f"scan weight packing {label}: float32 "
                  f"{pack['float32']:.3f} ms, bfloat16 {pack['bfloat16']:.3f} "
                  f"ms on {card}")
            note(fscan.job(c, "float32"), pack_ms=pack["float32"])
            variants = [(c, "bfloat16", 256)]
            if label == "billiards":
                variants += [(c.with_overrides(**kw), "float32", 256)
                             for kw in SCAN_MODES.values()]
                variants += [(c, dt, 4096) for dt in fr.DTYPES]
            for c2, dt, B_ in variants:
                a_ = [batch_rows(a, B_) for a in args]
                ac_, e_ = batch_rows(acts, B_), batch_rows(eps, B_)
                k_ms = time_cuda(lambda: fscan.launch_kernel(
                    preps[dt], c2, *a_, e_, ac_, dt), iters=20, warmup=2)
                p_ms = time_cuda(lambda: fscan.scan_reference(
                    d_, c2, *a_, ac_, e_, dtype=dt), iters=5)
                T2 = ac_.shape[1]
                flops = 2.0 * macs_per_frame(c2) * B_ * T2
                nbytes = 4.0 * (sum(a.numel() for a in a_) + 3 * e_.numel()
                                + B_ + 2 * B_ * T2) + preps[dt].numel()
                b_ms, by = rollout_bound(flops, nbytes, dt)
                f32_ms, _ = bound(flops, nbytes)
                tile = fscan.tile_for(B_)
                note(fscan.job(c2, dt, tile), ms=k_ms, plain_ms=p_ms,
                     bound=(b_ms, by), pack_ms=pack[dt],
                     shape={"model": label, "B": B_, "T2": T2})
                timing[(f"scan {label}", B_, T2, False, dt)] = (k_ms, p_ms,
                                                                b_ms, by)
                phase("timing5", f"scan {label} {dt} "
                      f"{fscan.velocity_mode(c2)=} B={B_} T2={T2} (tile "
                      f"{tile}): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
                      f"bound {b_ms:.4f} ms ({by}; at the f32 CUDA-core peak "
                      f"{f32_ms:.4f} ms), packing {pack[dt]:.3f} ms on {card}")
    out["timing"] = {" ".join(str(x) for x in k): v
                     for k, v in timing.items()}
    out["posteriors"] = {"avoidance": a_post, "gravity": g_post}
    return out


# ---------------------------------------------------------------------------
# the sixth slice: the CLI's last modes (generate, viz, profile) and the
# SuPAIR settings spn_impl=matmul and overlap_impl=image
# ---------------------------------------------------------------------------

def sixth_slice(card: str, dev, model) -> dict:
    import os
    import tempfile

    import torch
    from stove_tpu_torch import main as entry
    from stove_tpu_torch import tree
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.models import supair as sup_lib
    from stove_tpu_torch.ops import fused_likelihood as flik
    from stove_tpu_torch.ops import fused_rollout as fr
    from stove_tpu_torch.ops import fused_scan as fscan
    from stove_tpu_torch.ops import fused_spn as fspn
    from stove_tpu_torch.train import checkpoint as ckpt_lib
    from stove_tpu_torch.train import visualize as viz
    from stove_tpu_torch.utils import profiling

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_6_")
    TEMP_DIRS.append(tmp)
    libs = {"scan": fscan, "likelihood": flik, "spn": fspn, "rollout": fr}

    def counts():
        return {k: m.launch_kernel.launches for k, m in libs.items()}

    def zero():
        for m in libs.values():
            m.launch_kernel.launches = 0

    # ---- (27) generate: both splits written through the entry point on
    # the card, read back equal to split(); one training epoch from those
    # files through the kernels (the fused likelihood evaluates both SPNs
    # in its own kernel, so the SPN kernel runs with the plain likelihood)
    data = fresh_data()
    argv = ["mode=generate", "preset=stove_billiards", "num_train=64",
            "num_test=32", data, "device=cuda"]
    t = time.perf_counter()
    check(entry.main(argv) == 0, "mode=generate")
    out["generate_s"] = time.perf_counter() - t
    gcfg, _, _ = entry.build_config(argv)
    for split in ("train", "test"):
        got = data_lib.load(data_lib.dataset_path(gcfg, split), dev)
        want = data_lib.split(gcfg, split, dev)
        check(all(a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in zip(got, want)),
              f"the {split} file equals split() on the card")
    real_split = data_lib.split

    def refuse(*a, **k):
        raise RuntimeError("the Trainer generated a corpus mode=generate "
                           "wrote")

    for i, (label, kw, want) in enumerate((
            ("scan + likelihood", ["scan_impl=pallas",
                                   "likelihood_impl=pallas",
                                   "spn_impl=pallas"],
             ("scan", "likelihood")),
            ("scan + spn", ["scan_impl=pallas", "spn_impl=pallas"],
             ("scan", "spn")))):
        zero()
        c, _, d = entry.build_config(
            ["preset=stove_billiards", "num_train=64", "num_test=32", data,
             f"run_dir={tmp}", f"run_name=from_files_{i}", "num_epochs=1",
             "steps_per_epoch=1", "supair_only_epochs=0", "eval_every=100"]
            + kw)
        data_lib.split = refuse
        try:
            t = time.perf_counter()
            tr, res = entry.run_train(c, d)
            torch.cuda.synchronize()
        finally:
            data_lib.split = real_split
        n = counts()
        phase("generate", f"train + test files written in "
              f"{out['generate_s']:.1f} s and equal to split(); one epoch "
              f"({tr.step} step at batch {c.batch_size}) from them, {label} "
              f"kernels, in {time.perf_counter() - t:.1f} s: loss "
              f"{res['loss']:.2f}; launches {n}")
        check(math.isfinite(res["loss"]) and tr.step == 1,
              f"one finite step from the files ({label})")
        check(all(n[k] > 0 for k in want), f"{label} kernels launched")

    # ---- (28) viz of the billiards and the avoidance model: the GIF and
    # the grid written under the run dir, one launch of the rollout
    # library (rollout_act's for the avoidance model); a run dir in ckpts/
    # refused
    for run, act in ((RUN, False), (AVOID, True)):
        rc = ckpt_lib.load_config(run)
        before = {f: os.path.getmtime(os.path.join(run, f))
                  for f in os.listdir(run)}
        snap = library_counts()
        t = time.perf_counter()
        check(entry.main([f"restore={run}", "mode=viz", fresh_data(),
                          f"run_dir={tmp}"]) == 0, f"mode=viz of {run}")
        secs = time.perf_counter() - t
        new = counted_since(snap)
        info = viz.read_gif_info(os.path.join(tmp, rc.run_name,
                                              "rollout_viz.gif"))
        with open(os.path.join(tmp, rc.run_name, "detect_grid.png"),
                  "rb") as f:
            png = f.read(8)
        phase("viz", f"mode=viz of {run} in {secs:.1f} s: GIF "
              f"{info['width']}x{info['height']}, {info['frames']} frames of "
              f"{info['delays_cs'][0] * 10} ms; launches {new}")
        side = 4 * rc.img_size
        check((info["frames"], info["width"], info["height"]) == (
            rc.eval_rollout_steps, 2 * side + 8, side), f"GIF of {run}")
        check(png == b"\x89PNG\r\n\x1a\n", "detect_grid.png is a PNG")
        check(len(new) == 1 and list(new.values()) == [1] and (
            "-DSTOVE_ACT=1" in next(iter(new))) == act,
            f"mode=viz of {run} launched its rollout library once")
        check(before == {f: os.path.getmtime(os.path.join(run, f))
                         for f in os.listdir(run)},
              f"nothing written in {run}")
    try:
        entry.main([f"restore={RUN}", "mode=viz", "run_dir=ckpts",
                    fresh_data()])
        refused = False
    except ValueError:
        refused = True
    check(refused, "mode=viz refuses a run dir in ckpts/")

    # ---- (29) profile at the published batch: the trace parses; the
    # device's busy share over the traced steps, the top device events;
    # the scan's, likelihood's and SPN's kernels among its CUDA events
    out["profile"] = {}
    for i, (label, kw, want) in enumerate((
            ("scan + likelihood + spn pallas",
             ["scan_impl=pallas", "likelihood_impl=pallas",
              "spn_impl=pallas"], ("scan_kernel", "likelihood_kernel")),
            ("scan + spn pallas, plain likelihood",
             ["scan_impl=pallas", "spn_impl=pallas"],
             ("scan_kernel", "spn_kernel")))):
        zero()
        argv = ["mode=profile", "preset=stove_billiards", "num_train=64",
                "num_test=32", fresh_data(), f"run_dir={tmp}",
                f"run_name=profile_{i}"] + kw
        pc = entry.build_config(argv)[0]
        t = time.perf_counter()
        check(entry.main(argv) == 0, f"mode=profile ({label})")
        secs = time.perf_counter() - t
        n = counts()
        path = os.path.join(tmp, f"profile_{i}", "trace", profiling.TRACE_FILE)
        rows, span = profiling.device_times(path)
        busy = sum(ms for ms, _ in rows.values())
        out["profile"][label] = {"span_ms": span, "busy_ms": busy,
                                 "busy_share": busy / span}
        phase("profile", f"mode=profile, {label}, B={pc.batch_size} x "
              f"{pc.window} frames: "
              f"{secs:.1f} s; trace {os.path.getsize(path) / 2 ** 20:.1f} MiB"
              f", 3 steps over {span:.1f} ms, device busy {busy:.1f} ms "
              f"({100 * busy / span:.1f}%), {len(rows)} device event names; "
              f"launches {n} on {card}")
        for name, (ms, c) in sorted(rows.items(), key=lambda kv: kv[1][0],
                                    reverse=True)[:8]:
            phase("profile", f"  {ms:8.3f} ms x{c:<4d} {name[:90]}")
        for k in want:
            check(any(k in name for name in rows),
                  f"{k} among the trace's CUDA events ({label})")

    # ---- (30) the SuPAIR settings on the card against the float64 plain
    # versions at 2048 frames (posterior boxes of rendered frames): 1e-5
    # of max(|log p|, 100), no kernel launched; the fused likelihood with
    # the image-space claim weights raises
    cfg, specs = model.cfg, model.specs.supair
    p = model.params["supair"]
    p64 = tree.map_leaves(lambda x: x.double(), p)
    B, T = cfg.batch_size, cfg.window
    gen = torch.Generator().manual_seed(30)
    ep = data_lib.generate(cfg.with_overrides(seq_len=T), B, gen, dev)
    frames = data_lib.normalize_frames(ep.frames)
    flat = frames.reshape(B * T, cfg.img_size, cfg.img_size).contiguous()
    out["supair_ms"] = {}
    with torch.no_grad():
        inf = model.infer(frames, None, generator=gen)
        boxes = torch.cat([inf.z[..., 0:2], inf.z[..., 2:4]], -1).reshape(
            B * T, cfg.num_obj, 4).contiguous()
        for label, kw in (("dense", {}), ("spn_impl=matmul",
                                          dict(spn_impl="matmul")),
                          ("overlap_impl=image", dict(overlap_impl="image")),
                          ("both", dict(spn_impl="matmul",
                                        overlap_impl="image"))):
            c = cfg.with_overrides(**kw)
            zero()
            got = sup_lib.likelihood(p, c, specs, flat, boxes)
            ref = sup_lib.likelihood(p64, c.with_overrides(spn_impl="dense"),
                                     specs, flat.double(), boxes.double())
            err = rel_err(got, ref, 100.0)
            ms = time_cuda(lambda: sup_lib.likelihood(p, c, specs, flat,
                                                      boxes), iters=5)
            out["supair_ms"][label] = ms
            phase("supair", f"plain likelihood, {label}, {B * T} frames: max "
                  f"|float32 - float64| / max(|ref|, 100) {err:.2e}; "
                  f"{ms:.3f} ms a call on {card}; launches {counts()}")
            check(err <= 1e-5, f"likelihood {label} against float64")
            check(not any(counts().values()), f"{label} launched no kernel")
        try:
            sup_lib.likelihood(p, cfg.with_overrides(
                likelihood_impl="pallas", overlap_impl="image"), specs,
                flat, boxes)
            refused = False
        except ValueError:
            refused = True
    check(refused and not any(counts().values()),
          "likelihood_impl=pallas with overlap_impl=image raises first")
    phase("supair", "likelihood_impl=pallas with overlap_impl=image raises "
          "the JAX package's ValueError before any launch")
    return out


# ---------------------------------------------------------------------------
# the seventh slice: compute_dtype=bfloat16 on every path (the rollout
# library's third precision, -DSTOVE_BF16=2) and data parallelism
# ---------------------------------------------------------------------------

DENSE = "dense_bf16"


@contextlib.contextmanager
def plain_scan_kernel():
    """Within the block, the scan dispatch (`scan_impl=pallas`) runs the
    plain loop at the kernel's precision in place of the scan kernel: the
    plain path with the kernel path's semantics (forward in the TPU
    kernel's bf16, backward the plain VJP at compute_dtype)."""
    from stove_tpu_torch.ops import fused_scan as fscan
    real = fscan.scan_kernel

    def plain(dyn_params, cfg, *args, dtype="bfloat16"):
        return fscan.scan_reference(dyn_params, cfg, *args, dtype=dtype)

    fscan.scan_kernel = plain
    try:
        yield
    finally:
        fscan.scan_kernel = real


def seventh_slice(card: str, dev, model, z_post, posts) -> dict:
    import os
    import tempfile

    import torch
    from stove_tpu_torch import main as entry
    from stove_tpu_torch import tree
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.models import stove as stove_lib
    from stove_tpu_torch.models.bundle import StoveModel
    from stove_tpu_torch.ops import fused_likelihood as flik
    from stove_tpu_torch.ops import fused_rollout as fr
    from stove_tpu_torch.ops import fused_scan as fscan
    from stove_tpu_torch.parallel import dryrun
    from stove_tpu_torch.train import checkpoint as ckpt_lib
    from stove_tpu_torch.train.trainer import Trainer

    out = {}
    cfg = model.cfg
    acfg, gcfg = ckpt_lib.load_config(AVOID), ckpt_lib.load_config(GRAV)
    amodel = StoveModel.from_run(AVOID, device=dev)
    gmodel = StoveModel.from_run(GRAV, device=dev)
    agen = torch.Generator(device=dev).manual_seed(41)
    rows = lambda zp, B: zp[torch.arange(B, device=dev)  # noqa: E731
                            % zp.shape[0]].contiguous()
    precisions = ("float32", "bfloat16", DENSE)

    # ---- (31) dense-bf16: the third precision of the rollout library
    # against its plain version ("dense_bf16", what stove.rollout computes
    # under compute_dtype=bfloat16) by hold_bf16, at the eval's shape
    # (100, 8) for billiards and gravity and the planner's (576, 10) with
    # actions and the reward head for avoidance, from posterior states;
    # the TPU kernel's bf16 variant printed beside it (how far the two bf16
    # functions are apart); each library timed in turns with the float32
    # and the kernel-variant libraries, beside the plain version and the
    # bound (its work is the bf16 row's: operations at the tensor-core
    # peak); the gravity model's open-loop head by the implied std
    with torch.no_grad():
        for label, mdl, c, zp, B, H in (
                ("billiards", model, cfg, z_post, 100, 8),
                ("avoidance", amodel, acfg, posts["avoidance"], 576, 10),
                ("gravity", gmodel, gcfg, posts["gravity"], 100, 8)):
            d_ = mdl.params["dynamics"]
            z0 = rows(zp, B)
            acts = (torch.randint(0, c.num_actions, (B, H), device=dev,
                                  generator=agen)
                    if c.action_conditioned else None)
            preps = {dt: mdl.prepared_for(dt) for dt in precisions}
            got, rew = fr.rollout(d_, c, z0, H, False, None, preps[DENSE],
                                  acts, DENSE)
            kv, _ = fr.rollout(d_, c, z0, H, False, None,
                               preps["bfloat16"], acts, "bfloat16")
            rb, rrb = fr.rollout_states_reference(d_, c, z0, H, None, acts,
                                                  DENSE)
            rf, rrf = fr.rollout_states_reference(d_, c, z0, H, None, acts,
                                                  "float32")
            torch.cuda.synchronize()
            name = f"dense-bf16 {label} B={B}"
            e, med, mx = hold_bf16(name, got, rb, rf)
            fields = {"err": e, "median_ratio": med, "max_ratio": mx}
            if c.reward_head:
                e_r, med_r, mx_r = hold_bf16(name + " rewards",
                                             rew[..., None], rrb[..., None],
                                             rrf[..., None], **BF16_REWARDS)
                fields.update(err_rewards=e_r, median_ratio_rewards=med_r,
                              max_ratio_rewards=mx_r)
            apart = [((kv[:, t] - rb[:, t]).abs().median()
                      / (rb[:, t] - rf[:, t]).abs().median()).item()
                     for t in range(4)]
            phase("dense-bf16", f"{label}: the TPU kernel's bf16 variant vs "
                  f"the dense bf16 plain version, median over the median "
                  f"bf16 - f32 distance at steps 1-4: "
                  + " ".join(f"{a:.3f}" for a in apart))
            ms = {dt: [] for dt in precisions}
            for dt in ("float32", "bfloat16", DENSE, DENSE, "bfloat16",
                       "float32"):
                ms[dt].append(time_cuda(
                    lambda: fr.rollout(d_, c, z0, H, False, None, preps[dt],
                                       acts, dt), iters=50, warmup=2))
            p_ms = time_cuda(lambda: fr.rollout_states_reference(
                d_, c, z0, H, None, acts, DENSE), iters=5)
            flops = 2.0 * macs_per_frame(c) * B * H
            nbytes = 4.0 * (z0.numel() * (1 + H)
                            + (2 * B * H if c.action_conditioned else 0)
                            ) + preps[DENSE].numel()
            b_ms, by = rollout_bound(flops, nbytes, DENSE)
            k_ms = {dt: sum(v) / len(v) for dt, v in ms.items()}
            phase("dense-bf16", f"{label} B={B} H={H} (tile "
                  f"{fr.tile_for(B)}): dense bf16 kernel {k_ms[DENSE]:.4f} "
                  f"ms, the kernel variant {k_ms['bfloat16']:.4f} ms, "
                  f"float32 {k_ms['float32']:.4f} ms (runs "
                  + "; ".join(f"{dt} " + ", ".join(f"{x:.4f}" for x in v)
                              for dt, v in ms.items())
                  + f"), plain dense {p_ms:.3f} ms, bound {b_ms:.5f} ms "
                  f"({by}) on {card}")
            key = fr.job(fr.kernel_config(c, d_), False, DENSE,
                         fr.tile_for(B))
            was = LIBS.get(lib_key(key), {})
            if "ms" in was:            # gravity's mean library is billiards'
                note(key, err=max(e, was["err"]), err_gravity=e)
            else:
                note(key, **fields, ms=k_ms[DENSE], plain_ms=p_ms,
                     bound=(b_ms, by), f32_ms=k_ms["float32"],
                     bf16_variant_ms=k_ms["bfloat16"],
                     variant_apart=apart, shape={"model": label, "B": B,
                                                 "H": H, "sample": False})
            out[f"dense_{label}"] = {"err": e, "ms": k_ms, "plain_ms": p_ms,
                                     "bound_ms": b_ms, "variant_apart": apart}
        gdyn = gmodel.params["dynamics"]
        gp = gmodel.prepared_for(DENSE)
        e_open = implied_open_std("dense-bf16", gdyn, gcfg,
                                  rows(posts["gravity"], 576), DENSE, gp,
                                  1e-2)
        # the open-head library at its path's shape: the sampled 80-step
        # eval rollout (32, 80), beside float32's (no path launches the
        # kernel variant's small-tile open-head library)
        z0 = rows(posts["gravity"], 32)
        g_ = torch.Generator().manual_seed(31)
        ms = {dt: [] for dt in ("float32", DENSE)}
        for dt in ("float32", DENSE, DENSE, "float32"):
            ms[dt].append(time_cuda(lambda: fr.rollout(
                gdyn, gcfg, z0, 80, True, g_, gmodel.prepared_for(dt), None,
                dt), iters=20, warmup=2))
        noise = torch.randn((32, 80) + tuple(z0.shape[1:]), device=dev)
        p_ms = time_cuda(lambda: fr.rollout_states_reference(
            gdyn, gcfg, z0, 80, noise, None, DENSE), iters=3)
        flops = 2.0 * macs_per_frame(gcfg, open_head=True) * 32 * 80
        b_ms, by = rollout_bound(flops, 4.0 * z0.numel() * 81 + gp.numel(),
                                 DENSE)
        k_ms = {dt: sum(v) / len(v) for dt, v in ms.items()}
        phase("dense-bf16", f"gravity open head (32, 80) sampled: dense bf16 "
              f"kernel {k_ms[DENSE]:.4f} ms, float32 {k_ms['float32']:.4f} "
              f"ms, plain dense {p_ms:.3f} ms, bound {b_ms:.5f} ms ({by}) on "
              f"{card}")
        note(fr.job(gcfg, True, DENSE, 4), err=e_open, ms=k_ms[DENSE],
             plain_ms=p_ms, bound=(b_ms, by), f32_ms=k_ms["float32"],
             shape={"model": "gravity", "B": 32, "H": 80, "sample": True})
        out["dense_gravity_open"] = {"err": e_open, "ms": k_ms,
                                     "plain_ms": p_ms, "bound_ms": b_ms}

    # ---- (32) bf16-eval: mode=eval at compute_dtype=bfloat16 of the
    # billiards and gravity models (mse_final inside BF16_EVAL_BANDS, the
    # JAX package's bf16 values on the port's corpus) and of the avoidance
    # model; each launches the dense bf16 rollout libraries and no other
    for label, run in (("billiards", RUN), ("gravity", GRAV),
                       ("avoidance", AVOID)):
        ecfg, _, edev = entry.build_config(
            [f"restore={run}", "mode=eval", "compute_dtype=bfloat16",
             fresh_data()])
        snap = library_counts()
        t = time.perf_counter()
        m = entry.run_eval(ecfg, edev)
        torch.cuda.synchronize()
        used = counted_since(snap)
        mse, lin = m["mse_final"].item(), m["linear_mse_final"].item()
        phase("bf16-eval", f"{run} compute_dtype=bfloat16: "
              f"{time.perf_counter() - t:.2f} s, mse_final {mse:.6f}, "
              f"detect_mse {m['detect_mse'].item():.6g}, linear baseline "
              f"{lin:.6f}; launches {used}")
        rolled = [k for k in used if k.startswith("rollout.cu")]
        check(rolled and all("-DSTOVE_BF16=2" in k for k in rolled),
              f"bf16 eval of {run} rolled out through the dense bf16 "
              "libraries only")
        check(math.isfinite(mse) and mse < lin, f"bf16 mse_final {mse}")
        if label in BF16_EVAL_BANDS:
            lo, hi = BF16_EVAL_BANDS[label]["mse_final"]
            check(lo <= mse <= hi, f"bf16 mse_final {mse} in [{lo}, {hi}]")
        out[f"bf16_eval_{label}"] = {k: m[k].item() for k in
                                     ("mse_final", "detect_mse")}

    # ---- (33) bf16-train: preset=stove_billiards compute_dtype=bfloat16
    # at the published widths and batch (256), the corpus cut as phase
    # (9)'s: 2 warm-up and 6 STOVE steps through the scan and likelihood
    # kernels and one evaluation (the dense bf16 rollout); finite losses,
    # the last logged STOVE loss below the first; the step against
    # float32's in turns; one batch's gradients, kernel path against the
    # plain path with its semantics (plain_scan_kernel, the plain
    # likelihood) by phase (9)'s criterion: each leaf within 1e-3 of its
    # largest entry, raised to twice the plain path's own floor (its
    # gradient's change when the frames move by 1e-5, frames_floor) where
    # that is higher; the mixture logits within 1e-6.  At bf16 that floor
    # is rounding flips: a bf16 activation that rounds the other way
    # between two sums moves a gradient that is a small difference of
    # large terms by tenths of the bf16 - f32 distance (PERF.md, PR 13);
    # each leaf's distance over the plain path's bf16 - f32 one is printed
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    TEMP_DIRS.append(tmp)
    common = ["preset=stove_billiards", "num_train=64", "num_test=32",
              "scan_impl=pallas", "likelihood_impl=pallas",
              f"run_dir={tmp}", fresh_data()]
    snap = library_counts()
    t = time.perf_counter()
    cfg_t, _, dev_t = entry.build_config(
        common + ["compute_dtype=bfloat16", "steps_per_epoch=2",
                  "num_epochs=4", "supair_only_epochs=1", "eval_every=4",
                  "run_name=bf16_train"])
    tr, res = entry.run_train(cfg_t, dev_t)
    torch.cuda.synchronize()
    used = counted_since(snap)
    logged = [json.loads(ln) for ln in open(
        os.path.join(tr.run_dir, "metrics.jsonl"))]
    losses = [r["loss"] for r in logged if r["kind"] == "train"]
    phase("bf16-train", f"from scratch at compute_dtype=bfloat16, B=256: 2 "
          f"warm-up + 6 STOVE steps in {time.perf_counter() - t:.1f} s; "
          f"logged losses {losses}; mse_final {res['mse_final']:.4f}; "
          f"launches {used}")
    check(len(losses) == 4 and all(math.isfinite(x) for x in losses),
          f"finite bf16 losses {losses}")
    check(losses[-1] < losses[1], f"the bf16 STOVE loss falls: {losses}")
    check(any(k.startswith("scan.cu") for k in used)
          and any(k.startswith("likelihood.cu") for k in used)
          and any("-DSTOVE_BF16=2" in k for k in used),
          "bf16 training launched the scan, likelihood and dense rollout")

    def step_ms(trainer, n=5):
        b = data_lib.sample_windows(trainer.train_ep, trainer.cfg,
                                    trainer.data_gen, trainer.cfg.batch_size)
        trainer.train_step(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.train_step(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    trainers = {}
    for dt in ("float32", "bfloat16"):
        c, _, d = entry.build_config(common + [f"compute_dtype={dt}",
                                               "nolog=true"])
        trainers[dt] = Trainer(c, device=d)
    steps = {}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        steps.setdefault(dt, []).append(step_ms(trainers[dt]))
    phase("bf16-train", "STOVE step through the kernels at B=256: float32 "
          f"{min(steps['float32']):.1f} ms, bfloat16 "
          f"{min(steps['bfloat16']):.1f} ms (runs {steps}) on {card}")
    out["step_ms"] = {dt: min(v) for dt, v in steps.items()}
    out["bf16_train_losses"] = losses

    B, T = cfg_t.batch_size, cfg_t.window
    batch = data_lib.sample_windows(tr.train_ep, cfg_t,
                                    torch.Generator(device=dev).manual_seed(3),
                                    B)
    noise = stove_lib.draw_elbo_noise(cfg_t, B, T,
                                      torch.Generator().manual_seed(4), dev)
    leaves = tree.leaves(tr.params)

    def grads(c):
        loss = stove_lib.elbo(tr.params, c, tr.model.specs, batch["frames"],
                              None, None, noise).loss
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    before = fscan.launch_kernel.launches, flik.launch_kernel.launches
    g_k = grads(cfg_t)
    check(fscan.launch_kernel.launches > before[0]
          and flik.launch_kernel.launches > before[1],
          "the kernel path's gradient launched the scan and likelihood")
    plain_cfg = cfg_t.with_overrides(likelihood_impl="xla")
    paths = [p for p, _ in tree.paths(tr.params)]
    logits = lambda path: "logits" in str(path[-1])  # noqa: E731
    with plain_scan_kernel():
        g_p = grads(plain_cfg)
        floor = frames_floor(grads, batch, plain_cfg, paths, g_p, logits,
                             dev)
    g_f = grads(cfg_t.with_overrides(compute_dtype="float32",
                                     scan_impl="xla", likelihood_impl="xla"))
    lim_rel = max(1e-3, 2 * floor)
    rows_g = []
    for path, a, b, f in zip(paths, g_k, g_p, g_f):
        if b is None:
            check(a is None, f"gradient presence {path}")
            continue
        scale = 1.0 if logits(path) else b.abs().max().item() or 1.0
        lim = 1e-6 if logits(path) else lim_rel
        d = (a - b).abs().max().item()
        rows_g.append((d / scale / lim,
                       d / max((b - f).abs().max().item(), 1e-30),
                       tree.keystr(path)))
    rows_g.sort(reverse=True)
    for r in rows_g[:4]:
        phase("bf16-train", f"gradient {r[2]}: max |kernel - plain| "
              f"{r[0]:.3f} of its limit, {r[1]:.3f}x the plain path's "
              f"bf16 - f32 distance")
    ratios = sorted(r[1] for r in rows_g)
    phase("bf16-train", f"gradients at bf16 on one batch, {len(rows_g)} "
          f"leaves: the plain path's own floor (frames moved by 1e-5) "
          f"{floor:.2e} of a leaf's largest entry, limit {lim_rel:.2e}; "
          f"worst share of the limit {rows_g[0][0]:.3f}; kernel vs plain "
          f"over the plain path's bf16 - f32 distance: median "
          f"{ratios[len(ratios) // 2]:.3f}, max {ratios[-1]:.3f}")
    check(rows_g[0][0] <= 1.0, "bf16 kernel-path gradients")
    out["grad"] = {"floor": floor, "worst_share": rows_g[0][0],
                   "bf16_ratio_median": ratios[len(ratios) // 2],
                   "bf16_ratio_max": ratios[-1]}

    # ---- (34) parallel: data parallelism on the one card.  NCCL at world
    # size 1 (the step in the group equals the step without one, bit for
    # bit); two ranks over gloo sharing the card if gloo takes CUDA
    # tensors (NCCL refuses two ranks on one device): the sharded loss
    # equals the one-device loss to rel 1e-4; mesh_shape=(2,) in one
    # process raises
    t = time.perf_counter()
    r1 = dryrun.dryrun_multichip(1, device="cuda")
    phase("parallel", f"NCCL world 1: loss {r1['loss']:.4f}, one-device "
          f"{r1['loss_1dev']:.4f}, bit for bit {r1['bitwise']} "
          f"({time.perf_counter() - t:.1f} s)")
    check(r1["bitwise"], "the NCCL world-1 step equals the plain step")
    refused = dryrun.backend_refuses("cuda", "gloo")
    out["parallel"] = {"nccl_world_1": r1, "gloo_cuda_refused": refused}
    if refused is None:
        t = time.perf_counter()
        r2 = dryrun.dryrun_multichip(2, device="cuda", backend="gloo")
        phase("parallel", f"gloo, two ranks on the card: loss "
              f"{r2['loss']:.4f}, one-device {r2['loss_1dev']:.4f}, rel "
              f"{r2['rel']:.2e} ({time.perf_counter() - t:.1f} s)")
        check(r2["rel"] < 1e-4, "the two-rank loss equals one device's")
        out["parallel"]["gloo_cuda_2"] = r2
    else:
        phase("parallel", f"gloo refuses CUDA tensors on this machine: "
              f"{refused}")
    try:
        Trainer(cfg.with_overrides(mesh_shape=(2,), nolog=True), device=dev)
        raised = ""
    except ValueError as e:
        raised = str(e)
    phase("parallel", f"mesh_shape=(2,) in one process: {raised}")
    check("torch.distributed.run" in raised, "a mesh above the world raises")
    return out


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        import shutil
        for d in TEMP_DIRS:
            shutil.rmtree(d, ignore_errors=True)
    sys.exit(rc)
