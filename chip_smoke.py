"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100: `python3 chip_smoke.py`.

Builds the port's four CUDA kernel sources from the checkout (one nvcc per
library, all at once: the rollout source for the action-free model, the
action-conditioned one, and each of them with the open-loop std head; the
scan source per velocity mode and with actions and the reward head),
holds each kernel against its plain PyTorch version on the card, runs
`mode=eval` of the trained 3-ball billiards model (ckpts/r4rp_bill_s32,
full width) and STOVE training at full width through the port's entry
points, resumes the trained run through the kernels, times the kernels
and the training step, then runs `mode=eval` and MCTS planning
(`mode=mcts`) of the trained action-conditioned avoidance model
(ckpts/r4a_dense_s2, full width) through the action-conditioned rollout
kernel, trains that model from scratch and resumes it through the scan
kernel with actions and the reward head, and runs `mode=eval` and resumed
training of the trained gravity model (ckpts/r4rp_grav_s32, full width)
through the rollout kernel's open-loop std head.  One line per phase,
with the seconds since start:

  (0) device      card name and power limit (nvidia-smi); TF32 off
  (1) build       nvcc of every kernel library: seconds, registers, smem
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
                  allows): warm-up + 10 runs timed with CUDA events
  (6) spn         SPN kernel vs plain on one training step's object patches
                  (6144, 100) and frames (2048, 1024), trained weights and
                  region graphs: |err| <= 1e-5 * max(|log p|, 100)
  (7) likelihood  likelihood kernel vs plain on 2048 rendered frames with
                  posterior boxes, the same limit
  (8) scan        scan kernel vs plain at B=256, T2=6, trained weights,
                  pre-drawn eps: z, z_mean within 1e-4 of the float32 and
                  float64 plain versions, kl within 2e-5 relative; the other
                  two velocity_obs modes with random weights at B=64 (2e-4)
  (9) train       from scratch at full width through the entry point: 2
                  warm-up + 3 STOVE steps with the scan and likelihood
                  kernels, then 1 + 1 with the SPN kernel; losses finite,
                  launches > 0; one batch's gradients kernel vs plain path,
                  leaf by leaf, within 1e-3 of each leaf's largest entry
                  (mixture logits: 1e-6 absolute, their scale being 1)
  (10) resume     restore=ckpts/r4rp_bill_s32 mode=train num_epochs=361
                  through the kernels: 20 steps, mean elbo in [1197, 1248],
                  kl in [-10.5, -7.5] (the JAX package's own float32 value
                  on these weights, see there), overshoot < 0.02, nothing
                  written under ckpts/
  (11) timing     STOVE and warm-up step, kernel vs plain path (host clock,
                  synchronised), and each kernel vs its plain version at the
                  training shapes (CUDA events), beside its bound
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
                  window (B=256, T2=14)
  (18) avoid-train preset=stove_avoidance from scratch at full width (only
                  the corpus cut): 2 warm-up + 3 STOVE steps through the
                  scan and likelihood kernels, every loss finite (the reward
                  and overshoot-reward losses too), launches > 0; one
                  batch's gradients kernel vs plain path to phase (9)'s
                  limits, the reward heads' and action rows' nonzero
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

Any failed check raises, so the script exits non-zero and prints no result.
The last three lines are the kernel table (JSON), the card's name and power
limit, and the result JSON.  Writes nothing into the repository but the
git-ignored build directory; runs write to a temporary directory.  Imports
nothing of JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
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
BUDGET_S = 240.0          # start the optional B=65536 timing only before this


def phase(name: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] ({name}) {msg}", flush=True)


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
    jobs = [fr.job(cfg), fr.job(acfg), fscan.job(cfg),
            fscan.job(cfg.with_overrides(velocity_obs_full_std=False)),
            fscan.job(cfg.with_overrides(velocity_obs="filtered")),
            fspn.job(sspecs.obj), fspn.job(sspecs.bg),
            flik.job(cfg, sspecs), fscan.job(acfg), fscan.job(gcfg),
            fr.job(gcfg, True), fr.job(ocfg, True)]
    t = time.perf_counter()
    paths = _build.build(jobs)
    phase("build", f"{len(jobs)} libraries in {time.perf_counter() - t:.1f} s")
    for (src, defines), path in zip(jobs, paths):
        secs = _build.BUILDS.get(str(path), (0.0, ""))[0]
        phase("build", f"{src} {' '.join(defines)}: nvcc {secs:.1f} s; "
              f"{_build.ptxas_report(path) or 'already built'}")
    lib = fr.load(cfg)
    phase("build", f"smem per block: rollout {lib.stove_rollout_smem_bytes()} "
          f"B (with actions and reward head "
          f"{fr.load(acfg).stove_rollout_smem_bytes()}"
          f" B), scan {fscan.load(cfg).stove_scan_smem_bytes()} B, spn obj "
          f"{fspn.load(sspecs.obj).stove_spn_smem_bytes()} B / bg "
          f"{fspn.load(sspecs.bg).stove_spn_smem_bytes()} B, likelihood "
          f"{flik.load(cfg, sspecs).stove_lik_smem_bytes()} B; scan with "
          f"actions and reward head {fscan.load(acfg).stove_scan_smem_bytes()}"
          f" B, rollout with the open-loop head "
          f"{fr.load(gcfg, True).stove_rollout_smem_bytes()} B (with actions"
          f" and reward head too "
          f"{fr.load(ocfg, True).stove_rollout_smem_bytes()} B)")

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
    argv = [f"restore={RUN}", "mode=eval"]
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
        ms = time_cuda(lambda: fr.rollout_states(
            dyn, cfg, z0, 92, True, gen5, model.prepared), iters=10)
        times[B] = ms
        phase("throughput", f"sampled kernel B={B} H=92: {ms:.3f} ms/call, "
              f"{B * 92 / ms * 1e3:,.0f} frames/s on {card}")
    B = 16384
    z0 = z_post
    noise = torch.randn((B, 92) + tuple(z0.shape[1:]), device=dev)
    plain_ms = time_cuda(lambda: fr.rollout_states_reference(
        dyn, cfg, z0, 92, noise), iters=3)
    flops = 2.0 * macs * B * 92
    nbytes = 4.0 * (z0.numel() * (1 + 92) + model.prepared.numel())
    bound_ms = max(flops / 67e12, nbytes / 3.35e12) * 1e3
    phase("throughput", f"plain version B={B} H=92: {plain_ms:.3f} ms/call; "
          f"{macs} MACs/frame, bound {bound_ms:.3f} ms (f32 67 TFLOP/s), "
          f"bf16 tensor-core bound {flops / 989e12 * 1e3:.3f} ms; kernel at "
          f"{flops / (times[B] * 1e-3) / 1e12:.2f} TFLOP/s")


    act = avoidance_slice(card, dev)
    rollout_entry = {
        "name": "rollout_states", "route": "cuda",
        "source": "stove_tpu_torch/csrc/rollout.cu",
        "replaces": "stove_tpu/ops/pallas_rollout.py:433",
        "launches": launches, "max_abs_err": max_err,
        "ms": times[B], "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations", "library_ms": None,
        "shape": {"B": B, "H": 92, "sample": True},
        "ms_b65536": times.get(65536)}

    tr = training_slice(card, dev, cfg, model)
    n = tr["launches"]
    kernels = [rollout_entry, act["entry"]]
    for name, src, rep, key, err, launch, shape in (
            ("scan_fused", "stove_tpu_torch/csrc/scan.cu",
             "stove_tpu/ops/pallas_scan.py:214", "scan", tr["scan_err"],
             n["scan"], {"B": 256, "T2": 6}),
            ("spn_log_prob_fused", "stove_tpu_torch/csrc/spn.cu",
             "stove_tpu/ops/pallas_spn.py:204", "spn", tr["spn_err"],
             n["spn"], {"obj": [6144, 100], "bg": [2048, 1024]}),
            ("likelihood_fused", "stove_tpu_torch/csrc/likelihood.cu",
             "stove_tpu/ops/pallas_likelihood.py:233", "likelihood",
             tr["lik_err"], n["likelihood"], {"frames": 2048, "objects": 3})):
        ms, by = tr[{"scan": "scan_bound", "spn": "spn_bound",
                     "likelihood": "lik_bound"}[key]]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launch, "max_abs_err": err, "ms": tr[key + "_ms"],
            "plain_ms": tr[key + "_plain_ms"], "bound_ms": ms,
            "bound_by": by, "library_ms": None, "shape": shape})
    four = fourth_slice(card, dev)
    ti = four["timing"]
    for name, src, rep, key, err, launch, shape in (
            ("scan_fused[actions, reward head]",
             "stove_tpu_torch/csrc/scan.cu", "stove_tpu/ops/pallas_scan.py:214",
             "scan_avoid", four["scan_act_err"],
             four["launches_avoid_train"]["scan"]
             + four["launches_avoid_resume"]["scan"], {"B": 256, "T2": 10}),
            ("scan_fused[gravity window]", "stove_tpu_torch/csrc/scan.cu",
             "stove_tpu/ops/pallas_scan.py:214", "scan_grav",
             four["scan_grav_err"], four["launches_grav_train"]["scan"],
             {"B": 256, "T2": 14}),
            ("rollout_states[open-loop std head]",
             "stove_tpu_torch/csrc/rollout.cu",
             "stove_tpu/ops/pallas_rollout.py:433", "open",
             four["open_std_err"], four["open_launches_eval"]
             + four["open_launches_train"],
             {"B": 16384, "H": 92, "sample": True})):
        k_ms, p_ms, b_ms, by = ti[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launch, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "shape": shape})
    kernels[5]["max_abs_err_rewards"] = four["scan_act_rew_err"]
    kernels[1]["open_head_variant"] = {
        "defines": "-DSTOVE_ACT=1 -DSTOVE_NA=9 -DSTOVE_REW=1 -DSTOVE_OPEN=1",
        "launches": 1, "main_path": None, "shape": {"B": 576, "H": 10,
                                                     "sample": True},
        "max_abs_err_rewards": four["act_open_rew_err"]}
    kernels[4]["launches_by_path"] = {
        "avoid_train": four["launches_avoid_train"]["likelihood"],
        "avoid_resume": four["launches_avoid_resume"]["likelihood"],
        "grav_train": four["launches_grav_train"]["likelihood"]}
    print(json.dumps({"kernels": kernels, "train_step_ms": {
        k: tr[f"step_{k}"] for k in ("kernels", "plain")},
        "resume": tr["resume"], "avoidance_eval": act["eval"],
        "planning": act["plan"], "avoidance_resume": four["avoid_resume"],
        "gravity_eval": four["grav_eval"],
        "gravity_eval_sampled": four["grav_eval_sampled"],
        "gravity_resume": four["grav_resume"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def plain_rollout(dyn_params, c, z0, horizon, sample=True, generator=None,
                  prepared=None, actions=None):
    """fused_rollout.rollout's signature on the plain version, on the card."""
    import torch
    from stove_tpu_torch.ops import fused_rollout as fr
    noise = None
    if sample:
        noise = torch.randn((z0.shape[0], horizon) + tuple(z0.shape[1:]),
                            generator=generator, dtype=z0.dtype).to(z0)
    return fr.rollout_states_reference(dyn_params, c, z0, horizon, noise,
                                       actions)


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
# the training slice: SPN, likelihood and scan kernels, training, resume
# ---------------------------------------------------------------------------

F32_PEAK, HBM_RATE = 67e12, 3.35e12        # H100 SXM, f32 CUDA cores, HBM3


def bound(flops: float, nbytes: float):
    """(ms, "operations" | "bytes"): the least time for the work."""
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def spn_flops(spec) -> float:
    """Operations of one sample's SPN as the kernel does them: 8 per leaf
    term (sub, div, mul, add, mul, sub, mul, add); per level and (r, p):
    2(c-1) max, 2c sub+exp, then per sum node c(2c) multiply-adds and c
    more, log and add; root: 4 per term."""
    R, V, I, S, D = (spec.num_reps, spec.num_vars, spec.num_leaves,
                     spec.num_sums, spec.depth)
    ops, c = 8.0 * R * V * I, I
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


def lik_flops(cfg, specs) -> float:
    """Operations per frame: background weights (O edge pairs of ~12 ops
    and a max per pixel), per object P² bilinear samples (~20 ops) and
    claim weights (o edge pairs), the object SPN O times and the
    background SPN once."""
    O, P, V = cfg.num_obj, cfg.patch_size, cfg.img_size ** 2
    claims = sum(o for o in range(O)) * P * P * 26.0
    return (V * O * 26.0 + O * P * P * 20.0 + claims
            + O * spn_flops(specs.obj) + spn_flops(specs.bg))


def profile_step(trainer, batch_size: int, top: int = 12):
    """torch.profiler over one STOVE step: device time by kernel name, the
    device's busy time against the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from stove_tpu_torch.envs import data as data_lib

    b = data_lib.sample_windows(trainer.train_ep, trainer.cfg,
                                trainer.data_gen, batch_size)
    trainer.train_step(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]      # kernels, not aten ops
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    out = [f"profile of one kernel-path STOVE step: wall {wall:.1f} ms, "
           f"device busy {busy:.1f} ms ({100 * busy / wall:.0f}%), "
           f"{len(rows)} kernel names"]
    for e in rows[:top]:
        out.append(f"  {e.self_device_time_total / 1e3:8.3f} ms "
                   f"x{e.count:<4d} {e.key[:90]}")
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
    # limit is |err| <= 1e-5 * max(|log p|, 100).
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
            got = fspn.launch_kernel(spec, fspn.prepare(spec, prm), x, w)
            ref = spn_lib.spn_log_prob(spec, prm, x, w)
            ref64 = spn_lib.spn_log_prob(
                spec, {k: v.double() for k, v in prm.items()}, x.double(),
                w.double())
            torch.cuda.synchronize()
            e32, e64 = rel_err(got, ref, 100.0), rel_err(got, ref64, 100.0)
            spn_err = max(spn_err, (got - ref).abs().max().item())
            phase("spn", f"{name} SPN x {tuple(x.shape)}: max |kernel - "
                  f"plain| {(got - ref).abs().max().item():.3e} (rel "
                  f"{e32:.2e}), vs float64 plain rel {e64:.2e}, float32 "
                  f"plain vs float64 rel {rel_err(ref, ref64, 100.0):.2e}; "
                  f"log p in [{ref.min().item():.1f}, {ref.max().item():.1f}]")
            check(e32 <= 1e-5 and e64 <= 1e-5, f"{name} SPN kernel error")
    out["spn_err"] = spn_err

    # ---- (7) likelihood: the kernel vs the plain version on 2048 rendered
    # frames with their posterior boxes; limit as in (6)
    with torch.no_grad():
        got = flik.launch_kernel(cfg, specs,
                                 fspn.prepare(specs.obj, sparams["obj_spn"]),
                                 fspn.prepare(specs.bg, sparams["bg_spn"]),
                                 flat, boxes)
        ref = flik.likelihood_reference(cfg, specs, sparams, flat, boxes)
        torch.cuda.synchronize()
        e32 = rel_err(got, ref, 100.0)
        out["lik_err"] = (got - ref).abs().max().item()
        phase("likelihood", f"{B * T} frames: max |kernel - plain| "
              f"{out['lik_err']:.3e} (rel {e32:.2e}); log p in "
              f"[{ref.min().item():.1f}, {ref.max().item():.1f}]")
        check(e32 <= 1e-5, "likelihood kernel error")

    # ---- (8) scan: the kernel vs the plain version at B=256, T2=6 on the
    # trained weights with pre-drawn eps.  Two float32 evaluations that sum
    # in different orders drift apart as the map amplifies rounding step by
    # step (phase (2): 8e-5 after 8 rollout steps); the limit on z and
    # z_mean is 1e-4 against the plain version in float32 and in float64.
    # The random-weight modes (a nonzero output layer, B=64) amplify faster
    # at steps 5-6 than the trained map (~2.5x a step, the by-step line):
    # 2e-4 there.  kl (a sum of ~800 log densities) to 2e-5 relative.
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
        for label, c2, dyn, nb, lim in (
                ("trained, velocity_obs_full_std", cfg,
                 model.params["dynamics"], B, 1e-4),
                ("random, velocity_obs_full_std=False",
                 cfg.with_overrides(velocity_obs_full_std=False), None, 64,
                 2e-4),
                ("random, velocity_obs=filtered",
                 cfg.with_overrides(velocity_obs="filtered"), None, 64,
                 2e-4)):
            if dyn is None:
                dyn = dyn_lib.init_params(c2, torch.Generator().manual_seed(8),
                                          dev)
                dyn["out"][-1]["w"] = 0.05 * torch.randn(
                    dyn["out"][-1]["w"].shape,
                    generator=torch.Generator().manual_seed(9)).to(dev)
            args = [a[:nb] for a in scan_args]
            z, zm, kl, _ = fscan.launch_kernel(fr.pack_params(dyn, c2), c2,
                                            *args, eps[:nb])
            rz, rzm, rkl, _ = fscan.scan_reference(dyn, c2, *args, acts[:nb],
                                                   eps[:nb])
            d64 = ckpt_lib.params_from_numpy(dyn, dev, torch.float64)
            qz, qzm, qkl, _ = fscan.scan_reference(
                d64, c2, *[a.double() for a in args], acts[:nb],
                eps[:nb].double())
            torch.cuda.synchronize()
            ez = max((z - rz).abs().max().item(), (zm - rzm).abs().max().item())
            ez64 = max((z.double() - qz).abs().max().item(),
                       (zm.double() - qzm).abs().max().item())
            own64 = max((rz.double() - qz).abs().max().item(),
                        (rzm.double() - qzm).abs().max().item())
            ekl = ((kl - rkl).abs() / rkl.abs().clamp_min(1.0)).max().item()
            by_step = (z - rz).abs().amax(dim=(0, 2, 3))
            phase("scan", f"{label}, B={nb}: max |kernel - plain| z, z_mean "
                  f"{ez:.3e} (float64 plain: kernel {ez64:.3e}, float32 "
                  f"plain {own64:.3e}); kl rel {ekl:.2e} (kl mean "
                  f"{rkl.mean().item():.3f}); by step " + " ".join(
                      f"{e:.1e}" for e in by_step.tolist()))
            check(ez <= lim and ez64 <= lim, f"scan kernel z error ({label})")
            check(ekl <= 2e-5, f"scan kernel kl error ({label})")
            worst[label] = ez
    out["scan_err"] = worst["trained, velocity_obs_full_std"]

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
              "steps_per_epoch=1", f"run_dir={tmp}"]
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

    # one batch, the same noise: kernel-path gradients vs plain-path ones.
    # The backward is the plain version's VJP at the kernel forward's
    # inputs, which differ from the plain forward's by ~1e-5 (phase 8).
    # The gradient of a bilinear glimpse jumps where a sample point crosses
    # a pixel centre, so the few samples that cross between the two
    # forwards change the box gradients, and through them the dynamics',
    # in steps (3.2e-4 of a leaf's largest entry in one run, 2e-6 in
    # another): each leaf is held to 1e-3 of its largest entry.  A mixture
    # logit's gradient is a mean over the B*T frames of (responsibility -
    # weight), in [-1, 1] whatever its size (saturated mixtures give
    # ~1e-8), so the sum and root logits are held to 1e-6 of that scale.
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
    g_k = grads(cfg_a)
    g_p = grads(plain_cfg)
    g_p2 = grads(plain_cfg)
    g_s = grads(plain_cfg.with_overrides(spn_impl="pallas"))
    rows_g = []
    for (path, _), a, b, b2, s in zip(tree.paths(tr.params), g_k, g_p, g_p2,
                                      g_s):
        if b is None:
            check(a is None and s is None, f"gradient presence {path}")
            continue
        scale = (1.0 if "logits" in str(path[-1])
                 else b.abs().max().item() or 1.0)
        lim = 1e-6 if "logits" in str(path[-1]) else 1e-3
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
    phase("train", f"gradients on one batch, same noise, {len(rows_g)} "
          f"leaves: worst share of the limit, scan+likelihood kernels "
          f"{worst_g:.2e}, spn kernel {worst_s:.2e}")
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
         "likelihood_impl=pallas", "num_epochs=361", f"run_dir={tmp}"])
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
        c, _, d = entry.build_config(common + kw + ["nolog=true"])
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

    # each kernel alone at the training shapes vs its plain version
    with torch.no_grad():
        packed = fr.pack_params(model.params["dynamics"], cfg)
        prep_o = fspn.prepare(specs.obj, sparams["obj_spn"])
        prep_b = fspn.prepare(specs.bg, sparams["bg_spn"])
        (so, po, xo, wo), (sb, pb, xb, wb) = spn_in["obj"], spn_in["bg"]
        kern = {
            "spn": (lambda: (fspn.launch_kernel(so, prep_o, xo, wo),
                             fspn.launch_kernel(sb, prep_b, xb, wb)),
                    lambda: (spn_lib.spn_log_prob(so, po, xo, wo),
                             spn_lib.spn_log_prob(sb, pb, xb, wb))),
            "likelihood": (lambda: flik.launch_kernel(cfg, specs, prep_o,
                                                      prep_b, flat, boxes),
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
                        + 2 * eps.numel() + B
                        + packed.numel())
    out["scan_bound"] = bound(2.0 * macs, scan_bytes)
    n_obj, n_bg = xo.shape[0], xb.shape[0]
    out["spn_bound"] = bound(
        n_obj * spn_flops(so) + n_bg * spn_flops(sb),
        4.0 * (2 * xo.numel() + 2 * xb.numel() + n_obj + n_bg)
        + spn_param_bytes(so) + spn_param_bytes(sb))
    out["lik_bound"] = bound(
        flat.shape[0] * lik_flops(cfg, specs),
        4.0 * (flat.numel() + boxes.numel() + flat.shape[0])
        + spn_param_bytes(so) + spn_param_bytes(sb))
    for name, key in (("spn", "spn_bound"), ("likelihood", "lik_bound"),
                      ("scan", "scan_bound")):
        ms, by = out[key]
        phase("timing", f"{name} kernel {out[name + '_ms']:.3f} ms, plain "
              f"{out[name + '_plain_ms']:.3f} ms, bound {ms:.4f} ms "
              f"({by}) on {card}")
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
    ecfg, _, edev = entry.build_config([f"restore={AVOID}", "mode=eval"])
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
        nbytes = 4.0 * (z0.numel() * (1 + H) + B * H * 2 + prep.numel())
        b_ms, by = bound(flops, nbytes)
        times[(B, H)] = (k_ms, p_ms, b_ms, by)
        phase("act-timing", f"B={B} H={H} {'sampled' if smp else 'mean'}: "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} "
              f"ms ({by}; {macs} MACs/frame), kernel at {100 * b_ms / k_ms:.1f}"
              f"% of the bound, {flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s, "
              f"{(B + 15) // 16} blocks on {card}")
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
    """Count the rollout launches by (B, H, sampled, open-loop head) while
    the block runs.  The wrapper stands in for fused_rollout.launch_kernel;
    the launch counter that launch_kernel increments is the wrapper's while
    it stands, and is handed back after."""
    from stove_tpu_torch.ops import fused_rollout as fr
    real = fr.launch_kernel

    def recorded(prepared, c, z0, horizon, sample, seed, actions=None,
                 open_head=False):
        key = (z0.shape[0], horizon, bool(sample), bool(open_head))
        shapes[key] = shapes.get(key, 0) + 1
        return real(prepared, c, z0, horizon, sample, seed, actions,
                    open_head)
    recorded.launches = real.launches
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
    z, zm, kl, rew = fscan.launch_kernel(fr.pack_params(dyn, cfg), cfg, *args,
                                         eps, acts)
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
    # (2)'s float64 criterion (printed in the by-step line)
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

    # ---- (18) avoid-train: preset=stove_avoidance from scratch at full
    # width (only the corpus cut), 2 warm-up + 3 STOVE steps through the
    # scan and likelihood kernels; every loss finite, reward terms too
    common = ["preset=stove_avoidance", "num_train=64", "num_test=32",
              "steps_per_epoch=1", f"run_dir={tmp}"]
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
    # ones, leaf by leaf, to phase (9)'s limits, raised to the plain path's
    # own noise floor where that is higher; the reward heads' and the
    # action rows' gradients must be nonzero.  The floor: the plain path's
    # gradient moves when its forward moves by what float32 rounding moves
    # it (a bilinear glimpse's gradient jumps where a sample point crosses
    # a pixel centre, and 12-frame windows of 256 sequences hold ~10^6
    # sample points).  It is measured here as the largest change, over the
    # leaves, of the plain path's gradient when the frames move by 1e-5
    # (the scan kernel's own distance from the plain version, phase (17));
    # on the card it was 1.7e-3 of a leaf's largest entry for 1e-6 and
    # 2.9e-3 for 1e-5, above phase (9)'s 1e-3, and the plain path run twice
    # gave 1.4e-6.  The reward attention's last bias shifts every object's
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
    g_k = grads(cfg_a)
    g_p = grads(plain_a)
    clean = batch["frames"]
    batch["frames"] = clean + 1e-5 * torch.randn(
        clean.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(5))
    g_q = grads(plain_a)
    batch["frames"] = clean
    rows_g, named, floor = [], {}, 0.0
    for (path, _), a, b, q in zip(tree.paths(tr_a.params), g_k, g_p, g_q):
        key = tree.keystr(path)
        named[key] = a
        if b is None:
            check(a is None, f"gradient presence {key}")
            continue
        absolute = ("logits" in str(path[-1])
                    or key.endswith("['reward_att'][2]['b']"))
        scale = 1.0 if absolute else (b.abs().max().item() or 1.0)
        if not absolute:
            floor = max(floor, (q - b).abs().max().item() / scale)
        rows_g.append(((a - b).abs().max().item() / scale, scale, key,
                       absolute))
    lim_rel = max(1e-3, floor)
    rows_g = sorted(((d / (1e-6 if ab else lim_rel), sc, k)
                     for d, sc, k, ab in rows_g), reverse=True)
    for r in rows_g[:3]:
        phase("avoid-train", f"gradient {r[2]}: max |kernel - plain| / scale "
              f"{r[0]:.2e} of its limit; scale {r[1]:.3e}")
    phase("avoid-train", f"the plain path's own floor (frames moved by "
          f"1e-5): {floor:.2e} of a leaf's largest entry; limit "
          f"{lim_rel:.2e}")
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
         f"run_dir={tmp}"])
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
    check(oprep.numel() == fr.param_count(ocfg, True) > fr.param_count(acfg),
          "the open head's packed buffer")
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
    zero()

    # ---- (21) grav-eval: mode=eval of r4rp_grav_s32 through the entry
    # point, launches by (B, H, sampled, open head); then with the plain
    # rollout; the JAX band; the sampled metrics beside 8 plain draws
    ecfg, _, edev = entry.build_config([f"restore={GRAV}", "mode=eval"])
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
         "eval_every=1", f"run_dir={tmp}"])
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
                        + 2 * B_ * T2 + packed.numel())
        return bound(flops, nbytes)

    timing = {}
    with torch.no_grad():
        for label, mdl, c, args, acts, eps in (
                ("avoid", amodel, acfg, a_args, a_acts, a_eps),
                ("grav", gmodel, gcfg, g_args, g_acts, g_eps)):
            dyn = mdl.params["dynamics"]
            packed = fr.pack_params(dyn, c)
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
        nbytes = 4.0 * (z0.numel() * 93 + gprep.numel())
        b_ms, by = bound(flops, nbytes)
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


if __name__ == "__main__":
    sys.exit(main())
