"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100: `python3 chip_smoke.py`.

Builds the port's four CUDA kernel sources from the checkout (one nvcc per
library, all at once; the rollout source twice, for the action-free and
the action-conditioned model), holds each kernel against its plain
PyTorch version on the card, runs `mode=eval` of the trained 3-ball
billiards model (ckpts/r4rp_bill_s32, full width) and STOVE training at
full width through the port's entry points, resumes the trained run
through the kernels, times the kernels and the training step, then runs
`mode=eval` and MCTS planning (`mode=mcts`) of the trained
action-conditioned avoidance model (ckpts/r4a_dense_s2, full width)
through the action-conditioned rollout kernel.  One line per phase, with
the seconds since start:

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
# mode=eval of AVOID on the card must land here: the range of the JAX
# package's float32 metrics on the port's test corpus over the posterior
# draws of jax.random.key(0..31), widened by half its width on each side
# (tests/test_torch_avoidance.py::test_eval_band_from_the_jax_package
# recomputes the draws and checks this band on the CPU; the port equals
# the JAX package under the same draw, test_eval_matches_jax_on_its_noise)
AVOID_BAND = {"mse_final": (0.0086, 0.0129), "detect_mse": (2.14e-4, 2.37e-4),
              "reward_auc": (0.861, 0.914)}
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


def macs_per_frame(cfg) -> int:
    """Multiply-adds of one dynamics step for one sample (all objects), as
    the kernel computes them: embed, self, receiver|sender, the relational
    MLP over O(O-1) ordered pairs, the output MLP (padded last layer
    counted at its true width); with a reward head, its two heads per
    object: [s ; r] -> h, h -> h, h -> 1 (the gap and distance rows are
    elementwise)."""
    O, h, D, cl = cfg.num_obj, cfg.dyn_hidden, cfg.full_state_dim, cfg.cl
    per_obj = D * h + h * h + 2 * h * h + 2 * h * h + 2 * h * h + h * h \
        + h * (6 + 2 * cl)
    if cfg.reward_head:
        per_obj += 2 * (2 * h * h + h * h + h)
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
    jobs = [fr.job(cfg), fr.job(ckpt_lib.load_config(AVOID)), fscan.job(cfg),
            fscan.job(cfg.with_overrides(velocity_obs_full_std=False)),
            fscan.job(cfg.with_overrides(velocity_obs="filtered")),
            fspn.job(sspecs.obj), fspn.job(sspecs.bg),
            flik.job(cfg, sspecs)]
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
          f"{fr.load(ckpt_lib.load_config(AVOID)).stove_rollout_smem_bytes()}"
          f" B), scan {fscan.load(cfg).stove_scan_smem_bytes()} B, spn obj "
          f"{fspn.load(sspecs.obj).stove_spn_smem_bytes()} B / bg "
          f"{fspn.load(sspecs.bg).stove_spn_smem_bytes()} B, likelihood "
          f"{flik.load(cfg, sspecs).stove_lik_smem_bytes()} B")

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
    dyn64 = ckpt_lib.params_from_numpy(dyn, dev, torch.float64)
    max_err = 0.0
    for B, H in ((256, 8), (100, 8), (32, 80)):
        z0 = z_post[:B].contiguous()
        got = fr.rollout_states(dyn, cfg, z0, H, sample=False,
                                prepared=model.prepared)
        ref, _ = fr.rollout_states_reference(dyn, cfg, z0, H)
        ref64, _ = fr.rollout_states_reference(dyn64, cfg, z0.double(), H)
        torch.cuda.synchronize()
        # Steps 1-8 are held to 1e-4, against the plain version in float32
        # (cuBLAS) and evaluated in float64 (the kernel's own error).  The
        # latent rows reach |15| and the trained map amplifies float32
        # rounding ~1.4x a step, so two float32 evaluations summing in
        # different orders drift apart.  Over a whole longer horizon the
        # kernel's distance from the float64 version is held to at most
        # twice the float32 plain version's own distance from it.
        err8 = (got[:, :8] - ref[:, :8]).abs().max().item()
        own8 = (got[:, :8].double() - ref64[:, :8]).abs().max().item()
        max_err = max(max_err, err8)
        per_step = (got[:, :8] - ref[:, :8]).abs().amax(dim=(0, 2, 3))
        phase("mean", f"B={B} H={H}: max |kernel - plain| over steps 1-8: "
              f"{err8:.3e} vs float32 plain, {own8:.3e} vs float64 plain; "
              f"by step vs float32: "
              + " ".join(f"{e:.1e}" for e in per_step.tolist()))
        check(err8 <= 1e-4 and own8 <= 1e-4,
              f"mean rollout error {err8} / {own8} > 1e-4 at B={B}")
        if H > 8:
            k64 = (got.double() - ref64).abs().amax(dim=(0, 2, 3))
            p64 = (ref.double() - ref64).abs().amax(dim=(0, 2, 3))
            k_all, p_all = k64.max().item(), p64.max().item()
            phase("mean", f"B={B} H={H}: max distance from float64 plain "
                  f"over all {H} steps: kernel {k_all:.3e}, float32 plain "
                  f"{p_all:.3e} (ratio {k_all / max(p_all, 1e-30):.3f}); "
                  "by step 10, 20, ...: kernel " + " ".join(
                      f"{e:.1e}" for e in k64[9::10].tolist())
                  + "; float32 plain " + " ".join(
                      f"{e:.1e}" for e in p64[9::10].tolist()))
            check(k_all <= 2 * p_all,
                  f"kernel's {H}-step distance from float64 {k_all} > 2x "
                  f"the float32 plain version's {p_all}")

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
    print(json.dumps({"kernels": kernels, "train_step_ms": {
        k: tr[f"step_{k}"] for k in ("kernels", "plain")},
        "resume": tr["resume"], "avoidance_eval": act["eval"],
        "planning": act["plan"]}))
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
            z, zm, kl = fscan.launch_kernel(fr.pack_params(dyn, c2), c2,
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

    @contextlib.contextmanager
    def recording(shapes):
        """Count the launches by (B, H, sampled) while the block runs.  The
        wrapper stands in for the module's launch_kernel, so the launch
        counter that launch_kernel increments is the wrapper's while it
        stands, and is handed back after."""
        def recorded(prepared, c, z0, horizon, sample, *a, **k):
            key = (z0.shape[0], horizon, bool(sample))
            shapes[key] = shapes.get(key, 0) + 1
            return real_launch(prepared, c, z0, horizon, sample, *a, **k)
        recorded.launches = real_launch.launches
        fr.launch_kernel = recorded
        try:
            yield
        finally:
            fr.launch_kernel = real_launch
            real_launch.launches = recorded.launches

    def hold_launched(shapes, name):
        """Hold every mean shape a path launched that (12) did not; the
        sampled ones are held in distribution by (13)."""
        phase(name, "rollout launches by (B, H, sampled): " + ", ".join(
            f"{k}: {v}" for k, v in sorted(shapes.items())))
        for B, H, smp in sorted(shapes):
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
    with recording(eval_shapes):
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
        with recording(shapes):
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
            for (b, h, smp), v in sorted(d.items())},
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


if __name__ == "__main__":
    sys.exit(main())
