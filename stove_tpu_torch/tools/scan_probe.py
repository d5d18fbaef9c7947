"""Measure the scan kernel's small tiles and its weight packing on the card.

    python3 -m stove_tpu_torch.tools.scan_probe [--other DIR] [--readings 4]

At the three training windows -- billiards (B=256, T2=6), avoidance with
actions and the reward head (256, 10), gravity (256, 14) -- on the trained
weights and the posterior's inputs of rendered windows:

1. Every scan library at 2 and 4 samples a block, in both precisions: its
   registers, spills and shared memory (`nvcc -Xptxas -v`), its distance
   from the plain version (float32: max |z - plain| and kl relative to
   max(|kl|, 1); bfloat16: against the plain loop at bf16, the ratio of the
   maxima and of the medians to |plain bf16 - plain f32|), and its time in
   turns (2, 4, 4, 2 samples a block; CUDA events, the best of 3 rounds).
2. The weight packing each call of `fused_scan.scan_kernel` does
   (`fused_scan.prepare_params`), each precision, CUDA events.
3. With `--other DIR` (a directory holding another version's scan.cu and
   dyn_core.cuh, e.g. `git archive <rev> stove_tpu_torch/csrc | tar -x -C
   build/other`, then `--other build/other/stove_tpu_torch/csrc`): its
   libraries at 8 samples a block (the tile of the kernel before the
   tensor-core core, which reads `fused_rollout.flat_params`' f32 buffer),
   timed in the same turns: other, 2, 4, 4, 2, other.
4. On the random states of tests/test_torch_training_kernels.py::
   test_kernels_on_ragged_batches (billiards, T2=6; `ragged_inputs`, one
   `torch.Generator().manual_seed(s)` a draw) at B = 255, 1055, 2113 and
   4096, seeds 0-23: the float32 library's, the other
   version's and the plain float32 loop's largest distance from the plain
   loop in float64 (z, and kl relative to max(|kl|, 1)), by step; then,
   per B, each one's spread over the draws, its average over the card
   test's seeds 0-7 and over all draws, and the kernel's ratio to the
   plain loop's average.

`--readings 4` runs reading 4 alone (it builds no probe library unless
`--other` is given).  Prints one line per reading, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from stove_tpu_torch.envs import data as data_lib
from stove_tpu_torch.models import stove as stove_lib
from stove_tpu_torch.models import supair as sup_lib
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.ops import _build
from stove_tpu_torch.ops import fused_rollout as fr
from stove_tpu_torch.ops import fused_scan as fs
from stove_tpu_torch.train import checkpoint as ckpt

RUNS = {"billiards": "ckpts/r4rp_bill_s32", "avoidance": "ckpts/r4a_dense_s2",
        "gravity": "ckpts/r4rp_grav_s32"}
PROBE = Path(_build.BUILD_DIR).parent / "probe"
TILES = (2, 4)
OTHER_TILE = 8
RAGGED_B = (255, 1055, 2113, 4096)
RAGGED_DRAWS = 24
TEST_SEEDS = 8            # the card test's draws are seeds 0 .. TEST_SEEDS-1


def ragged_inputs(cfg, B: int, seed: int, dev):
    """The random scan inputs of the ragged card test, from
    `torch.Generator().manual_seed(seed)`: [z1, carry means, carry stds,
    box means, box stds] (B, 3, ...), no actions (zeros (B, 6)) and eps
    (B, 6, 3, D)."""
    gen = torch.Generator().manual_seed(seed)
    D = cfg.full_state_dim
    args = [0.1 * torch.randn((B, 3, D), generator=gen),
            0.1 * torch.randn((B, 3, 2), generator=gen),
            0.1 + 0.1 * torch.rand((B, 3, 2), generator=gen),
            0.3 * torch.randn((B, 6, 3, 4), generator=gen),
            0.05 + 0.1 * torch.rand((B, 6, 3, 4), generator=gen)]
    eps = torch.randn((B, 6, 3, D), generator=gen)
    return ([a.to(dev) for a in args],
            torch.zeros((B, 6), dtype=torch.long, device=dev), eps.to(dev))


def distances(got, ref):
    """(max |z - ref z|, max |kl - ref kl| / max(|ref kl|, 1)) of a scan's
    outputs against the float64 plain loop's."""
    return ((got[0].double() - ref[0]).abs().max().item(),
            ((got[2].double() - ref[2]).abs()
             / ref[2].abs().clamp_min(1.0)).max().item())


def scan_inputs(model, B: int, seed: int, dev):
    """The scan's inputs on B rendered windows of the model's task, as
    `stove.infer` hands them over: [z1, carry means, carry stds, box means,
    box stds], the actions a_{t-1} (B, T2) and pre-drawn eps."""
    cfg = model.cfg
    gen = torch.Generator().manual_seed(seed)
    T, O = cfg.window, cfg.num_obj
    ep = data_lib.generate(cfg.with_overrides(seq_len=T), B, gen, dev)
    frames = data_lib.normalize_frames(ep.frames)
    with torch.no_grad():
        inf = model.infer(frames, ep.actions if cfg.action_conditioned
                          else None, generator=gen)
        mean, std = sup_lib.encode(model.params["supair"], cfg, frames.reshape(
            B * T, cfg.img_size, cfg.img_size))
        mean, std = mean.reshape(B, T, O, 4), std.reshape(B, T, O, 4)
        m1, s1 = stove_lib.align_slots(mean[:, 0, :, 2:4], mean[:, 1, :, 2:4],
                                       mean[:, 1], std[:, 1])
    args = [inf.z[:, 1].contiguous(), m1[..., 2:4].contiguous(),
            s1[..., 2:4].contiguous(), mean[:, 2:].contiguous(),
            std[:, 2:].contiguous()]
    acts = ep.actions[:, 1:T - 1].to(torch.int32).contiguous()
    eps = torch.randn((B, T - 2, O, cfg.full_state_dim), generator=gen).to(dev)
    return args, acts, eps


def build(jobs):
    """{name: (ctypes library, ptxas lines)} for {name: (source dir,
    defines)}, all nvccs at once."""
    PROBE.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, defines) in jobs.items():
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *defines, f"-I{src}", "-o",
               str(PROBE / f"{name}.so"), str(src / "scan.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(PROBE / f"{name}.so"))
        lib.stove_scan_launch.restype = ctypes.c_int
        lib.stove_scan_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2
            + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
        lib.stove_scan_smem_bytes.restype = ctypes.c_int
        report = " | ".join(ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln)
        libs[name] = (lib, f"{report}; dynamic smem "
                           f"{lib.stove_scan_smem_bytes()} B")
    return libs


def launch(lib, buf, cfg, args, acts, eps):
    """One launch of a scan library: (z, z_mean, kl, rewards)."""
    B, O, D = args[0].shape
    T2 = eps.shape[1]
    z = torch.empty((B, T2, O, D), device=eps.device)
    zm = torch.empty_like(z)
    kl = torch.zeros((B,), device=eps.device)
    rew = torch.zeros((B, T2), device=eps.device)
    err = lib.stove_scan_launch(
        *[a.data_ptr() for a in args], eps.data_ptr(), acts.data_ptr(),
        buf.data_ptr(), z.data_ptr(), zm.data_ptr(), kl.data_ptr(),
        rew.data_ptr(), B, T2, cfg.size_std, cfg.min_dyn_std,
        cfg.max_dyn_std, int(cfg.latent_residual),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return z, zm, kl, rew


def best_ms(fn, iters: int = 20, rounds: int = 3) -> float:
    times = []
    for _ in range(rounds):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return min(times)


def distance(got, dyn, cfg, args, acts, eps, dtype: str) -> str:
    """The library's distance from the plain version at its precision."""
    ref = fs.scan_reference(dyn, cfg, *args, acts, eps, dtype=dtype)
    rel = ((got[2] - ref[2]).abs() / ref[2].abs().clamp_min(1.0)).max().item()
    if dtype == "float32":
        ez = max((got[i] - ref[i]).abs().max().item() for i in (0, 1))
        return (f"max |z - plain| {ez:.2e}, kl rel {rel:.2e}, rewards "
                f"{(got[3] - ref[3]).abs().max().item():.2e}")
    f32 = fs.scan_reference(dyn, cfg, *args, acts, eps)
    d, r = (got[0] - ref[0]).abs(), (ref[0] - f32[0]).abs()
    return (f"z |kernel - plain bf16| median {d.median().item():.2e} max "
            f"{d.max().item():.2e} (|plain bf16 - f32| median "
            f"{r.median().item():.2e} max {r.max().item():.2e}, ratio of the "
            f"maxima {d.max().item() / r.max().item():.3f}); kl rel {rel:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="directory with another version's scan.cu and "
                         "dyn_core.cuh")
    ap.add_argument("--readings", default="1,2,3,4",
                    help="comma-separated readings to run (1-3 share one "
                         "loop; 4)")
    args_ = ap.parse_args(argv)
    readings = {int(r) for r in args_.readings.split(",")}
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    models = {k: StoveModel.from_run(r, device=dev) for k, r in RUNS.items()}
    jobs = {}
    for m, model in models.items():
        kcfg = fr.kernel_config(model.cfg, model.params["dynamics"])
        for dt in fr.DTYPES:
            if readings & {1, 2, 3}:
                for tile in TILES:
                    jobs[f"{m}_{dt}_{tile}"] = (_build.CSRC,
                                                fs.job(kcfg, dt, tile)[1])
            if args_.other is not None:
                jobs[f"{m}_{dt}_other"] = (args_.other,
                                           fs.job(kcfg, dt, OTHER_TILE)[1])
    libs = build(jobs)
    for name, (_, report) in libs.items():
        print(f"build {name}: {report}", flush=True)
    if readings & {1, 2, 3}:
        tile_readings(models, libs, args_.other is not None, dev)
    if 4 in readings:
        ragged_reading(models["billiards"], libs, args_.other is not None,
                       dev)
    return 0


def tile_readings(models, libs, other: bool, dev) -> None:
    """1-3: every scan library's tiles, the weight packing, the other
    version, at the three training windows."""
    for i, (m, model) in enumerate(models.items()):
        dyn = model.params["dynamics"]
        kcfg = fr.kernel_config(model.cfg, dyn)
        args, acts, eps = scan_inputs(model, 256, 40 + i, dev)
        T2 = eps.shape[1]
        for dt in fr.DTYPES:
            bufs = {"this": fs.prepare_params(dyn, model.cfg, dt),
                    "other": fr.flat_params(dyn, model.cfg)}
            pack_ms = best_ms(lambda: fs.prepare_params(dyn, model.cfg, dt),
                              iters=5)
            print(f"pack {m} {dt}: prepare_params {pack_ms:.3f} ms "
                  f"({bufs['this'].numel()} bytes)", flush=True)
            names = [f"{m}_{dt}_{t}" for t in TILES]
            turns = names + names[::-1]
            if other:
                turns = [f"{m}_{dt}_other"] + turns + [f"{m}_{dt}_other"]
            ms = {}
            with torch.no_grad():
                for name in turns:
                    lib = libs[name][0]
                    buf = bufs["other" if name.endswith("other") else "this"]
                    ms.setdefault(name, []).append(best_ms(
                        lambda: launch(lib, buf, kcfg, args, acts, eps)))
                for name in dict.fromkeys(turns):
                    lib = libs[name][0]
                    buf = bufs["other" if name.endswith("other") else "this"]
                    got = launch(lib, buf, kcfg, args, acts, eps)
                    tile = OTHER_TILE if name.endswith("other") else \
                        int(name.rsplit("_", 1)[1])
                    print(f"scan {name} B=256 T2={T2} ({-(-256 // tile)} "
                          f"blocks): " + " / ".join(f"{x:.4f}" for x in ms[name])
                          + f" ms; {distance(got, dyn, kcfg, args, acts, eps, dt)}",
                          flush=True)


def ragged_reading(model, libs, other: bool, dev) -> None:
    """4. float32 against float64 on the ragged card test's random states"""
    cfg, dyn = model.cfg, model.params["dynamics"]
    d64 = ckpt.params_from_numpy(dyn, dev, torch.float64)
    for B in RAGGED_B:
        dist = {}
        for seed in range(RAGGED_DRAWS):
            args, acts, eps = ragged_inputs(cfg, B, seed, dev)
            with torch.no_grad():
                outs = {"kernel": fs.scan_kernel(dyn, cfg, *args, acts, eps,
                                                 dtype="float32"),
                        "plain float32": fs.scan_reference(dyn, cfg, *args,
                                                           acts, eps)}
                if other:
                    outs["other"] = launch(libs["billiards_float32_other"][0],
                                           fr.flat_params(dyn, cfg), cfg,
                                           args, acts.to(torch.int32), eps)
                ref = fs.scan_reference(d64, cfg, *[a.double() for a in args],
                                        acts, eps.double())
            line = []
            for k, x in outs.items():
                by_step = (x[0].double() - ref[0]).abs().amax(dim=(0, 2, 3))
                dz, dkl = distances(x, ref)
                dist.setdefault(k, []).append((dz, dkl))
                line.append(f"{k} z {dz:.3e} (by step "
                            + " ".join(f"{v:.1e}" for v in by_step.tolist())
                            + f"), kl rel {dkl:.3e}")
            print(f"float64 B={B} seed {seed}: " + "; ".join(line), flush=True)
        plain = dist["plain float32"]
        for k, v in dist.items():
            parts = []
            for i, what in enumerate(("z", "kl")):
                xs = [d[i] for d in v]
                ps = [d[i] for d in plain]
                m8, p8 = (sum(xs[:TEST_SEEDS]) / TEST_SEEDS,
                          sum(ps[:TEST_SEEDS]) / TEST_SEEDS)
                ma, pa = sum(xs) / len(xs), sum(ps) / len(ps)
                per = max(a / b for a, b in zip(xs, ps) if b > 0) \
                    if any(ps) else float("nan")
                parts.append(
                    f"{what}: {spread(xs)}, mean over seeds 0-"
                    f"{TEST_SEEDS - 1} {m8:.3e} ({m8 / p8:.3f}x the plain "
                    f"loop's), over {len(xs)} draws {ma:.3e} "
                    f"({ma / pa:.3f}x), largest per-draw ratio {per:.3f}")
            print(f"ragged B={B} {k}: " + "; ".join(parts), flush=True)


def spread(xs):
    xs = sorted(xs)
    return f"min {xs[0]:.3e} median {xs[len(xs) // 2]:.3e} max {xs[-1]:.3e}"


if __name__ == "__main__":
    sys.exit(main())
