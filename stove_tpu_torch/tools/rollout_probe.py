"""Measure the rollout kernel's float32 FMA loop and its bf16 flips on the card.

    python3 -m stove_tpu_torch.tools.rollout_probe [--other DIR]

1. The float32 library at 16 samples a block, B=16384, H=92 sampled, on the
   trained billiards and avoidance weights, built from copies of
   `csrc/rollout.cu` and `csrc/dyn_core.cuh` under `build/probe/` whose FMA
   loop runs 0, 1 or 2 times a pass: the loop costs rep1 - rep0 (and
   rep2 - rep1), the rest of the kernel rep0.  Also the loop unrolled over
   whole chunks.  With `--other DIR` (a directory holding another version's
   rollout.cu and dyn_core.cuh, e.g. `git archive <rev>
   stove_tpu_torch/csrc | tar -x -C build/other` then
   `--other build/other/stove_tpu_torch/csrc`), the same for it.
2. Over 24 seeded input draws, the bf16 libraries of both bf16
   precisions (the TPU kernel's variant, "bfloat16", and
   compute_dtype=bfloat16's "dense_bf16") against the plain version at
   that precision (states and rewards, steps 1-4): the ratio of the
   largest |kernel - plain bf16| to the largest |plain bf16 - plain f32|
   and the share of entries above 0.1x the latter (tests/bf16_parity.py
   holds both).
3. Over the same draws at B=100, H=8 (avoidance), the float32 card test's
   criterion (tests/test_torch_fused_rollout.py::
   test_action_kernel_matches_plain_version): the kernel's distance from
   the plain version in float64 at most twice the float32 plain
   version's, for this kernel and the other.  Then, through the wrapper
   (`fused_rollout.rollout`, the library and tile the test launches), at
   both of the test's shapes (B=360, H=1 and B=100, H=8), the actions of
   each draw from `torch.Generator().manual_seed(draw)`: per draw the
   kernel's and the plain float32 version's distance from float64 for
   states and rewards, and where (step, row, column) the kernel's largest
   error sits; then the spread of the plain version's distance over the
   draws.

4. The three precisions' libraries ("float32", "bfloat16", "dense_bf16",
   the 4-sample tile) at the eval's (100, 8) for billiards and the
   planner's leaf (576, 10) for avoidance, on seeded inputs: each held
   bit for bit against the same library built from `--other` (where that
   version has the precision: its `stove_rollout_bf16()` says which), the
   distance of each from the plain "dense_bf16" version, and their times
   in turns.

`--readings 3` runs reading 3 alone (its libraries only).

Times are CUDA events, the best of three interleaved rounds.  Prints one
line per reading, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from stove_tpu_torch.models.dynamics import PRECISIONS
from stove_tpu_torch.ops import _build
from stove_tpu_torch.ops import fused_rollout as fr
from stove_tpu_torch.train import checkpoint as ckpt

RUNS = {"billiards": "ckpts/r4rp_bill_s32", "avoidance": "ckpts/r4a_dense_s2"}
PROBE = Path(_build.BUILD_DIR).parent / "probe"
# the FMA loop of the rollout's mma_gemm, or, in a version before it, of the
# feature-major core the rollout then used (first found wins)
LOOPS = ("#pragma unroll (FMA_UNROLL)\n            for (int kq = 0;",
         "#pragma unroll 8\n            for (int k = 0; k < KC; ++k) {")
UNROLL = "constexpr int FMA_UNROLL = REW ? 1 : 2;"


def patched(src: Path, tag: str, whole: bool = False) -> Path:
    """A copy of the sources in `src` whose FMA loop runs PROBE_REP times
    (a define, 1 by default); `whole` unrolls it over whole chunks."""
    out = PROBE / tag
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.copy(src / "rollout.cu", out / "rollout.cu")
    core = (src / "dyn_core.cuh").read_text()
    loop = next((p for p in LOOPS if core.count(p) == 1), None)
    if loop is None:
        raise RuntimeError(f"{src}: the FMA loop is not where this probe looks")
    core = core.replace(loop, "for (int rep_ = 0; rep_ < PROBE_REP; ++rep_)\n"
                        + loop)
    core = core.replace("#pragma once\n",
                        "#pragma once\n#ifndef PROBE_REP\n#define PROBE_REP 1\n#endif\n", 1)
    if whole:
        if UNROLL not in core:
            raise RuntimeError(f"{src}: no FMA_UNROLL to change")
        core = core.replace(UNROLL, "constexpr int FMA_UNROLL = 64;")
    (out / "dyn_core.cuh").write_text(core)
    return out


def build(jobs):
    """{name: ctypes library} for {name: (source dir, defines)}, all nvccs
    at once."""
    procs = {}
    for name, (src, defines) in jobs.items():
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *defines, f"-I{src}", "-o",
               str(PROBE / f"{name}.so"), str(src / "rollout.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(PROBE / f"{name}.so"))
        lib.stove_rollout_launch.restype = ctypes.c_int
        lib.stove_rollout_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_uint64]
            + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
        libs[name] = lib
    return libs


def z0_of(cfg, B: int, seed: int, dev):
    """Random in-distribution states (tests/test_torch_fused_rollout.py)."""
    g = torch.Generator().manual_seed(seed)
    z = torch.zeros(B, cfg.num_obj, cfg.full_state_dim)
    z[..., 0:2] = 0.24
    z[..., 2:4] = torch.rand(B, cfg.num_obj, 2, generator=g) * 1.4 - 0.7
    z[..., 4:6] = torch.randn(B, cfg.num_obj, 2, generator=g) * 0.05
    z[..., 6:] = torch.randn(B, cfg.num_obj, cfg.cl, generator=g) * 0.5
    return z.to(dev)


def launch(lib, buf, cfg, z0, acts, H: int, sample: bool):
    """One launch of a rollout library: (states, rewards)."""
    B = z0.shape[0]
    out = torch.zeros((B, H) + tuple(z0.shape[1:]), device=z0.device)
    rew = torch.zeros((B, H), device=z0.device)
    a = (acts if acts is not None
         else torch.zeros((B, H), dtype=torch.int32, device=z0.device))
    err = lib.stove_rollout_launch(
        z0.data_ptr(), buf.data_ptr(), a.data_ptr(), out.data_ptr(),
        rew.data_ptr(), B, H, int(sample), 7, cfg.size_std, cfg.min_dyn_std,
        cfg.max_dyn_std, cfg.rollout_sigma_temp, int(cfg.latent_residual),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out, rew


def params_for(lib, dyn, cfg):
    """The weight buffer a library reads: prepare_params' for the mma core,
    the flat f32 buffer for the earlier core (which exports a count)."""
    if hasattr(lib, "stove_rollout_param_bytes"):
        return fr.prepare_params(dyn, cfg, "float32")
    return fr.flat_params(dyn, cfg)


def best_ms(fn, iters: int = 3, rounds: int = 3) -> float:
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


def flips(got, ref_bf16, ref_f32, steps: int = 4):
    """(largest ratio of the maxima, largest share of moved entries) over
    steps 1..`steps`, as tests/bf16_parity.py reads them."""
    ratio = share = 0.0
    for t in range(steps):
        d = (got[:, t] - ref_bf16[:, t]).abs().double()
        r = (ref_bf16[:, t] - ref_f32[:, t]).abs().double()
        ratio = max(ratio, d.max().item() / r.max().item())
        share = max(share, (d > 0.1 * r.max()).double().mean().item())
    return ratio, share


def spread(xs):
    xs = sorted(xs)
    return f"min {xs[0]:.3g} median {xs[len(xs) // 2]:.3g} max {xs[-1]:.3g}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="directory with another version's rollout.cu and "
                         "dyn_core.cuh")
    ap.add_argument("--draws", type=int, default=24)
    ap.add_argument("--readings", default="1,2,3,4",
                    help="comma-separated readings to run (1, 2, 3, 4)")
    args = ap.parse_args(argv)
    readings = {int(r) for r in args.readings.split(",")}
    if not torch.cuda.is_available():
        print("rollout_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    models = {k: (ckpt.load_config(r), ckpt.load_params(r, device=dev)[
        "dynamics"]) for k, r in RUNS.items()}
    srcs = {"this": _build.CSRC}
    if args.other is not None:
        srcs["other"] = args.other
    jobs = {}
    PROBE.mkdir(parents=True, exist_ok=True)
    for label, src in srcs.items():
        for m, (cfg, dyn) in models.items():
            d = fr.job(fr.kernel_config(cfg, dyn), False, "float32", 16)[1]
            jobs[f"{label}_{m}"] = (src, d)
            if 4 in readings:
                for dt in PRECISIONS:
                    jobs[f"{label}_{m}_{dt}"] = (src, fr.job(
                        fr.kernel_config(cfg, dyn), False, dt, 4)[1])
            if 1 in readings:
                rep_src = patched(src, f"{label}_rep")
                for rep in (0, 1, 2):
                    jobs[f"{label}_{m}_rep{rep}"] = (rep_src, d + (f"-DPROBE_REP={rep}",))
    if 1 in readings:
        whole = patched(srcs["this"], "this_whole", whole=True)
        cfg, dyn = models["billiards"]
        jobs["this_billiards_whole"] = (whole, fr.job(cfg, False, "float32", 16)[1])
    libs = build(jobs)
    if 1 in readings:
        loop_reading(srcs, models, libs, dev)
    if 2 in readings:
        flip_reading(models, args.draws, dev)
    if 3 in readings:
        criterion_reading(srcs, models, libs, args.draws, dev)
    if 4 in readings:
        precision_reading(srcs, models, libs, dev)
    return 0


def loop_reading(srcs, models, libs, dev) -> None:
    """1. the FMA loop against the rest of the kernel"""
    B, H = 16384, 92
    for label in srcs:
        for m, (cfg, dyn) in models.items():
            kcfg = fr.kernel_config(cfg, dyn)
            z0 = z0_of(cfg, B, 1, dev)
            acts = torch.randint(0, cfg.num_actions, (B, H), generator=torch.
                                 Generator().manual_seed(2)).to(dev, torch.int32)
            ms = []
            for rep in (0, 1, 2):
                lib = libs[f"{label}_{m}_rep{rep}"]
                buf = params_for(lib, dyn, kcfg)
                ms.append(best_ms(lambda: launch(lib, buf, kcfg, z0, acts, H,
                                                 True)))
            print(f"loop {label} {m} B={B} H={H} sampled: FMA loop run 0/1/2 "
                  f"times {ms[0]:.2f} / {ms[1]:.2f} / {ms[2]:.2f} ms: the loop "
                  f"{ms[1] - ms[0]:.2f} ms (second run {ms[2] - ms[1]:.2f}), "
                  f"the rest {ms[0]:.2f} ms", flush=True)
    lib = libs["this_billiards_whole"]
    cfg, dyn = models["billiards"]
    buf = params_for(lib, dyn, cfg)
    z0 = z0_of(cfg, B, 1, dev)
    print(f"loop this billiards, unrolled over whole chunks: "
          f"{best_ms(lambda: launch(lib, buf, cfg, z0, None, H, True)):.2f} ms",
          flush=True)



def flip_reading(models, draws: int, dev) -> None:
    """2. bf16 flips over seeded draws"""
    for (m, B), dt in itertools.product(
            (("billiards", 16384), ("billiards", 100), ("avoidance", 576),
             ("avoidance", 16384)), ("bfloat16", "dense_bf16")):
        if dt == "dense_bf16" and B > 1000:
            continue                  # no path launches it at 16 a block
        cfg, dyn = models[m]
        prep = fr.prepare_params(dyn, cfg, dt)
        seen = {}
        for seed in range(draws):
            z0 = z0_of(cfg, B, 5 + 100 * seed, dev)
            acts = (torch.randint(0, cfg.num_actions, (B, 4), generator=torch.
                                  Generator().manual_seed(seed)).to(dev)
                    if cfg.action_conditioned else None)
            s, r = fr.rollout(dyn, cfg, z0, 4, False, None, prep, acts, dt)
            bs, br = fr.rollout_states_reference(dyn, cfg, z0, 4, None, acts,
                                                 dt)
            fs, frw = fr.rollout_states_reference(dyn, cfg, z0, 4, None, acts,
                                                  "float32")
            seen.setdefault("states", []).append(flips(s, bs, fs))
            if cfg.reward_head:
                seen.setdefault("rewards", []).append(
                    flips(r[..., None], br[..., None], frw[..., None]))
        for what, v in seen.items():
            print(f"flips {dt} {m} B={B} {what} over {draws} draws: ratio "
                  f"of the maxima {spread([x[0] for x in v])}; share of "
                  f"moved entries {spread([x[1] for x in v])}", flush=True)



def where(err: torch.Tensor) -> str:
    """(step, row, column) of the largest entry of a (B, H, ...) error."""
    idx = int(err.argmax())
    b, rest = divmod(idx, err[0].numel())
    t, col = divmod(rest, max(1, err[0, 0].numel()))
    return f"step {t + 1} row {b} col {col}"


def criterion_reading(srcs, models, libs, draws: int, dev) -> None:
    """3. the float32 card test's criterion over seeded draws"""
    cfg, dyn = models["avoidance"]
    d64 = ckpt.params_from_numpy(dyn, dev, torch.float64)
    B, H = 100, 8
    z0 = z0_of(cfg, B, 6, dev)
    for label in srcs:
        lib = libs[f"{label}_avoidance"]
        buf = params_for(lib, dyn, cfg)
        ok, ks = 0, []
        for seed in range(draws):
            acts = torch.randint(0, cfg.num_actions, (B, H), generator=torch.
                                 Generator().manual_seed(seed)).to(dev)
            s, r = launch(lib, buf, cfg, z0, acts.to(torch.int32), H, False)
            ps, pr = fr.rollout_states_reference(dyn, cfg, z0, H, None, acts)
            ws, wr = fr.rollout_states_reference(d64, cfg, z0.double(), H,
                                                 None, acts)
            k = [(g.double() - w).abs().max().item() for g, w in ((s, ws), (r, wr))]
            p = [(g.double() - w).abs().max().item() for g, w in ((ps, ws), (pr, wr))]
            ok += all(a <= 2 * b + 1e-6 for a, b in zip(k, p))
            ks.append(max(a / b for a, b in zip(k, p)))
        print(f"criterion {label} avoidance B={B} H={H}: kernel within 2x the "
              f"float32 plain version's distance from float64 in {ok} of "
              f"{draws} draws; ratio {spread(ks)}", flush=True)
    # the card test itself, through the wrapper, with seeded actions
    for B, H in ((360, 1), (100, 8)):
        z0 = fr_z0(cfg, B, dev)
        plain_d = {"states": [], "rewards": []}
        ok = 0
        for seed in range(draws):
            acts = torch.randint(0, cfg.num_actions, (B, H), generator=torch.
                                 Generator().manual_seed(seed)).to(dev)
            s, r = fr.rollout(dyn, cfg, z0, H, sample=False, actions=acts)
            ps, pr = fr.rollout_states_reference(dyn, cfg, z0, H, None, acts)
            ws, wr = fr.rollout_states_reference(d64, cfg, z0.double(), H,
                                                 None, acts)
            line, good = [], True
            for what, got, plain, want in (("states", s, ps, ws),
                                           ("rewards", r, pr, wr)):
                e = (got.double() - want).abs()
                k = e.max().item()
                p = (plain.double() - want).abs().max().item()
                plain_d[what].append(p)
                passed = k <= 2 * p + 1e-6 and (H > 1 or k <= 1e-5)
                good &= passed
                line.append(f"{what} kernel {k:.3e} plain {p:.3e} "
                            f"({'pass' if passed else 'FAIL'}, kernel max at "
                            f"{where(e)})")
            ok += good
            print(f"card test B={B} H={H} draw {seed}: " + "; ".join(line),
                  flush=True)
        print(f"card test B={B} H={H}: passes {ok} of {draws} draws; plain "
              f"float32 distance from float64 over the draws: states "
              f"{spread(plain_d['states'])}, rewards "
              f"{spread(plain_d['rewards'])}", flush=True)


def precision_reading(srcs, models, libs, dev) -> None:
    """4. the three precisions, bit for bit against another version"""
    for m, B, H in (("billiards", 100, 8), ("avoidance", 576, 10)):
        cfg, dyn = models[m]
        kcfg = fr.kernel_config(cfg, dyn)
        z0 = z0_of(cfg, B, 9, dev)
        acts = (torch.randint(0, cfg.num_actions, (B, H), generator=torch.
                              Generator().manual_seed(9)).to(dev, torch.int32)
                if cfg.action_conditioned else None)
        ref, _ = fr.rollout_states_reference(dyn, cfg, z0, H, None, acts,
                                             "dense_bf16")
        for dt in PRECISIONS:
            buf = fr.prepare_params(dyn, cfg, dt)
            out = {}
            for label in srcs:
                lib = libs[f"{label}_{m}_{dt}"]
                lib.stove_rollout_bf16.restype = ctypes.c_int
                if lib.stove_rollout_bf16() != fr.BF16_LEVEL[dt]:
                    print(f"precision {label} {m} {dt}: that version has no "
                          "such library", flush=True)
                    continue
                out[label] = launch(lib, buf, kcfg, z0, acts, H, False)
                ms = best_ms(lambda: launch(lib, buf, kcfg, z0, acts, H,
                                            False), iters=20)
                d = (out[label][0] - ref).abs().max().item()
                print(f"precision {label} {m} {dt} B={B} H={H}: {ms:.4f} ms; "
                      f"max |kernel - plain dense_bf16| {d:.3e}", flush=True)
            if len(out) == 2:
                a, b = out.values()
                same = all(torch.equal(x, y) for x, y in zip(a, b))
                print(f"precision {m} {dt}: this and other bit for bit "
                      f"{same}, max diff "
                      f"{(a[0] - b[0]).abs().max().item():.3e}", flush=True)


def fr_z0(cfg, B: int, dev):
    """The card test's states (tests/test_torch_fused_rollout.py::_z0, seed
    6)."""
    return z0_of(cfg, B, 6, dev)


if __name__ == "__main__":
    sys.exit(main())
