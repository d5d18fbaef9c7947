"""Measure the SPN and likelihood kernels' tiles and packing on the card.

    python3 -m stove_tpu_torch.tools.spn_probe [--other DIR]

At the training step's shapes -- the likelihood on 2048 rendered frames
(256 windows of 8) with their posterior boxes, the object SPN on their
6144 patches, the background SPN on the 2048 frames -- with the trained
billiards weights (`ckpts/r4rp_bill_s32`):

1. Every library at 4, 8 and 16 samples a block (the likelihood at 4 and
   8: 16 frames do not fit a block's shared memory): its registers, spills
   and shared memory (`nvcc -Xptxas -v`), its largest distance from the
   plain version in float64, relative to max(|log p|, 100) (phases (6) and
   (7) of chip_smoke.py hold it to 1e-5), and its time in turns (CUDA
   events, the best of 3 rounds), the launches direct.
2. The packing each call does: `fused_likelihood.prepare` (one launch for
   both SPNs) and `fused_spn.prepare`, CUDA events.
3. With `--other DIR` (a directory holding another version's spn.cu,
   likelihood.cu and spn_tile.cuh, e.g. `git archive <rev>
   stove_tpu_torch/csrc | tar -x -C build/other`, then `--other
   build/other/stove_tpu_torch/csrc`): that version's libraries as the
   warp-per-sample design before the tile evaluator built them, its
   parameter buffers made as its wrapper made them (`other_prepare`), held
   to the same limit and timed in the same turns (other, this, this,
   other), and its wrapper's packing (two `prepare`s and two grids a
   likelihood call).
4. With `--breakdown`: the likelihood at 8 frames a block built from
   copies of the sources under `build/probe/` in which the leaf sums, the
   mixtures (with their exps), or the prologue (edges, background
   weights, patches) are skipped, alone and all three: the time of each
   part is the full kernel's less the kernel without it; what remains
   with all three skipped is the parameter staging, the barriers and the
   root.  (The skipped kernels' outputs are meaningless.)
5. With `--variant DIR` (a directory holding a changed copy of this
   version's spn_tile.cuh and likelihood.cu; may repeat): each such
   likelihood at 8 frames a block against this one, held to the same
   limit and timed in turns (this, variants, variants reversed, this).

Prints one line per reading, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from stove_tpu_torch import tree
from stove_tpu_torch.envs import data as data_lib
from stove_tpu_torch.models import spn as spn_lib
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.ops import _build
from stove_tpu_torch.ops import fused_likelihood as flik
from stove_tpu_torch.ops import fused_spn as fspn
from stove_tpu_torch.ops import glimpse

RUN = "ckpts/r4rp_bill_s32"
PROBE = Path(_build.BUILD_DIR).parent / "probe"
SPN_TILES = (4, 8, 16)
LIK_TILES = (4, 8)
LIMIT = 1e-5


def at_tile(job, tile: int):
    """`job` (source, defines) with its samples a block set to `tile`."""
    src, defines = job
    key = "-DLIK_TB=" if src == "likelihood.cu" else "-DSPN_TB="
    return src, tuple(d for d in defines if not d.startswith(key)) + (
        f"{key}{tile}",)


def inputs(model, dev):
    """Frames (2048, 32, 32), boxes (2048, 3, 4), and each SPN's (x, w)."""
    cfg = model.cfg
    B, T = cfg.batch_size, cfg.window
    gen = torch.Generator().manual_seed(6)
    ep = data_lib.generate(cfg.with_overrides(seq_len=T), B, gen, dev)
    frames = data_lib.normalize_frames(ep.frames)
    flat = frames.reshape(B * T, cfg.img_size, cfg.img_size).contiguous()
    with torch.no_grad():
        inf = model.infer(frames, None, generator=gen)
        boxes = torch.cat([inf.z[..., 0:2], inf.z[..., 2:4]], -1).reshape(
            B * T, cfg.num_obj, 4).contiguous()
        P2 = cfg.patch_size ** 2
        patches = glimpse.extract_glimpses(flat, boxes, cfg.patch_size)
        pw, bgv = flik.patch_weights(cfg, boxes)
    return flat, boxes, {
        "obj": (patches.reshape(-1, P2).contiguous(),
                pw.reshape(-1, P2).contiguous()),
        "bg": (flat.reshape(B * T, -1).contiguous(),
               bgv.reshape(B * T, -1).contiguous())}


def other_prepare(spec, params):
    """The parameter buffers of the warp-per-sample kernels (the wrapper
    before the tile evaluator): perm, region bounds, mu/sd/log sd in
    permuted order, the softmaxed mixture weights, the root log-weights."""
    dev = params["leaf_mu"].device
    perm = torch.as_tensor(spec.perms.astype(np.int32), device=dev)
    bounds = torch.as_tensor(np.linspace(0, spec.num_vars,
                                         spec.num_leaf_regions + 1)
                             .round().astype(np.int32), device=dev)
    idx = perm.long()[:, :, None].expand(-1, -1, spec.num_leaves)
    sd = torch.gather(spn_lib._leaf_std(spec, params["leaf_raw_std"]), 1, idx)
    sumw = torch.cat([torch.softmax(params[f"sum_logits_{d}"], -1).reshape(-1)
                      for d in range(spec.depth - 1, -1, -1)])
    return [perm, bounds, torch.gather(params["leaf_mu"], 1, idx).contiguous(),
            sd.contiguous(), torch.log(sd).contiguous(), sumw.contiguous(),
            torch.log_softmax(params["root_logits"], -1).contiguous()]


def build_other(src: Path, jobs):
    """{name: (library, ptxas report)} for {name: (source file, defines)} of
    the other version, all nvccs at once, under build/probe/."""
    PROBE.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (cu, defines) in jobs.items():
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *defines, f"-I{src}", "-o",
               str(PROBE / f"{name}.so"), str(src / cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(PROBE / f"{name}.so"))
        for fn in ("stove_spn_launch", "stove_lik_launch"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
        out[name] = (lib, " | ".join(ln.strip() for ln in log.splitlines()
                                     if "registers" in ln or "spill" in ln))
    return out


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


def rel(got, ref) -> float:
    return ((got.double() - ref).abs() / ref.abs().clamp_min(100.0)).max().item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="directory with another version's spn.cu, "
                         "likelihood.cu and spn_tile.cuh")
    ap.add_argument("--breakdown", action="store_true",
                    help="time the likelihood without its leaf sums, "
                         "mixtures or prologue")
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="directory with a changed copy of spn_tile.cuh "
                         "and likelihood.cu (may repeat)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spn_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    model = StoveModel.from_run(RUN, device=dev)
    cfg, specs, sp = model.cfg, model.specs.supair, model.params["supair"]
    flat, boxes, spn_in = inputs(model, dev)
    spns = {"obj": (specs.obj, sp["obj_spn"]), "bg": (specs.bg, sp["bg_spn"])}

    # libraries of this version, all nvccs at once
    jobs = {(k, t): at_tile(fspn.job(spec), t)
            for k, (spec, _) in spns.items() for t in SPN_TILES}
    jobs.update({("lik", t): at_tile(flik.job(cfg, specs), t)
                 for t in LIK_TILES})
    for name, path in zip(jobs, _build.build(list(jobs.values()))):
        print(f"build {name}: {_build.ptxas_report(path)}", flush=True)

    # float64 references
    f64 = tree.map_leaves(lambda x: x.double(), sp)
    with torch.no_grad():
        ref = {k: spn_lib.spn_log_prob(spec, f64[f"{k}_spn"], x.double(),
                                       w.double())
               for k, ((spec, _), (x, w)) in
               zip(spns, zip(spns.values(), spn_in.values()))}
        ref["lik"] = flik.likelihood_reference(cfg, specs, f64, flat.double(),
                                               boxes.double())

    def spn_call(k, tile):
        spec, prm = spns[k]
        x, w = spn_in[k]
        lib = _build.load(*jobs[(k, tile)], fspn._setup)
        packed = fspn.prepare(spec, prm)
        out = torch.empty(x.shape[0], device=dev)

        def go():
            err = lib.stove_spn_launch(x.data_ptr(), w.data_ptr(), x.shape[0],
                                       packed.data_ptr(), out.data_ptr(),
                                       _build.stream_of(x))
            assert err == 0, err
            return out
        return go

    def lik_call(tile):
        lib = _build.load(*jobs[("lik", tile)], flik._setup)
        packed = flik.prepare(cfg, specs, sp)
        gp, gi = flik.grids(dev, cfg.patch_size, cfg.img_size)
        out = torch.empty(flat.shape[0], device=dev)

        def go():
            err = lib.stove_lik_launch(
                flat.data_ptr(), boxes.data_ptr(), flat.shape[0],
                gp.data_ptr(), gi.data_ptr(), packed[0].data_ptr(),
                packed[1].data_ptr(), out.data_ptr(), _build.stream_of(flat))
            assert err == 0, err
            return out
        return go

    calls = {}
    for t in SPN_TILES:
        calls[("spn", t)] = (spn_call("obj", t), spn_call("bg", t))
    for t in LIK_TILES:
        calls[("lik", t)] = (lik_call(t),)

    if args.other is not None:
        other = build_other(args.other, {
            f"other {k}": ("spn.cu", fspn.spec_defines(spec, "SPN"))
            for k, (spec, _) in spns.items()} | {
            "other likelihood": ("likelihood.cu", tuple(
                d for d in flik.job(cfg, specs)[1] if "LIK_TB" not in d))})
        for name, (_, report) in other.items():
            print(f"build {name}: {report}", flush=True)
        bufs = {k: other_prepare(spec, prm) for k, (spec, prm) in spns.items()}
        gp, gi = flik.grids(dev, cfg.patch_size, cfg.img_size)

        def other_spn(k):
            lib = other[f"other {k}"][0]
            x, w = spn_in[k]
            out = torch.empty(x.shape[0], device=dev)
            ptrs = [ctypes.c_void_p(b.data_ptr()) for b in bufs[k]]

            def go():
                err = lib.stove_spn_launch(
                    ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()),
                    ctypes.c_int(x.shape[0]), *ptrs,
                    ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_void_p(_build.stream_of(x)))
                assert err == 0, err
                return out
            return go

        lib_o = other["other likelihood"][0]
        out_o = torch.empty(flat.shape[0], device=dev)
        optrs = [ctypes.c_void_p(b.data_ptr()) for b in bufs["obj"] + bufs["bg"]]

        def other_lik():
            err = lib_o.stove_lik_launch(
                ctypes.c_void_p(flat.data_ptr()), ctypes.c_void_p(boxes.data_ptr()),
                ctypes.c_int(flat.shape[0]), ctypes.c_void_p(gp.data_ptr()),
                ctypes.c_void_p(gi.data_ptr()), *optrs,
                ctypes.c_void_p(out_o.data_ptr()),
                ctypes.c_void_p(_build.stream_of(flat)))
            assert err == 0, err
            return out_o
        calls[("spn", "other")] = (other_spn("obj"), other_spn("bg"))
        calls[("lik", "other")] = (other_lik,)

    # 1 and 3: distance from float64, then times in turns
    for (kind, tile), fns in calls.items():
        outs = [f() for f in fns]
        torch.cuda.synchronize()
        keys = ("obj", "bg") if kind == "spn" else ("lik",)
        errs = [rel(o, ref[k]) for o, k in zip(outs, keys)]
        print(f"error {kind} tile {tile}: max |kernel - float64 plain| / "
              f"max(|log p|, 100) " + ", ".join(
                  f"{k} {e:.2e}" for k, e in zip(keys, errs))
              + f" (limit {LIMIT:g}: {'ok' if max(errs) <= LIMIT else 'OVER'})",
              flush=True)
    for kind, tiles in (("spn", SPN_TILES), ("lik", LIK_TILES)):
        order = list(tiles) + list(tiles)[::-1]
        if args.other is not None:
            order = ["other"] + order + ["other"]
        times = {}
        for t in order:
            fns = calls[(kind, t)]
            times.setdefault(t, []).append(best_ms(lambda: [f() for f in fns]))
        shape = ("obj (6144, 100) + bg (2048, 1024)" if kind == "spn"
                 else "2048 frames, 3 objects")
        for t, ms in times.items():
            print(f"time {kind} tile {t} at {shape}: "
                  + " / ".join(f"{m:.4f}" for m in ms) + f" ms (turns) on "
                  f"{card}", flush=True)

    if args.breakdown:
        src = patched_sources()
        turns(cfg, specs, sp, flat, boxes, card, "breakdown", {
            "full": (src, ()), "no leaf sums": (src, ("-DPROBE_LEAF=0",)),
            "no mixtures": (src, ("-DPROBE_MIX=0",)),
            "no prologue": (src, ("-DPROBE_PRO=0",)),
            "none of the three": (src, ("-DPROBE_LEAF=0", "-DPROBE_MIX=0",
                                        "-DPROBE_PRO=0"))})
    if args.variant:
        turns(cfg, specs, sp, flat, boxes, card, "variant",
              {"this": (_build.CSRC, ()),
               **{str(v): (v, ()) for v in args.variant}}, ref["lik"])

    # 2. packing a call
    with torch.no_grad():
        ms = best_ms(lambda: flik.prepare(cfg, specs, sp))
        print(f"pack fused_likelihood.prepare (both SPNs, one launch): "
              f"{ms:.4f} ms on {card}", flush=True)
        for k, (spec, prm) in spns.items():
            ms = best_ms(lambda: fspn.prepare(spec, prm))
            print(f"pack fused_spn.prepare {k}: {ms:.4f} ms", flush=True)
        if args.other is not None:
            ms = best_ms(lambda: (other_prepare(specs.obj, sp["obj_spn"]),
                                  other_prepare(specs.bg, sp["bg_spn"]),
                                  torch.linspace(-1.0, 1.0, cfg.patch_size,
                                                 device=dev),
                                  torch.linspace(-1.0, 1.0, cfg.img_size,
                                                 device=dev)))
            print(f"pack other version's likelihood wrapper (two prepares, "
                  f"two linspaces): {ms:.4f} ms", flush=True)
    return 0


PARTS = {"LEAF": ("            leaf_chunk(ch, buf, xs, ws, X);\n",),
         "MIX": ("                exps<d>(in, M);\n",
                 "            mix<d>(j, buf, in, M, out);\n"),
         "PRO": ("    // 1. edges per axis and bilinear taps\n",)}


def patched_sources() -> Path:
    """Copies of spn_tile.cuh and likelihood.cu under build/probe/ whose
    parts run only where -DPROBE_<part>=1 (LEAF, MIX, PRO; 1 by default).
    Raises if a part's line is in neither source: a breakdown that skips
    nothing would read that part's time as 0."""
    out = PROBE / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    missing = {line for lines in PARTS.values() for line in lines}
    for name in ("spn_tile.cuh", "likelihood.cu"):
        text = (_build.CSRC / name).read_text()
        for part, lines in PARTS.items():
            for line in lines:
                if line not in text:
                    continue
                missing.discard(line)
                if part == "PRO":        # the prologue up to step 4
                    end = "    // 4. the two SPNs and the sum\n"
                    a, b = text.index(line), text.index(end)
                    text = (text[:a] + "    if (PROBE_PRO) {\n" + text[a:b]
                            + "    }\n" + text[b:])
                else:
                    text = text.replace(line, line.replace(
                        line.strip(), f"if (PROBE_{part}) {line.strip()}"))
        head = "".join(f"#ifndef PROBE_{p}\n#define PROBE_{p} 1\n#endif\n"
                       for p in PARTS)
        (out / name).write_text(head + text)
    if missing:
        raise RuntimeError(f"--breakdown: no line {sorted(missing)} in "
                           f"spn_tile.cuh or likelihood.cu; update PARTS")
    return out


def turns(cfg, specs, sp, flat, boxes, card, what: str, builds,
          ref=None) -> None:
    """4 and 5: the likelihood at 8 frames a block built from each of
    `builds` ({name: (source dir, extra defines)}), timed in turns; held
    to the limit where `ref` (float64) is given."""
    base = at_tile(flik.job(cfg, specs), 8)[1]
    procs = {}
    for name, (src, extra) in builds.items():
        so = PROBE / f"{what}_{len(procs)}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *base, *extra, f"-I{src}",
               "-o", str(so), str(src / "likelihood.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    dev = flat.device
    packed = flik.prepare(cfg, specs, sp)
    gp, gi = flik.grids(dev, cfg.patch_size, cfg.img_size)
    out = torch.empty(flat.shape[0], device=dev)
    fns = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(f"{what} build {name}: " + " | ".join(
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
        lib = ctypes.CDLL(str(so))
        flik._setup(lib)

        def go(lib=lib):
            err = lib.stove_lik_launch(
                flat.data_ptr(), boxes.data_ptr(), flat.shape[0],
                gp.data_ptr(), gi.data_ptr(), packed[0].data_ptr(),
                packed[1].data_ptr(), out.data_ptr(), _build.stream_of(flat))
            assert err == 0, err
            return out
        fns[name] = go
        if ref is not None:
            got = go()
            torch.cuda.synchronize()
            e = rel(got, ref)
            print(f"{what} error {name}: {e:.2e} (limit {LIMIT:g}: "
                  f"{'ok' if e <= LIMIT else 'OVER'})", flush=True)
    order = list(fns) + list(fns)[::-1]
    times = {}
    for name in order:
        times.setdefault(name, []).append(best_ms(fns[name]))
    first = min(next(iter(times.values())))
    for name, ms in times.items():
        print(f"{what} likelihood tile 8, {name}: " + " / ".join(
            f"{m:.4f}" for m in ms) + f" ms (turns); {list(times)[0]} less "
            f"this {first - min(ms):+.4f} ms on {card}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
