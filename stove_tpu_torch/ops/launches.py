"""Kernel launches made by CUDA graph replays, kept in the wrappers' counts.

Every kernel wrapper counts its own launches (`launch_kernel.launches` and
`launch_kernel.by_library` of `fused_rollout`, `fused_scan`, `fused_spn`
and `fused_likelihood`; the SPN and likelihood packing kernels in
`prepare.by_library`) once per launch it queues.  Under a CUDA graph
capture the wrapper runs, and counts, but nothing runs on the card; each
replay then launches the kernel again without running the wrapper.  A
captured step therefore takes what its capture counted back out of the
counters (`since`, `add(counts, -1)`) and adds it at every replay
(`add(counts)`), so the counters hold the launches the card ran.
`REPLAYED` keeps the replays' share on its own.

Keys are "<source> <defines>" (the library's `job`), and the same key +
" pack" for a library's packing kernel.
"""

from __future__ import annotations

from typing import Dict

# library key -> launches made by replays of captured graphs
REPLAYED: Dict[str, int] = {}


def _counters():
    """(source, counted function, key suffix) of every wrapper."""
    from stove_tpu_torch.ops import fused_likelihood as flik
    from stove_tpu_torch.ops import fused_rollout as fr
    from stove_tpu_torch.ops import fused_scan as fscan
    from stove_tpu_torch.ops import fused_spn as fspn
    return (("rollout.cu", fr.launch_kernel, ""),
            ("scan.cu", fscan.launch_kernel, ""),
            ("spn.cu", fspn.launch_kernel, ""),
            ("likelihood.cu", flik.launch_kernel, ""),
            ("spn.cu", fspn.prepare, " pack"),
            ("likelihood.cu", flik.prepare, " pack"))


def by_library() -> Dict[str, int]:
    """The wrappers' counts by library."""
    out: Dict[str, int] = {}
    for src, fn, suffix in _counters():
        out.update({f"{src} {k}{suffix}": v
                    for k, v in fn.by_library.items()})
    return out


def since(snap: Dict[str, int]) -> Dict[str, int]:
    """The wrappers' launches by library after `by_library()` gave
    `snap`."""
    return {k: v - snap.get(k, 0) for k, v in by_library().items()
            if v != snap.get(k, 0)}


def add(counts: Dict[str, int], times: int = 1) -> None:
    """Add `times` x `counts` (keys of `by_library`) to the wrappers'
    counters, by library and in all."""
    for src, fn, suffix in _counters():
        for lib in fn.by_library:
            n = counts.get(f"{src} {lib}{suffix}", 0) * times
            fn.by_library[lib] += n
            if not suffix:
                fn.launches += n
