"""Tracing and profiling hooks (counterpart of `stove_tpu/utils/profiling.py`,
on `torch.profiler` where the reference uses `jax.profiler`).

Usage:
    with trace("runs/exp/trace"):        # writes runs/exp/trace/trace.json
        trainer.train_step(batch)

    with annotate("spn_likelihood"):     # a named range in the timeline
        ...

`python -m stove_tpu_torch.main mode=profile ...` traces a few training
steps into `<run_dir>/<run_name>/trace/trace.json`, a Chrome trace (open
it in Perfetto or chrome://tracing).  `device_times` reads such a file:
the device time of each CUDA kernel, copy and fill name in it.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None
          ) -> Iterator[torch.profiler.profile]:
    """Profile the block: CPU activity, and CUDA activity where `cuda`
    (default: a card is present).  Yields the profiler; on leaving the
    block writes its Chrome trace to `<log_dir>/trace.json`."""
    os.makedirs(log_dir, exist_ok=True)
    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str) -> record_function:
    """A named range that shows up in the profiler's timeline."""
    return record_function(name)


DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_times(path: str) -> Tuple[Dict[str, Tuple[float, int]], float]:
    """({name: (device ms, count)}, the trace's wall span in ms) of a
    Chrome trace written by `trace`: its device events (CUDA kernels,
    copies and fills), and the span from the first event's start to the
    last event's end."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X" and "ts" in e]
    out: Dict[str, Tuple[float, int]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENTS:
            ms, n = out.get(e["name"], (0.0, 0))
            out[e["name"]] = (ms + e.get("dur", 0) / 1e3, n + 1)
    wall = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3 \
        if spans else 0.0
    return out, wall


def profile_train_steps(cfg, n_steps: int = 3, device=None) -> str:
    """Trace `n_steps` full-ELBO training steps; returns the trace dir.

    One warm-up step runs first, outside the trace (it builds the kernels
    the config selects), so the trace shows steady state; on the card the
    traced block ends with a synchronise, so that every kernel it launched
    is in the trace."""
    from stove_tpu_torch.envs import data as data_lib
    from stove_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=device)

    def step():
        batch = data_lib.sample_windows(trainer.train_ep, trainer.cfg,
                                        trainer.data_gen, cfg.batch_size)
        return trainer.train_step(batch)

    step()
    trace_dir = os.path.join(trainer.run_dir, "trace")
    cuda = trainer.device.type == "cuda"
    with trace(trace_dir, cuda=cuda):
        for i in range(n_steps):
            with annotate(f"train_step_{i}"):
                step()
        if cuda:
            torch.cuda.synchronize()
    return trace_dir
