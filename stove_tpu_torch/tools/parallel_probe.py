"""Data parallelism on the cards of one machine, one process a card.

    python3 -m stove_tpu_torch.tools.parallel_probe [--cards N]

1. `dryrun_multichip(N)` over NCCL, one card a rank: one training step
   at debug_shrunk with space-to-depth, one window a rank, the sharded
   loss against one device's (rel 1e-4).
2. `mode=train` of preset=stove_billiards at the published batch (256)
   and widths, the corpus cut to 64 + 32 sequences (made once by
   `mode=generate`), 3 epochs of 3 steps (1 SuPAIR warm-up epoch, one
   evaluation at the end), under `python -m torch.distributed.run
   --nproc_per_node=N` and in one process on one card: every logged
   train and eval metric within rtol 5e-3 + atol 1e-5 (the JAX package's
   test_parallel.py:104), and the host-clock seconds between the logged
   epochs (`wall_s`) of both runs.

N defaults to the cards there are (at least 2).  Prints the card's name
and power limit, one line per run and per logged row; exits non-zero if
a check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import torch

from stove_tpu_torch.parallel import dryrun

ARGS = ["preset=stove_billiards", "num_train=64", "num_test=32",
        "num_epochs=3", "steps_per_epoch=3", "supair_only_epochs=1",
        "eval_every=3", "ckpt_every=99"]


def run(cmd) -> None:
    t = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    print(f"$ {' '.join(cmd)}\n  rc {p.returncode} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if p.returncode:
        print(p.stdout[-3000:], p.stderr[-6000:], flush=True)
        raise SystemExit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("parallel_probe: no CUDA device", file=sys.stderr)
        return 1
    n = args.cards or torch.cuda.device_count()
    if n < 2 or n > torch.cuda.device_count():
        print(f"parallel_probe: {n} ranks on {torch.cuda.device_count()} "
              "cards (NCCL takes one card a rank)", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t = time.perf_counter()
    print(dryrun.dryrun_multichip(n, device="cuda"),
          f"{time.perf_counter() - t:.1f} s", flush=True)
    tmp = tempfile.mkdtemp()
    common = ARGS + [f"run_dir={tmp}", f"data_dir={tmp}/data"]
    run([sys.executable, "-m", "stove_tpu_torch.main", "mode=generate"]
        + ARGS + [f"data_dir={tmp}/data"])
    run([sys.executable, "-m", "torch.distributed.run",
         f"--nproc_per_node={n}", "--master_port=29541", "-m",
         "stove_tpu_torch.main"] + common + [f"run_name=dp{n}"])
    run([sys.executable, "-m", "stove_tpu_torch.main"] + common
        + ["run_name=dp1"])
    rows = {k: [json.loads(ln) for ln in open(f"{tmp}/{k}/metrics.jsonl")]
            for k in ("dp1", f"dp{n}")}
    worst = 0.0
    for a, b in zip(*rows.values()):
        if a["kind"] not in ("train", "eval"):
            continue
        keys = [k for k, v in a.items()
                if isinstance(v, float) and k != "wall_s"]
        share = max(abs(a[k] - b[k]) / (5e-3 * abs(a[k]) + 1e-5)
                    for k in keys)
        worst = max(worst, share)
        print(f"{a['kind']} step {a['step']}: 1 card "
              f"{ {k: a[k] for k in keys[:4]} }, {n} cards "
              f"{ {k: b[k] for k in keys[:4]} }; worst share of the limit "
              f"{share:.3f}; wall_s {a['wall_s']} / {b['wall_s']}",
              flush=True)
    print(f"worst metric difference {n} cards vs 1: {worst:.3f} of rtol "
          "5e-3 + atol 1e-5", flush=True)
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
