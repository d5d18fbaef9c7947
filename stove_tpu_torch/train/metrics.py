"""Structured metrics logging: JSONL + stdout (counterpart of
`stove_tpu/train/metrics.py`).

One JSON object per line in `<run_dir>/metrics.jsonl` (append-only, so a
resumed run continues the file), the same rows the JAX trainer writes, and
a compact line on stdout.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, run_dir: Optional[str], echo: bool = True):
        self.echo = echo
        self.path = None
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self.path = os.path.join(run_dir, "metrics.jsonl")
        self._t0 = time.time()

    def log(self, step: int, kind: str, **values: Any) -> None:
        rec: Dict[str, Any] = {
            "step": int(step),
            "kind": kind,
            "wall_s": round(time.time() - self._t0, 2),
        }
        for k, v in values.items():
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, float):
                v = round(v, 6)
            rec[k] = v
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.echo:
            body = " ".join(f"{k}={v}" for k, v in rec.items()
                            if k not in ("kind",))
            print(f"[{kind}] {body}", flush=True)
