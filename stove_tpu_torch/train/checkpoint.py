"""Checkpoint bridge: reads the JAX package's run directories.

The JAX trainer (`stove_tpu/train/checkpoint.py`) flattens its state pytree
into one npz, one array per leaf, keyed by the leaf's keystr path, e.g.
`['params']['dynamics']['embed'][0]['w']`.  `load_params` parses those
paths back into the port's parameter tree — nested dicts and lists of
tensors with the same keys — and skips the optimizer state, the PRNG key
and the epoch counter.  Weights keep the stored (in, out) layout: the
port's code multiplies `x @ w` exactly as the JAX code does, so nothing is
transposed on the way in.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from stove_tpu_torch.config import Config
from stove_tpu_torch.device import resolve_device

_TOKEN = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def load_config(run_dir: str) -> Config:
    with open(os.path.join(run_dir, "config.json")) as f:
        return Config.from_json(f.read())


def latest_step(run_dir: str) -> Optional[int]:
    ckpts = sorted(glob.glob(os.path.join(run_dir, "ckpt_*.npz")))
    if not ckpts:
        return None
    return int(re.search(r"ckpt_(\d+)\.npz", ckpts[-1]).group(1))


def parse_keystr(path: str) -> list:
    """`['a'][0]['b']` → ['a', 0, 'b']; raises on anything else."""
    parts, pos = [], 0
    for m in _TOKEN.finditer(path):
        if m.start() != pos:
            raise ValueError(f"unparseable checkpoint key {path!r}")
        parts.append(m.group(1) if m.group(1) is not None
                     else int(m.group(2)))
        pos = m.end()
    if pos != len(path) or not parts:
        raise ValueError(f"unparseable checkpoint key {path!r}")
    return parts


def _insert(tree: dict, parts: list, leaf) -> None:
    node = tree
    for key, nxt in zip(parts[:-1], parts[1:]):
        child = {} if isinstance(nxt, str) else []
        if isinstance(node, list):
            while len(node) <= key:
                node.append(None)
            if node[key] is None:
                node[key] = child
            node = node[key]
        else:
            node = node.setdefault(key, child)
    last = parts[-1]
    if isinstance(node, list):
        while len(node) <= last:
            node.append(None)
        node[last] = leaf
    else:
        node[last] = leaf


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict:
    """Rebuild the `['params']` subtree from keystr-flattened arrays."""
    tree: Dict = {}
    head = "['params']"
    for key, arr in flat.items():
        if key.startswith(head):   # opt_state keys use attribute syntax
            _insert(tree, parse_keystr(key)[1:], arr)
    return tree


def params_from_numpy(tree: Any,
                      device: Optional[Union[str, torch.device]] = None,
                      dtype: torch.dtype = torch.float32) -> Any:
    """Map a nested dict/list of numpy arrays (e.g. the JAX params pulled to
    host) or tensors to the same structure of tensors on `device` (the card
    unless the caller names another; see `resolve_device`).  No
    transposes."""
    return _to_tensors(tree, resolve_device(device), dtype)


def _to_tensors(tree: Any, device: torch.device, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v, device, dtype) for v in tree]
    if not isinstance(tree, torch.Tensor):
        tree = torch.from_numpy(np.array(tree))
    return tree.to(device=device, dtype=dtype)


def load_flat(run_dir: str, step: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The raw keystr → array mapping of the latest (or given) checkpoint."""
    if step is None:
        step = latest_step(run_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {run_dir}")
    path = os.path.join(run_dir, f"ckpt_{step:08d}.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_params(run_dir: str, step: Optional[int] = None,
                device: Optional[Union[str, torch.device]] = None) -> Dict:
    """The `params` subtree of a JAX checkpoint as tensors on `device` (the
    card unless the caller names another)."""
    params = unflatten_params(load_flat(run_dir, step))
    if not params:
        raise KeyError(f"checkpoint in {run_dir} holds no ['params'] leaves")
    return params_from_numpy(params, device)
