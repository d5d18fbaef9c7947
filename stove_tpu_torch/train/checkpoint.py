"""Checkpoints in the JAX package's layout, read and written.

The JAX trainer (`stove_tpu/train/checkpoint.py`) flattens its state pytree
into one npz, one array per leaf, keyed by the leaf's keystr path, e.g.
`['params']['dynamics']['embed'][0]['w']` or, for optax's Adam state,
`['opt_state'][1].inner_states['dynamics'].inner_state[0].mu['dynamics']
['embed'][0]['w']`.  `load_params` parses the params back into the port's
tree — nested dicts and lists of tensors with the same keys.  `save` writes
the port's training state (params, the two Adam groups' counts and
moments, the schedule counts, the epoch) under exactly those keys, and
`restore` reads them back, so the port resumes JAX runs and the JAX
package restores the port's.  The JAX PRNG `key` leaf cannot seed the
port's generators: `save` writes a placeholder there (the JAX template
needs the leaf) and `restore` ignores it.  Weights keep the stored
(in, out) layout: the port's code multiplies `x @ w` as the JAX code does,
so nothing is transposed.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from stove_tpu_torch import tree
from stove_tpu_torch.config import Config
from stove_tpu_torch.device import resolve_device

_TOKEN = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def load_config(run_dir: str) -> Config:
    with open(os.path.join(run_dir, "config.json")) as f:
        return Config.from_json(f.read())


def save_config(run_dir: str, cfg: Config) -> None:
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())


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


def _group_prefix(group: str, k: int) -> str:
    """optax.chain(clip, multi_transform)'s path to a group's state k
    (0: scale_by_adam, 1: the learning-rate schedule's count)."""
    return f"['opt_state'][1].inner_states['{group}'].inner_state[{k}]"


def flatten_state(params: Dict, opt_state: Dict, epoch: int
                  ) -> Dict[str, np.ndarray]:
    """The npz mapping of a training state, keyed as the JAX trainer keys
    it.  opt_state: {group: {"count", "mu", "nu", "lr_count"}} (see
    train/trainer.py::Optimizer); "lr_count" is None without a schedule."""
    def arr(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)

    flat = {"['params']" + tree.keystr(p): arr(v)
            for p, v in tree.paths(params)}
    for g, st in opt_state.items():
        adam = _group_prefix(g, 0)
        flat[adam + ".count"] = arr(st["count"]).astype(np.int32)
        for m in ("mu", "nu"):
            for p, v in tree.paths(st[m]):
                flat[f"{adam}.{m}" + tree.keystr((g,) + p)] = arr(v)
        if st["lr_count"] is not None:
            flat[_group_prefix(g, 1) + ".count"] = \
                arr(st["lr_count"]).astype(np.int32)
    flat["['key']"] = np.zeros((2,), np.uint32)
    flat["['epoch']"] = np.asarray(epoch, np.int32)
    return flat


def save(run_dir: str, step: int, params: Dict, opt_state: Dict, epoch: int,
         keep: int = 3) -> str:
    """Write ckpt_<step>.npz; prune old ones beyond `keep`."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"ckpt_{step:08d}.npz")
    np.savez_compressed(path, **flatten_state(params, opt_state, epoch))
    ckpts = sorted(glob.glob(os.path.join(run_dir, "ckpt_*.npz")))
    for old in ckpts[:-keep]:
        os.remove(old)
    return path


def _subtree(flat: Dict[str, np.ndarray], prefix: str) -> Dict:
    out: Dict = {}
    for key, a in flat.items():
        if key.startswith(prefix + "["):
            _insert(out, parse_keystr(key[len(prefix):]), a)
    return out


def restore(run_dir: str, groups=("dynamics", "supair"),
            step: Optional[int] = None,
            device: Optional[Union[str, torch.device]] = None
            ) -> Tuple[int, Dict, Dict, int]:
    """(step, params, opt_state, epoch) of the latest (or given) checkpoint
    of a JAX or port run directory, as tensors on `device` (the card unless
    the caller names another)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(run_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {run_dir}")
    flat = load_flat(run_dir, step)
    params = params_from_numpy(unflatten_params(flat), dev)
    opt_state = {}
    for g in groups:
        adam = _group_prefix(g, 0)
        if adam + ".count" not in flat:
            raise KeyError(f"checkpoint in {run_dir} has no Adam state for "
                           f"the {g!r} group")
        lr = flat.get(_group_prefix(g, 1) + ".count")
        opt_state[g] = {
            "count": torch.as_tensor(flat[adam + ".count"], device=dev),
            "mu": params_from_numpy(_subtree(flat, adam + ".mu")[g], dev),
            "nu": params_from_numpy(_subtree(flat, adam + ".nu")[g], dev),
            "lr_count": None if lr is None else torch.as_tensor(lr, device=dev),
        }
    return step, params, opt_state, int(flat["['epoch']"])
