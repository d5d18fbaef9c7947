"""The RAT-SPN forward as one hand-written CUDA kernel.

Counterpart of `stove_tpu/ops/pallas_spn.py::spn_log_prob_fused`.  The
kernel (`csrc/spn.cu`, around the per-sample device function of
`csrc/spn_tile.cuh` that the likelihood kernel shares) evaluates each
sample's SPN from its pixels and weights to the root log-density with every
activation on chip; see the notes at the top of the sources.

* `prepare` lays the parameters out for the kernel: the leaf means, stds
  and log-stds with each repetition's variables in permuted order (so a
  leaf region is a contiguous run), the softmax'd sum-layer weights of all
  levels in one buffer, the root log-weights, the permutations and the
  region bounds.
* `launch_kernel` checks its inputs, launches once on the current stream
  and counts its launches (`launch_kernel.launches`).
* `spn_log_prob_fused` is the dispatch: on CUDA tensors it launches the
  kernel (or raises), on CPU tensors it runs the plain version
  `models/spn.spn_log_prob`; either way the gradient is the VJP of the
  plain version (`ops/_vjp.py`), as the reference's custom_vjp does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from stove_tpu_torch.models import spn as spn_lib
from stove_tpu_torch.ops import _build
from stove_tpu_torch.ops._vjp import with_plain_vjp

_STRUCT_CACHE: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def param_keys(spec: spn_lib.SpnSpec) -> List[str]:
    return (["leaf_mu", "leaf_raw_std"]
            + [f"sum_logits_{d}" for d in range(spec.depth - 1, -1, -1)]
            + ["root_logits"])


def spec_defines(spec: spn_lib.SpnSpec, prefix: str) -> Tuple[str, ...]:
    return (f"-D{prefix}_V={spec.num_vars}", f"-D{prefix}_R={spec.num_reps}",
            f"-D{prefix}_D={spec.depth}", f"-D{prefix}_I={spec.num_leaves}",
            f"-D{prefix}_S={spec.num_sums}")


def job(spec: spn_lib.SpnSpec) -> _build.Job:
    return ("spn.cu", spec_defines(spec, "SPN"))


def _structure(spec: spn_lib.SpnSpec, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm (R, V) int32, region bounds (L+1) int32) on `device`."""
    key = (spec.perms.tobytes(), spec.depth, str(device))
    got = _STRUCT_CACHE.get(key)
    if got is None:
        bounds = np.linspace(0, spec.num_vars,
                             spec.num_leaf_regions + 1).round().astype(np.int32)
        got = (torch.as_tensor(spec.perms.astype(np.int32), device=device),
               torch.as_tensor(bounds, device=device))
        _STRUCT_CACHE[key] = got
    return got


def prepare(spec: spn_lib.SpnSpec, params: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """The kernel's parameter buffers (counterpart of `pallas_spn._prepare`).

    mu/sd/logsd: (R, V, I) with [r, k, i] = leaf (r, perm[r, k], i);
    sumw: for d = D−1 … 0, softmax(sum_logits_d) (R, 2^d, S, c²) flattened
    and concatenated; root: log_softmax(root_logits) (R·S).
    """
    mu = params["leaf_mu"]
    perm, bounds = _structure(spec, mu.device)
    idx = perm.long()[:, :, None].expand(-1, -1, spec.num_leaves)
    std = spn_lib._leaf_std(spec, params["leaf_raw_std"])
    sd = torch.gather(std, 1, idx)
    sumw = torch.cat([torch.softmax(params[f"sum_logits_{d}"], -1).reshape(-1)
                      for d in range(spec.depth - 1, -1, -1)])
    return {"perm": perm, "bounds": bounds,
            "mu": torch.gather(mu, 1, idx).contiguous(),
            "sd": sd.contiguous(), "logsd": torch.log(sd).contiguous(),
            "sumw": sumw.contiguous(),
            "root": torch.log_softmax(params["root_logits"], -1).contiguous()}


def _setup(lib: ctypes.CDLL) -> None:
    lib.stove_spn_smem_bytes.restype = ctypes.c_int
    lib.stove_spn_smem_bytes.argtypes = []
    lib.stove_spn_launch.restype = ctypes.c_int
    lib.stove_spn_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 9


def load(spec: spn_lib.SpnSpec) -> ctypes.CDLL:
    src, defines = job(spec)
    return _build.load(src, defines, _setup)


def launch_kernel(spec: spn_lib.SpnSpec, prep: Dict[str, torch.Tensor],
                  x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One launch: x, weight (B, V) f32 CUDA → (B,) log-densities."""
    _build.check_device(x, weight, *prep.values())
    B, V = x.shape
    if V != spec.num_vars or weight.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)}, weight {tuple(weight.shape)}:"
                         f" the SPN has {spec.num_vars} variables")
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError("the SPN kernel takes float32 x and weight")
    x, weight = x.contiguous(), weight.contiguous()
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = load(spec)
    with torch.cuda.device(x.device):
        err = lib.stove_spn_launch(
            x.data_ptr(), weight.data_ptr(), B, prep["perm"].data_ptr(),
            prep["bounds"].data_ptr(), prep["mu"].data_ptr(),
            prep["sd"].data_ptr(), prep["logsd"].data_ptr(),
            prep["sumw"].data_ptr(), prep["root"].data_ptr(), out.data_ptr(),
            _build.stream_of(x))
    if err != 0:
        raise RuntimeError(f"SPN kernel launch failed: CUDA error {err}")
    launch_kernel.launches += 1
    return out


launch_kernel.launches = 0


def spn_log_prob_fused(spec: spn_lib.SpnSpec, params: Dict[str, torch.Tensor],
                       x: torch.Tensor, weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Drop-in for `spn.spn_log_prob`: (B, V) → (B,).  The kernel on CUDA
    tensors, the plain version on CPU tensors; gradient of the plain one."""
    if weight is None:
        weight = torch.ones_like(x)
    keys = param_keys(spec)

    def plain(*args):
        return spn_lib.spn_log_prob(spec, dict(zip(keys, args[:-2])),
                                    args[-2], args[-1])

    def fast(*args):
        return launch_kernel(spec, prepare(spec, dict(zip(keys, args[:-2]))),
                             args[-2], args[-1])

    if x.device.type == "cuda":
        return with_plain_vjp(fast, plain, *[params[k] for k in keys], x,
                              weight)
    if x.device.type != "cpu":
        raise ValueError(f"the SPN runs on cuda or cpu, not {x.device}")
    return with_plain_vjp(plain, plain, *[params[k] for k in keys], x, weight)
