"""The RAT-SPN forward as one hand-written CUDA kernel.

Counterpart of `stove_tpu/ops/pallas_spn.py::spn_log_prob_fused`.  The
kernel (`csrc/spn.cu`, around the tile evaluator of `csrc/spn_tile.cuh`
that the likelihood kernel shares) evaluates a tile of samples a block
from their pixels and weights to the root log-densities, with every
activation on chip and the parameters read once a block; see the notes at
the top of the sources.

* `layout` and `pack_reference` define the packed parameter buffer the
  evaluator reads (the leaves in permuted order as float4 (mu,
  sqrt(1/2)/sd, -log sd - log(2 pi)/2, bits of the variable), the
  softmaxed sum-layer weights a (level, repetition) block, the root
  log-weights); `prepare` builds it: one launch of the library's packing
  kernel on CUDA tensors, `pack_reference` on CPU tensors.
* `TILE` is the samples a block: 2048 frames and 6144 patches, the
  training step's batches, launch 256 and 768 blocks on the 132 SMs.
* `launch_kernel` checks its inputs, launches once on the current stream
  and counts its launches (`launch_kernel.launches`, and by library in
  `launch_kernel.by_library`; the packing kernel's in
  `prepare.by_library`).
* `spn_log_prob_fused` is the dispatch: on CUDA tensors it launches the
  kernel (or raises), on CPU tensors it runs the plain version
  `models/spn.spn_log_prob`; either way the gradient is the VJP of the
  plain version (`ops/_vjp.py`), as the reference's custom_vjp does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Tuple

import torch

from stove_tpu_torch.models import spn as spn_lib
from stove_tpu_torch.ops import _build
from stove_tpu_torch.ops._vjp import with_plain_vjp

TILE = 8                                     # samples a block (-DSPN_TB)
_PERM_CACHE: Dict[Tuple, torch.Tensor] = {}


def param_keys(spec: spn_lib.SpnSpec) -> List[str]:
    return (["leaf_mu", "leaf_raw_std"]
            + [f"sum_logits_{d}" for d in range(spec.depth - 1, -1, -1)]
            + ["root_logits"])


def spec_defines(spec: spn_lib.SpnSpec, prefix: str) -> Tuple[str, ...]:
    return (f"-D{prefix}_V={spec.num_vars}", f"-D{prefix}_R={spec.num_reps}",
            f"-D{prefix}_D={spec.depth}", f"-D{prefix}_I={spec.num_leaves}",
            f"-D{prefix}_S={spec.num_sums}")


def job(spec: spn_lib.SpnSpec) -> _build.Job:
    return ("spn.cu", spec_defines(spec, "SPN") + (f"-DSPN_TB={TILE}",))


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def layout(spec: spn_lib.SpnSpec) -> Dict[str, object]:
    """Offsets (floats) of the packed buffer's sections, as `SpnLayout` in
    spn_tile.cuh: `leaf` (R·V·I·4), per level d = D−1 … 0 `levels[d]` =
    (offset, floats a repetition, padded to 4), `root`, `floats`."""
    R, V, I, S, D = (spec.num_reps, spec.num_vars, spec.num_leaves,
                     spec.num_sums, spec.depth)
    off, levels, c = R * V * I * 4, {}, I
    for d in range(D - 1, -1, -1):
        wrep = _r4(2 ** d * S * c * c)
        levels[d] = (off, wrep)
        off += R * wrep
        c = S
    return {"leaf": R * V * I * 4, "levels": levels, "root": off,
            "floats": off + _r4(R * S)}


def _perm(spec: spn_lib.SpnSpec, device: torch.device) -> torch.Tensor:
    """The permutations (R, V) as int32 on `device`, cached."""
    key = (spec.perms.tobytes(), str(device))
    got = _PERM_CACHE.get(key)
    if got is None:
        got = torch.as_tensor(spec.perms.astype("int32"), device=device)
        _PERM_CACHE[key] = got
    return got


def pack_reference(spec: spn_lib.SpnSpec, params: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
    """The packed buffer in plain PyTorch (counterpart of
    `pallas_spn._prepare`, in the evaluator's layout): the packing kernel's
    plain version."""
    R, V, I, S = (spec.num_reps, spec.num_vars, spec.num_leaves,
                  spec.num_sums)
    lay = layout(spec)
    mu = params["leaf_mu"]
    buf = torch.zeros(lay["floats"], dtype=torch.float32, device=mu.device)
    perm = _perm(spec, mu.device).long()
    idx = perm[:, :, None].expand(-1, -1, I)
    sd = torch.gather(spn_lib._leaf_std(spec, params["leaf_raw_std"]), 1, idx)
    leaf = buf[:lay["leaf"]].view(R, V, I, 4)
    leaf[..., 0] = torch.gather(mu, 1, idx)
    leaf[..., 1] = math.sqrt(0.5) / sd
    leaf[..., 2] = -torch.log(sd) - 0.5 * math.log(2.0 * math.pi)
    leaf.view(torch.int32)[..., 3] = perm[:, :, None].to(torch.int32)
    c = I
    for d in range(spec.depth - 1, -1, -1):
        off, wrep = lay["levels"][d]
        n = 2 ** d * S * c * c
        w = torch.softmax(params[f"sum_logits_{d}"], -1).reshape(R, n)
        buf[off:off + R * wrep].view(R, wrep)[:, :n] = w
        c = S
    buf[lay["root"]:lay["root"] + R * S] = torch.log_softmax(
        params["root_logits"], -1)
    return buf


def _setup(lib: ctypes.CDLL) -> None:
    for name in ("stove_spn_smem_bytes", "stove_spn_floats"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    lib.stove_spn_launch.restype = ctypes.c_int
    lib.stove_spn_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                                     + [ctypes.c_void_p] * 3)
    lib.stove_spn_pack.restype = ctypes.c_int
    lib.stove_spn_pack.argtypes = ([ctypes.c_void_p] * 8
                                   + [ctypes.c_float] * 2
                                   + [ctypes.c_void_p] * 2)


def load(spec: spn_lib.SpnSpec) -> ctypes.CDLL:
    src, defines = job(spec)
    return _build.load(src, defines, _setup)


def pack_args(spec: spn_lib.SpnSpec, params: Dict[str, torch.Tensor]
              ) -> Tuple[list, list]:
    """The packing kernel's arguments for one SPN (spn.cu::stove_spn_pack
    and the halves of likelihood.cu::stove_lik_pack): pointers to mu, raw
    std, perm, four logit slots (d = D−1 … 0, the rest null), the root
    logits, then min_std and the std span; and the tensors they point
    into, to hold until the launch is queued."""
    if not 1 <= spec.depth <= 4:
        raise ValueError(f"depth {spec.depth}: the kernels take 1-4 levels")
    ts = [params[k] for k in param_keys(spec)]
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("the packing kernel takes float32 parameters")
    ts = [t.contiguous() for t in ts] + [_perm(spec, ts[0].device)]
    ptrs = [t.data_ptr() for t in ts]
    logits = ptrs[2:-2] + [None] * (4 - spec.depth)
    args = ([ptrs[0], ptrs[1], ptrs[-1], *logits, ptrs[-2]]
            + [spec.min_std, spec.max_std - spec.min_std])
    return args, ts


def prepare(spec: spn_lib.SpnSpec, params: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """The packed buffer: one launch of the library's packing kernel on
    CUDA parameters, `pack_reference` on CPU ones."""
    mu = params["leaf_mu"]
    if mu.device.type == "cpu":
        return pack_reference(spec, params)
    _build.check_device(*[params[k] for k in param_keys(spec)])
    lib = load(spec)
    floats = layout(spec)["floats"]
    if lib.stove_spn_floats() != floats:
        raise RuntimeError(f"packed layout: the library's {lib.stove_spn_floats()}"
                           f" floats, layout()'s {floats}")
    out = torch.empty(floats, dtype=torch.float32, device=mu.device)
    args, _keep = pack_args(spec, params)
    with torch.cuda.device(mu.device):
        err = lib.stove_spn_pack(*args, out.data_ptr(), _build.stream_of(mu))
    if err != 0:
        raise RuntimeError(f"SPN packing kernel failed: CUDA error {err}")
    key = " ".join(job(spec)[1])
    prepare.by_library[key] = prepare.by_library.get(key, 0) + 1
    return out


prepare.by_library = {}           # launches by library (its defines)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous with a 16-byte aligned start (the kernels' cp.async
    copies need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_kernel(spec: spn_lib.SpnSpec, packed: torch.Tensor,
                  x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """One launch: x, weight (B, V) f32 CUDA → (B,) log-densities;
    `packed` from `prepare`."""
    _build.check_device(x, weight, packed)
    B, V = x.shape
    if V != spec.num_vars or weight.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)}, weight {tuple(weight.shape)}:"
                         f" the SPN has {spec.num_vars} variables")
    if (x.dtype != torch.float32 or weight.dtype != torch.float32
            or packed.dtype != torch.float32):
        raise TypeError("the SPN kernel takes float32 x, weight and buffer")
    if packed.numel() != layout(spec)["floats"]:
        raise ValueError(f"packed buffer of {packed.numel()} floats; this "
                         f"SPN's has {layout(spec)['floats']}")
    x, weight, packed = aligned(x), aligned(weight), aligned(packed)
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    lib = load(spec)
    with torch.cuda.device(x.device):
        err = lib.stove_spn_launch(x.data_ptr(), weight.data_ptr(), B,
                                   packed.data_ptr(), out.data_ptr(),
                                   _build.stream_of(x))
    if err != 0:
        raise RuntimeError(f"SPN kernel launch failed: CUDA error {err}")
    launch_kernel.launches += 1
    key = " ".join(job(spec)[1])
    launch_kernel.by_library[key] = launch_kernel.by_library.get(key, 0) + 1
    return out


launch_kernel.launches = 0
launch_kernel.by_library = {}     # launches by library (its defines)


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
