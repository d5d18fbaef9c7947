"""The posterior recursion of a window as one hand-written CUDA kernel.

Counterpart of `stove_tpu/ops/pallas_scan.py::scan_fused` and of the
custom-VJP dispatch `_scan_pallas` in `stove_tpu/models/stove.py`.  The
kernel (`csrc/scan.cu`) runs the T−2 posterior steps of one window per
block of TB samples on the rollout's dynamics core (`csrc/dyn_core.cuh`:
bf16 matmuls on the tensor cores, float32 ones on the CUDA cores), with the
rollout's packed weights (`fused_rollout.prepare_params`); see the notes at
the top of the source.

* `scan_reference` is the plain version: the recursion as a Python loop
  (the reference semantics of `_scan_xla`, stove.py:217-302), with all
  three `velocity_obs` modes, actions and the reward head, at
  `dynamics.apply`'s precision: by default the one cfg.compute_dtype asks
  for (JAX's `_scan_xla`), "bfloat16" the TPU kernel's bf16 variant.
* `launch_kernel` checks its inputs, launches once on the current stream
  and counts its launches (`launch_kernel.launches`); `dtype` picks the
  library, and the weight buffer is packed for it: "float32", or
  "bfloat16" (`-DSTOVE_BF16=1`, mma.sync on bf16 operands); the tile is
  `tile_for(B)`.
* `scan_kernel` packs the weights (`prepare_params`) and launches one
  library, bf16 unless told otherwise.
* `scan_fused` is the dispatch `scan_impl="pallas"` takes, as
  `_scan_pallas` (stove.py:304-333): the forward in the kernel's bf16
  whatever compute_dtype is -- the kernel on CUDA tensors (or it raises),
  the plain loop at "bfloat16" on CPU tensors -- and either way the
  gradient of the plain version at cfg.compute_dtype (`ops/_vjp.py`), as
  `_scan_pallas_bwd` differentiates `_scan_xla` at cfg.
  The rewards of the forward are the kernel's: the reward loss is computed
  on them, and its gradient is the plain version's at the same inputs.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from stove_tpu_torch import tree
from stove_tpu_torch.config import Config
from stove_tpu_torch.models import dynamics as dyn_lib
from stove_tpu_torch.models.dynamics import LAT, POS, SIZE, VEL
from stove_tpu_torch.ops import _build, fused_rollout, gaussians
from stove_tpu_torch.ops._vjp import with_plain_vjp

# samples per block (STOVE_TB): the rollout's rule, 16 or, below 132
# blocks, 4 -- 64 blocks at the training batch B=256
tile_for = fused_rollout.tile_for


def check_kernel_dtype(dtype: str) -> str:
    """`dtype`, one of the scan libraries' precisions: the TPU kernel's two
    (`fused_rollout.DTYPES`)."""
    if dtype not in fused_rollout.DTYPES:
        raise ValueError(f"scan kernel dtype {dtype!r}: one of "
                         f"{fused_rollout.DTYPES}")
    return dtype


def scan_reference(dyn_params: Dict, cfg: Config, z1, carry_m, carry_s,
                   sup_mean, sup_std, actions, eps,
                   dtype: Optional[str] = None):
    """The posterior recursion as a plain loop over t.

    z1 (B, O, D); carry_m/carry_s (B, O, 2); sup_mean/sup_std (B, T2, O, 4)
    for t = 2..T−1; actions (B, T2) = a_{t−1}; eps (B, T2, O, D); dtype
    `dynamics.apply`'s precision (None: cfg.compute_dtype's, as
    `_scan_xla`; "bfloat16" for the TPU kernel's bf16 matmuls).
    Returns (z (B,T2,O,D), z_mean (B,T2,O,D), kl (B,), rewards (B,T2)).
    """
    from stove_tpu_torch.models.stove import align_slots

    dtype = dyn_lib.check_precision(dtype, cfg)
    B, T2 = sup_mean.shape[:2]
    z_prev, prev_sup_m, prev_sup_s = z1, carry_m, carry_s
    zs, zms, rews = [], [], []
    kl = z1.new_zeros((B,))
    for t in range(T2):
        dyn = dyn_lib.apply(dyn_params, cfg, z_prev, actions[:, t], dtype)
        d_mean, d_std = dyn.mean, dyn.std

        sm, ss = align_slots(d_mean[..., POS], sup_mean[:, t, :, 2:4],
                             sup_mean[:, t], sup_std[:, t])

        q_pos_m, q_pos_s = gaussians.product(
            sm[..., 2:4], ss[..., 2:4], d_mean[..., POS], d_std[..., POS])
        if cfg.velocity_posterior:
            if cfg.velocity_obs == "filtered":
                v_obs = q_pos_m - prev_sup_m
                v_obs_s = torch.sqrt(q_pos_s ** 2 + prev_sup_s ** 2)
            elif cfg.velocity_obs_full_std:
                v_obs = sm[..., 2:4] - prev_sup_m
                v_obs_s = torch.sqrt(ss[..., 2:4] ** 2 + prev_sup_s ** 2)
            else:
                v_obs = sm[..., 2:4] - z_prev[..., POS]
                v_obs_s = ss[..., 2:4]
            q_vel_m, q_vel_s = gaussians.product(
                v_obs, v_obs_s, d_mean[..., VEL], d_std[..., VEL])
        else:
            q_vel_m, q_vel_s = d_mean[..., VEL], d_std[..., VEL]
        q_size_m, q_size_s = gaussians.product(
            sm[..., 0:2], ss[..., 0:2], d_mean[..., SIZE], d_std[..., SIZE])
        q_lat_m, q_lat_s = d_mean[..., LAT], d_std[..., LAT]

        q_mean = torch.cat([q_size_m, q_pos_m, q_vel_m, q_lat_m], -1)
        q_std = torch.cat([q_size_s, q_pos_s, q_vel_s, q_lat_s], -1)
        z_t = q_mean + q_std * eps[:, t]

        log_p = torch.sum(gaussians.log_prob(z_t, d_mean, d_std), (-2, -1))
        log_q = torch.sum(gaussians.log_prob(z_t, q_mean, q_std), (-2, -1))
        kl = kl + (log_p - log_q)
        zs.append(z_t)
        zms.append(q_mean)
        rews.append(dyn.reward)
        if cfg.velocity_obs == "filtered":
            prev_sup_m, prev_sup_s = q_pos_m, q_pos_s
        else:
            prev_sup_m, prev_sup_s = sm[..., 2:4], ss[..., 2:4]
        z_prev = z_t
    if T2 == 0:
        empty = z1.new_zeros((B, 0) + tuple(z1.shape[1:]))
        return empty, empty, kl, z1.new_zeros((B, 0))
    return (torch.stack(zs, 1), torch.stack(zms, 1), kl,
            torch.stack(rews, 1))


def check_supported(cfg: Config, dyn_params: Dict) -> None:
    """Raise for configurations the kernel does not implement."""
    if cfg.dyn_layers != 2 or cfg.num_obj > 4:
        raise ValueError("the scan kernel needs dyn_layers=2 and num_obj <= 4")
    if cfg.dyn_hidden % 32 or fused_rollout._dout_padded(cfg) > cfg.dyn_hidden:
        raise ValueError("the scan kernel needs dyn_hidden a multiple of 32 "
                         "and >= the padded output width")


def velocity_mode(cfg: Config) -> int:
    """STOVE_VEL_MODE of csrc/scan.cu for this config."""
    if not cfg.velocity_posterior:
        return 0
    if cfg.velocity_obs == "filtered":
        return 3
    return 2 if cfg.velocity_obs_full_std else 1


def job(cfg: Config, dtype: str = "float32",
        tile: int = fused_rollout.SMALL_TILE) -> _build.Job:
    """(source, defines) of the scan library: shapes, the tile (by default
    the training batch's, `tile_for(256)`), the velocity mode, and, as the
    rollout's (`fused_rollout.job`), the action term for an
    action-conditioned config and the reward head when the config has one
    (`fused_rollout.kernel_config` drops it where the params hold none);
    `-DSTOVE_BF16=1` for the bfloat16 library."""
    defines = (f"-DSTOVE_O={cfg.num_obj}", f"-DSTOVE_CL={cfg.cl}",
               f"-DSTOVE_H={cfg.dyn_hidden}", f"-DSTOVE_TB={tile}",
               f"-DSTOVE_VEL_MODE={velocity_mode(cfg)}")
    if cfg.action_conditioned:
        defines += ("-DSTOVE_ACT=1", f"-DSTOVE_NA={cfg.num_actions}")
    if cfg.reward_head:
        defines += ("-DSTOVE_REW=1",)
    if check_kernel_dtype(dtype) == "bfloat16":
        defines += ("-DSTOVE_BF16=1",)
    return ("scan.cu", defines)


def _setup(cfg: Config, dtype: str):
    def setup(lib: ctypes.CDLL) -> None:
        for name in ("stove_scan_param_bytes", "stove_scan_smem_bytes",
                     "stove_scan_tile", "stove_scan_bf16"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        lib.stove_scan_launch.restype = ctypes.c_int
        lib.stove_scan_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2
            + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
        expect = fused_rollout.kernel_bytes(cfg, False, dtype)
        if lib.stove_scan_param_bytes() != expect:
            raise RuntimeError(
                f"scan kernel packs {lib.stove_scan_param_bytes()} bytes, "
                f"kernel_layout {expect}: csrc/dyn_core.cuh and "
                f"fused_rollout.kernel_layout disagree")
        if lib.stove_scan_bf16() != (dtype == "bfloat16"):
            raise RuntimeError("scan library of the wrong precision")
    return setup


def load(cfg: Config, dtype: str = "float32",
         tile: int = fused_rollout.SMALL_TILE) -> ctypes.CDLL:
    src, defines = job(cfg, dtype, tile)
    return _build.load(src, defines, _setup(cfg, dtype))


def prepare_params(dyn_params: Dict, cfg: Config,
                   dtype: str = "float32") -> torch.Tensor:
    """The scan's weight buffer for `dtype`: the rollout kernel's
    (`fused_rollout.prepare_params`) without the open-loop std head, which
    the scan does not run (a buffer with it holds this one as its
    prefix)."""
    return fused_rollout.prepare_params(
        {k: v for k, v in dyn_params.items() if k != "open"}, cfg, dtype)


def launch_kernel(prepared: torch.Tensor, cfg: Config, z1, carry_m, carry_s,
                  sup_mean, sup_std, eps, actions=None, dtype: str = "float32"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """One launch → (z, z_mean (B, T2, O, D), kl (B,), rewards (B, T2));
    CUDA f32 tensors only, `prepared` the uint8 buffer of `prepare_params`
    for `dtype`, the library's matmul precision; the tile is `tile_for(B)`.
    An action-conditioned config reads `actions` (B, T2) integers (zeros
    when None, as `dynamics.apply` does); the rewards are zeros without a
    reward head.  Counts its launches in `launch_kernel.launches` and, by
    library (its defines, as `job` gives them),
    `launch_kernel.by_library`."""
    dtype = check_kernel_dtype(dtype)
    ins = [z1, carry_m, carry_s, sup_mean, sup_std, eps]
    _build.check_device(prepared, *ins)
    if any(x.dtype != torch.float32 for x in ins):
        raise TypeError("the scan kernel takes float32 tensors")
    if prepared.dtype != torch.uint8 or prepared.dim() != 1 \
            or not prepared.is_contiguous():
        raise TypeError("the scan kernel takes the flat uint8 buffer of "
                        "prepare_params")
    B, O, D = z1.shape
    T2 = sup_mean.shape[1]
    want = {"z1": (B, O, D), "carry_m": (B, O, 2), "carry_s": (B, O, 2),
            "sup_mean": (B, T2, O, 4), "sup_std": (B, T2, O, 4),
            "eps": (B, T2, O, D)}
    for (name, shape), x in zip(want.items(), ins):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, the scan "
                             f"kernel expects {shape}")
    if O != cfg.num_obj or D != cfg.full_state_dim:
        raise ValueError(f"z1 shape {tuple(z1.shape)} does not match the "
                         f"config (O={cfg.num_obj}, D={cfg.full_state_dim})")
    if prepared.numel() != fused_rollout.kernel_bytes(cfg, False, dtype):
        raise ValueError(f"packed dynamics params have the wrong size for "
                         f"this config and dtype {dtype}")
    ins = [x.contiguous() for x in ins]
    acts = fused_rollout.int32_actions(cfg, actions, B, T2, z1)
    z = torch.empty((B, T2, O, D), dtype=torch.float32, device=z1.device)
    zm = torch.empty_like(z)
    if B == 0 or T2 == 0:
        return z, zm, z1.new_zeros((B,)), z1.new_zeros((B, T2))
    # the kernel writes every kl and, with the head, every reward
    kl = torch.empty((B,), dtype=torch.float32, device=z1.device)
    rewards = (torch.empty if cfg.reward_head else torch.zeros)(
        (B, T2), dtype=torch.float32, device=z1.device)
    tile = tile_for(B)
    lib = load(cfg, dtype, tile)
    with torch.cuda.device(z1.device):
        err = lib.stove_scan_launch(
            *[x.data_ptr() for x in ins],
            None if acts is None else acts.data_ptr(), prepared.data_ptr(),
            z.data_ptr(), zm.data_ptr(), kl.data_ptr(),
            rewards.data_ptr() if cfg.reward_head else None, B, T2,
            cfg.size_std, cfg.min_dyn_std, cfg.max_dyn_std,
            int(cfg.latent_residual), _build.stream_of(z1))
    if err != 0:
        raise RuntimeError(f"scan kernel launch failed: CUDA error {err}")
    launch_kernel.launches += 1
    key = " ".join(job(cfg, dtype, tile)[1])
    launch_kernel.by_library[key] = launch_kernel.by_library.get(key, 0) + 1
    return z, zm, kl, rewards


launch_kernel.launches = 0
launch_kernel.by_library = {}     # launches by library (its defines)


def scan_kernel(dyn_params: Dict, cfg: Config, z1, carry_m, carry_s,
                sup_mean, sup_std, actions, eps, dtype: str = "bfloat16"):
    """The kernel with `scan_reference`'s arguments and outputs: the
    weights packed on their device (`prepare_params`, once a call) and one
    launch of the `dtype` library; CUDA tensors only."""
    kcfg = fused_rollout.kernel_config(cfg, dyn_params)
    prepared = prepare_params(dyn_params, cfg, dtype)
    return launch_kernel(prepared, kcfg, z1, carry_m, carry_s, sup_mean,
                         sup_std, eps, actions, dtype)


def scan_fused(dyn_params: Dict, cfg: Config, z1, carry_m, carry_s,
               sup_mean, sup_std, actions, eps):
    """`scan_impl="pallas"`: same arguments and outputs as
    `scan_reference`; the forward in the kernel's bf16, as `_scan_pallas`
    prepares its weights -- `scan_kernel` on CUDA tensors, the plain loop
    at "bfloat16" on CPU tensors -- and on both the gradient of the plain
    version at cfg.compute_dtype (as `_scan_pallas_bwd`)."""
    template = dyn_params
    n = len(tree.leaves(template))

    def on_leaves(fn, **kw):
        return lambda *args: fn(tree.unflatten(template, list(args[:n])),
                                cfg, *args[n:], **kw)

    inputs = (*tree.leaves(dyn_params), z1, carry_m, carry_s, sup_mean,
              sup_std, actions, eps)
    if z1.device.type == "cuda":
        check_supported(cfg, dyn_params)
        fast = on_leaves(scan_kernel)
    elif z1.device.type == "cpu":
        fast = on_leaves(scan_reference, dtype="bfloat16")
    else:
        raise ValueError(f"the scan runs on cuda or cpu, not {z1.device}")
    return with_plain_vjp(fast, on_leaves(scan_reference), *inputs)
