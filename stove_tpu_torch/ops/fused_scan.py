"""The posterior recursion of a window as one hand-written CUDA kernel.

Counterpart of `stove_tpu/ops/pallas_scan.py::scan_fused` and of the
custom-VJP dispatch `_scan_pallas` in `stove_tpu/models/stove.py`.  The
kernel (`csrc/scan.cu`) runs the T−2 posterior steps of one window per
block of TB samples, with the rollout's dynamics core (`csrc/dyn_core.cuh`)
and the packed weights of `fused_rollout.pack_params`; see the notes at
the top of the source.

* `scan_reference` is the plain version: the recursion as a Python loop
  (the reference semantics of `_scan_xla`, stove.py:217-302), with all
  three `velocity_obs` modes, actions and the reward head.
* `launch_kernel` checks its inputs, launches once on the current stream
  and counts its launches (`launch_kernel.launches`).
* `scan_fused` is the dispatch `scan_impl="pallas"` takes: the kernel on
  CUDA tensors (or it raises), the plain version on CPU tensors, and
  either way the gradient of the plain version (`ops/_vjp.py`).  The
  rewards of the forward are the kernel's: the reward loss is computed on
  them, and its gradient is the plain version's at the same inputs.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from stove_tpu_torch import tree
from stove_tpu_torch.config import Config
from stove_tpu_torch.models import dynamics as dyn_lib
from stove_tpu_torch.models.dynamics import LAT, POS, SIZE, VEL
from stove_tpu_torch.ops import _build, fused_rollout, gaussians
from stove_tpu_torch.ops._vjp import with_plain_vjp

TILE = 8           # samples per block (STOVE_TB): 32 blocks at B=256


def scan_reference(dyn_params: Dict, cfg: Config, z1, carry_m, carry_s,
                   sup_mean, sup_std, actions, eps):
    """The posterior recursion as a plain loop over t.

    z1 (B, O, D); carry_m/carry_s (B, O, 2); sup_mean/sup_std (B, T2, O, 4)
    for t = 2..T−1; actions (B, T2) = a_{t−1}; eps (B, T2, O, D).
    Returns (z (B,T2,O,D), z_mean (B,T2,O,D), kl (B,), rewards (B,T2)).
    """
    from stove_tpu_torch.models.stove import align_slots

    B, T2 = sup_mean.shape[:2]
    z_prev, prev_sup_m, prev_sup_s = z1, carry_m, carry_s
    zs, zms, rews = [], [], []
    kl = z1.new_zeros((B,))
    for t in range(T2):
        dyn = dyn_lib.apply(dyn_params, cfg, z_prev, actions[:, t])
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


def job(cfg: Config) -> _build.Job:
    """(source, defines) of the scan library: shapes, the velocity mode,
    and, as the rollout's (`fused_rollout.job`), the action term for an
    action-conditioned config and the reward head when the config has one
    (`fused_rollout.kernel_config` drops it where the params hold none)."""
    defines = (f"-DSTOVE_O={cfg.num_obj}", f"-DSTOVE_CL={cfg.cl}",
               f"-DSTOVE_H={cfg.dyn_hidden}", f"-DSTOVE_TB={TILE}",
               f"-DSTOVE_VEL_MODE={velocity_mode(cfg)}")
    if cfg.action_conditioned:
        defines += ("-DSTOVE_ACT=1", f"-DSTOVE_NA={cfg.num_actions}")
    if cfg.reward_head:
        defines += ("-DSTOVE_REW=1",)
    return ("scan.cu", defines)


def _setup(cfg: Config):
    def setup(lib: ctypes.CDLL) -> None:
        for name in ("stove_scan_param_count", "stove_scan_smem_bytes",
                     "stove_scan_tile"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        lib.stove_scan_launch.restype = ctypes.c_int
        lib.stove_scan_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2
            + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
        expect = fused_rollout.param_count(cfg)
        if lib.stove_scan_param_count() != expect:
            raise RuntimeError(
                f"scan kernel packs {lib.stove_scan_param_count()} params, "
                f"param_layout {expect}: csrc/dyn_core.cuh and "
                f"fused_rollout.param_layout disagree")
    return setup


def load(cfg: Config) -> ctypes.CDLL:
    src, defines = job(cfg)
    return _build.load(src, defines, _setup(cfg))


def launch_kernel(prepared: torch.Tensor, cfg: Config, z1, carry_m, carry_s,
                  sup_mean, sup_std, eps, actions=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """One launch → (z, z_mean (B, T2, O, D), kl (B,), rewards (B, T2));
    CUDA f32 only.  An action-conditioned config reads `actions` (B, T2)
    integers (zeros when None, as `dynamics.apply` does); the rewards are
    zeros without a reward head."""
    ins = [z1, carry_m, carry_s, sup_mean, sup_std, eps]
    _build.check_device(prepared, *ins)
    if any(x.dtype != torch.float32 for x in [prepared] + ins):
        raise TypeError("the scan kernel takes float32 tensors")
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
    ins = [x.contiguous() for x in ins]
    acts = fused_rollout.int32_actions(cfg, actions, B, T2, z1)
    z = torch.empty((B, T2, O, D), dtype=torch.float32, device=z1.device)
    zm = torch.empty_like(z)
    kl = torch.zeros((B,), dtype=torch.float32, device=z1.device)
    rewards = torch.zeros((B, T2), dtype=torch.float32, device=z1.device)
    if B == 0 or T2 == 0:
        return z, zm, kl, rewards
    lib = load(cfg)
    if prepared.numel() != lib.stove_scan_param_count():
        raise ValueError("packed dynamics params have the wrong size")
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
    return z, zm, kl, rewards


launch_kernel.launches = 0


def scan_fused(dyn_params: Dict, cfg: Config, z1, carry_m, carry_s,
               sup_mean, sup_std, actions, eps):
    """`scan_impl="pallas"`: same arguments and outputs as
    `scan_reference`; the kernel on CUDA tensors, the plain version on CPU
    tensors, the plain version's gradient on both."""
    template = dyn_params
    n = len(tree.leaves(template))

    def plain(*args):
        return scan_reference(tree.unflatten(template, list(args[:n])), cfg,
                              *args[n:])

    kcfg = fused_rollout.kernel_config(cfg, dyn_params)

    def fast(*args):
        z1_, cm, cs, smean, sstd, acts, ep = args[n:]
        packed = fused_rollout.pack_params(
            tree.unflatten(template, list(args[:n])), kcfg)
        return launch_kernel(packed, kcfg, z1_, cm, cs, smean, sstd, ep, acts)

    inputs = (*tree.leaves(dyn_params), z1, carry_m, carry_s, sup_mean,
              sup_std, actions, eps)
    if z1.device.type == "cuda":
        check_supported(cfg, dyn_params)
        return with_plain_vjp(fast, plain, *inputs)
    if z1.device.type != "cpu":
        raise ValueError(f"the scan runs on cuda or cpu, not {z1.device}")
    return with_plain_vjp(plain, plain, *inputs)
