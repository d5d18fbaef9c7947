"""Fused whole-horizon rollout: one hand-written CUDA kernel for all H steps.

Counterpart of `stove_tpu/ops/pallas_rollout.py::rollout_states` and
`::rollout_act`.  The kernel (`csrc/rollout.cu`) runs the graph-net rollout
of `models/dynamics.apply` for H steps in one launch, mean or sampled, with
the state and every activation kept on chip; for an action-conditioned
model it takes the per-step actions, and with a reward head it returns the
per-step raw reward probabilities.  See the notes at the top of the source
for its bound and design.

* `load` compiles the source with plain `nvcc` for sm_90a into a shared
  library under `build/kernels/` (listed in .gitignore) at first use and
  loads it with ctypes (`ops/_build.py`).  Shapes and heads are
  compile-time (-D flags from the config, `job`), so a library is built
  once per (O, cl, h, actions, reward head, open-loop std head) and reused
  by content hash; the action-free model's library has no action or reward
  code, and only the sampled rollout of a model with an open-loop std head
  launches the library that has it.
* `prepare_params` packs the dynamics weights into the one flat f32 buffer
  the kernel reads (`param_layout` gives its order).
* `launch_kernel` checks device, dtype, shape and contiguity, allocates
  the output and launches on the current stream; `launch_kernel.launches`
  counts its launches.
* `rollout` is the one device dispatch (`rollout_states` returns its
  states): on a CUDA tensor it launches the kernel (or raises); on a CPU
  tensor it runs `rollout_states_reference`, the plain PyTorch loop over
  `dynamics.apply`, with noise drawn from the caller's generator.  There
  is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Tuple

import torch

from stove_tpu_torch.config import Config
from stove_tpu_torch.models import dynamics as dyn_lib
from stove_tpu_torch.ops import _build

TILE = 16          # samples per block (STOVE_TB)


def _dout(cfg: Config) -> int:
    return 6 + 2 * cfg.cl            # dv(2) + dl(cl) + raw std(4 + cl)


def _dout_padded(cfg: Config) -> int:
    return (_dout(cfg) + 63) // 64 * 64


def _open_padded(cfg: Config) -> int:
    return (4 + cfg.cl + 31) // 32 * 32   # OPP of csrc/dyn_core.cuh


def has_open_head(cfg: Config, params: Dict) -> bool:
    """Whether sampled rollouts draw with the open-loop std head, as
    `dynamics.apply`'s `std_open` does."""
    return bool(cfg.open_loop_sigma) and "open" in params


def param_layout(cfg: Config, open_head: bool = False
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of each segment of the packed buffer, in order.

    Matches the OFF_* constants of csrc/dyn_core.cuh.  Weights are (in,
    out): the kernel reads W[k, n0:n0+4] as one float4.  An
    action-conditioned config adds embed[0]'s action rows; a reward head
    adds both heads' first layers side by side as one (2h, 2h) matrix over
    [s ; r], their contact-gap and min-distance rows, their second layers
    and their last columns; `open_head` last, the open-loop std head's
    first layer over [s ; r] and its last layer, zero-padded to a multiple
    of 32 columns (the order of pallas_rollout.py's _OPEN_PARAMS after the
    others, :510).  A buffer with the open head is thus the buffer without
    it followed by the head.
    """
    D, h, dp = cfg.full_state_dim, cfg.dyn_hidden, _dout_padded(cfg)
    extra = []
    if cfg.action_conditioned:
        extra.append(("w_e0a", (cfg.num_actions, h)))
    if cfg.reward_head:
        extra += [("w_h0", (2 * h, 2 * h)), ("b_h0", (2 * h,)),
                  ("w_hg", (2 * h,)), ("w_hd", (2 * h,)),
                  ("w_rw1", (h, h)), ("b_rw1", (h,)),
                  ("w_ra1", (h, h)), ("b_ra1", (h,)),
                  ("w_h2", (2 * h,)), ("b_h2", (4,))]
    if open_head:
        op = _open_padded(cfg)
        extra += [("w_op0", (2 * h, h)), ("b_op0", (h,)),
                  ("w_op1", (h, op)), ("b_op1", (op,))]
    return [
        ("w_e0", (D, h)), ("b_e0", (h,)),
        ("w_e1", (h, h)), ("b_e1", (h,)),
        ("w_s0", (h, h)), ("b_s0", (h,)),
        ("w_s1", (h, h)), ("b_s1", (h,)),
        ("w_rs", (h, 2 * h)), ("b_r0", (h,)),
        ("w_r1", (h, h)), ("b_r1", (h,)),
        ("w_rf", (h, h)), ("b_rf", (h,)),
        ("w_ra", (h,)), ("b_ra", (4,)),
        ("w_o0", (2 * h, h)), ("b_o0", (h,)),
        ("w_o1", (h, h)), ("b_o1", (h,)),
        ("w_o2", (h, dp)), ("b_o2", (dp,)),
    ] + extra


def kernel_config(cfg: Config, params: Dict) -> Config:
    """The config the kernels are built and packed for: with a reward head
    only when the params hold one, as `dynamics.apply` and the reference's
    kernels (pallas_scan.py:227-229) compute it only then."""
    if cfg.reward_head and "reward" not in params:
        return cfg.with_overrides(reward_head=False)
    return cfg


def check_supported(cfg: Config, params: Dict) -> None:
    """Raise for configurations the kernel does not implement."""
    if cfg.dyn_layers != 2:
        raise ValueError(f"fused rollout needs dyn_layers=2, got "
                         f"{cfg.dyn_layers}")
    if has_open_head(cfg, params) and len(params["open"]) != 2:
        raise ValueError("the kernel's open-loop std head is a two-layer "
                         f"MLP; the params have {len(params['open'])}")
    if cfg.dyn_hidden % 32 or _dout_padded(cfg) > cfg.dyn_hidden:
        raise ValueError("fused rollout needs dyn_hidden a multiple of 32 "
                         "and >= the padded output width")


def prepare_params(dyn_params: Dict, cfg: Config) -> torch.Tensor:
    """Pack the dynamics weights into the kernel's flat f32 buffer.

    Counterpart of `pallas_rollout.prepare_params`: the first relational
    layer is split into receiver (rows [0, h)) and sender (rows [h, 2h))
    halves, laid side by side as one (h, 2h) matrix so both come out of one
    matmul; the last relational layer into its h feature columns and its
    attention column; output layer 0 into self and relational halves,
    stacked along K to contract [s ; r] at once.  The last output layer is
    zero-padded to a multiple of 64 columns.  embed[0]'s action rows, the
    reward heads and, when sampled rollouts use it, the open-loop std head
    follow (`param_layout`).  The buffer lives on the weights' device.
    """
    check_supported(cfg, dyn_params)
    return pack_params(dyn_params, kernel_config(cfg, dyn_params),
                       has_open_head(cfg, dyn_params))


def pack_params(dyn_params: Dict, cfg: Config, open_head: bool = False
                ) -> torch.Tensor:
    """The packing of `prepare_params` without its support check: the
    posterior scan kernel (ops/fused_scan.py) reads the same buffer
    without the open-loop head and checks what it supports itself."""
    p = dyn_params
    h, D = cfg.dyn_hidden, cfg.full_state_dim
    w_rel0, w_rel2, b_rel2 = p["rel"][0]["w"], p["rel"][2]["w"], p["rel"][2]["b"]
    w_out0 = p["out"][0]["w"]
    w_o0s, w_o0r = w_out0[:h], w_out0[h:]
    dp = _dout_padded(cfg)
    w_o2 = torch.zeros((h, dp), dtype=torch.float32, device=w_out0.device)
    w_o2[:, :_dout(cfg)] = p["out"][2]["w"]
    b_o2 = torch.zeros((dp,), dtype=torch.float32, device=w_out0.device)
    b_o2[:_dout(cfg)] = p["out"][2]["b"]
    b_ra = torch.zeros((4,), dtype=torch.float32, device=w_out0.device)
    b_ra[0] = b_rel2[-1]
    seg = {
        "w_e0": p["embed"][0]["w"][:D], "b_e0": p["embed"][0]["b"],
        "w_e1": p["embed"][1]["w"], "b_e1": p["embed"][1]["b"],
        "w_s0": p["self"][0]["w"], "b_s0": p["self"][0]["b"],
        "w_s1": p["self"][1]["w"], "b_s1": p["self"][1]["b"],
        "w_rs": torch.cat([w_rel0[:h], w_rel0[h:]], dim=1),
        "b_r0": p["rel"][0]["b"],
        "w_r1": p["rel"][1]["w"], "b_r1": p["rel"][1]["b"],
        "w_rf": w_rel2[:, :-1], "b_rf": b_rel2[:-1],
        "w_ra": w_rel2[:, -1], "b_ra": b_ra,
        "w_o0": torch.cat([w_o0s, w_o0r], dim=0), "b_o0": p["out"][0]["b"],
        "w_o1": p["out"][1]["w"], "b_o1": p["out"][1]["b"],
        "w_o2": w_o2, "b_o2": b_o2,
    }
    if cfg.action_conditioned:
        seg["w_e0a"] = p["embed"][0]["w"][D:]
    if cfg.reward_head:
        rw, ra = p["reward"], p["reward_att"]
        b_h2 = torch.zeros((4,), dtype=torch.float32, device=w_out0.device)
        b_h2[0], b_h2[1] = rw[2]["b"][0], ra[2]["b"][0]
        seg.update({
            "w_h0": torch.cat([rw[0]["w"][:2 * h], ra[0]["w"][:2 * h]], 1),
            "b_h0": torch.cat([rw[0]["b"], ra[0]["b"]]),
            "w_hg": torch.cat([rw[0]["w"][2 * h], ra[0]["w"][2 * h]]),
            "w_hd": torch.cat([rw[0]["w"][2 * h + 1], ra[0]["w"][2 * h + 1]]),
            "w_rw1": rw[1]["w"], "b_rw1": rw[1]["b"],
            "w_ra1": ra[1]["w"], "b_ra1": ra[1]["b"],
            "w_h2": torch.cat([rw[2]["w"][:, 0], ra[2]["w"][:, 0]]),
            "b_h2": b_h2,
        })
    if open_head:
        op0, op1 = p["open"]
        w_op1 = torch.zeros((h, _open_padded(cfg)), dtype=torch.float32,
                            device=w_out0.device)
        w_op1[:, :4 + cfg.cl] = op1["w"]
        b_op1 = torch.zeros((_open_padded(cfg),), dtype=torch.float32,
                            device=w_out0.device)
        b_op1[:4 + cfg.cl] = op1["b"]
        seg.update({"w_op0": op0["w"], "b_op0": op0["b"], "w_op1": w_op1,
                    "b_op1": b_op1})
    parts = []
    for name, shape in param_layout(cfg, open_head):
        t = seg[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel "
                             f"expects {shape}")
        parts.append(t.reshape(-1).to(torch.float32))
    return torch.cat(parts).contiguous()


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def rollout_states_reference(dyn_params: Dict, cfg: Config, z0: torch.Tensor,
                             horizon: int,
                             noise: Optional[torch.Tensor] = None,
                             actions: Optional[torch.Tensor] = None,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H steps of `dynamics.apply`, mean (noise None) or sampled.

    noise: (B, H, O, D) standard normals; sampled steps inject
    mean + (std_open · rollout_sigma_temp) · ε, as `stove.rollout` does.
    actions: (B, H) or None.  Returns (states (B, H, O, D), rewards (B, H)).
    """
    zs, rs = [], []
    z = z0
    for t in range(horizon):
        a = None if actions is None else actions[:, t]
        dyn = dyn_lib.apply(dyn_params, cfg, z, a)
        z = dyn.mean
        if noise is not None:
            z = z + (dyn.std_open * cfg.rollout_sigma_temp) * noise[:, t]
        zs.append(z)
        rs.append(dyn.reward)
    B = z0.shape[0]
    if not zs:
        return (z0.new_zeros((B, 0) + tuple(z0.shape[1:])),
                z0.new_zeros((B, 0)))
    return torch.stack(zs, 1), torch.stack(rs, 1)


# --------------------------------------------------------------------------
# the CUDA kernel
# --------------------------------------------------------------------------

def job(cfg: Config, open_head: bool = False) -> _build.Job:
    """(source, defines) of the rollout library for this config's shapes
    and heads; `open_head` for the sampled rollout of a model with an
    open-loop std head (`has_open_head`)."""
    defines = (f"-DSTOVE_O={cfg.num_obj}", f"-DSTOVE_CL={cfg.cl}",
               f"-DSTOVE_H={cfg.dyn_hidden}", f"-DSTOVE_TB={TILE}")
    if cfg.action_conditioned:
        defines += ("-DSTOVE_ACT=1", f"-DSTOVE_NA={cfg.num_actions}")
    if cfg.reward_head:
        defines += ("-DSTOVE_REW=1",)
    if open_head:
        defines += ("-DSTOVE_OPEN=1",)
    return ("rollout.cu", defines)


def param_count(cfg: Config, open_head: bool = False) -> int:
    return sum(math.prod(s) for _, s in param_layout(cfg, open_head))


def _setup(cfg: Config, open_head: bool):
    def setup(lib: ctypes.CDLL) -> None:
        lib.stove_rollout_param_count.restype = ctypes.c_int
        lib.stove_rollout_param_count.argtypes = []
        lib.stove_rollout_smem_bytes.restype = ctypes.c_int
        lib.stove_rollout_smem_bytes.argtypes = []
        lib.stove_rollout_launch.restype = ctypes.c_int
        lib.stove_rollout_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # z0, P, actions
            ctypes.c_void_p, ctypes.c_void_p,                    # out, rewards
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, sample
            ctypes.c_uint64,                                     # seed
            ctypes.c_float, ctypes.c_float, ctypes.c_float,      # size_std, lo, hi
            ctypes.c_float, ctypes.c_int,                        # temp, latent_residual
            ctypes.c_void_p,                                     # stream
        ]
        expect = param_count(cfg, open_head)
        if lib.stove_rollout_param_count() != expect:
            raise RuntimeError(
                f"kernel packs {lib.stove_rollout_param_count()} params, "
                f"param_layout {expect}: csrc/dyn_core.cuh and "
                f"fused_rollout.param_layout disagree (each of the action, "
                f"reward and open-loop variants has its own count)")
    return setup


def load(cfg: Config, open_head: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the kernel library for `cfg`."""
    src, defines = job(cfg, open_head)
    return _build.load(src, defines, _setup(cfg, open_head))


def int32_actions(cfg: Config, actions: Optional[torch.Tensor], B: int,
                  steps: int, like: torch.Tensor) -> Optional[torch.Tensor]:
    """The (B, steps) actions a kernel of an action-conditioned config
    reads, as contiguous int32 on `like`'s device (zeros when None, as
    `dynamics.apply` does); None for other configs."""
    if not cfg.action_conditioned:
        return None
    if actions is None:
        return torch.zeros((B, steps), dtype=torch.int32, device=like.device)
    if tuple(actions.shape) != (B, steps):
        raise ValueError(f"actions shape {tuple(actions.shape)}, expected "
                         f"{(B, steps)}")
    if actions.dtype.is_floating_point or actions.dtype == torch.bool:
        raise TypeError("actions must be integers")
    _build.check_device(like, actions)
    return actions.to(torch.int32).contiguous()


def launch_kernel(prepared: torch.Tensor, cfg: Config, z0: torch.Tensor,
                  horizon: int, sample: bool, seed: int,
                  actions: Optional[torch.Tensor] = None,
                  open_head: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs, allocate the outputs and launch the kernel once on
    the current stream: (states (B, H, O, D), rewards (B, H)), the rewards
    zeros without a reward head.  An action-conditioned config takes
    `actions` (B, H) integers on z0's device (zeros when None, as
    `dynamics.apply` does).  `open_head` (sampled only) launches the
    library with the open-loop std head, whose stds are floored at
    `min_open_std`; it needs `prepared` packed with the head, which the
    other libraries read as its prefix.  Takes CUDA tensors only.
    `launch_kernel.launches` counts the launches (a run sets it to 0 and
    reads it after)."""
    if open_head and not sample:
        raise ValueError("the open-loop std head sets the sampled noise "
                         "only; a mean rollout launches without it")
    _build.check_device(z0, prepared)
    if z0.dtype != torch.float32 or prepared.dtype != torch.float32:
        raise TypeError("fused rollout takes float32 z0 and params")
    B, O, D = z0.shape
    if O != cfg.num_obj or D != cfg.full_state_dim:
        raise ValueError(f"z0 shape {tuple(z0.shape)} does not match the "
                         f"config (O={cfg.num_obj}, D={cfg.full_state_dim})")
    if prepared.dim() != 1:
        raise ValueError("prepared params must be a flat buffer on z0's "
                         "device (use prepare_params)")
    if not (z0.is_contiguous() and prepared.is_contiguous()):
        raise ValueError("fused rollout needs contiguous z0 and params")
    acts = int32_actions(cfg, actions, B, horizon, z0)
    rewards = z0.new_zeros((B, max(horizon, 0)))
    if horizon <= 0 or B == 0:
        return z0.new_empty((B, max(horizon, 0), O, D)), rewards
    lib = load(cfg, open_head)
    sizes = {lib.stove_rollout_param_count()}
    if not open_head and cfg.open_loop_sigma:
        sizes.add(param_count(cfg, True))     # the head's buffer, as prefix
    if prepared.numel() not in sizes:
        raise ValueError("prepared params have the wrong size for this "
                         "config" + (" (packed without the open-loop head?)"
                                     if open_head else ""))
    out = torch.empty((B, horizon, O, D), dtype=torch.float32,
                      device=z0.device)
    lo = cfg.min_open_std if open_head else cfg.min_dyn_std
    hi = cfg.max_dyn_std
    with torch.cuda.device(z0.device):
        err = lib.stove_rollout_launch(
            z0.data_ptr(), prepared.data_ptr(),
            None if acts is None else acts.data_ptr(), out.data_ptr(),
            rewards.data_ptr() if cfg.reward_head else None, B, horizon,
            int(sample), seed, cfg.size_std, lo, hi, cfg.rollout_sigma_temp,
            int(cfg.latent_residual), _build.stream_of(z0))
    if err != 0:
        raise RuntimeError(f"rollout kernel launch failed: CUDA error {err}")
    launch_kernel.launches += 1
    return out, rewards


launch_kernel.launches = 0


def rollout(dyn_params: Dict, cfg: Config, z0: torch.Tensor, horizon: int,
            sample: bool = True, generator: Optional[torch.Generator] = None,
            prepared: Optional[torch.Tensor] = None,
            actions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one device dispatch of the rollout: (states, rewards).

    z0: (B, O, 6+cl) f32 → states (B, horizon, O, 6+cl), rewards
    (B, horizon) (the reward head's raw probabilities; zeros without one).
    actions: (B, horizon) integers, read by an action-conditioned config.
    On a CUDA tensor this launches the kernel (building it at first use)
    and raises if it cannot (`check_supported`); a sampled rollout of a
    model with an open-loop std head launches the library with the head.  `prepared` is
    `prepare_params(dyn_params, cfg)` cached by the caller (computed here
    when absent); the sampled kernel draws its noise in-kernel from a seed
    taken from `generator`.  On a CPU tensor it runs
    `rollout_states_reference` with standard normals drawn from
    `generator`.
    """
    B = z0.shape[0]
    if z0.device.type == "cuda":
        check_supported(cfg, dyn_params)
        if prepared is None:
            prepared = prepare_params(dyn_params, cfg)
        seed = 0
        if sample:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=generator.device
                                     if generator is not None else "cpu"))
        return launch_kernel(prepared, kernel_config(cfg, dyn_params), z0,
                             horizon, sample, seed, actions,
                             sample and has_open_head(cfg, dyn_params))
    if z0.device.type != "cpu":
        raise ValueError(f"fused rollout runs on cuda or cpu, not "
                         f"{z0.device}")
    noise = None
    if sample:
        noise = torch.randn((B, horizon) + tuple(z0.shape[1:]),
                            generator=generator, dtype=z0.dtype)
    return rollout_states_reference(dyn_params, cfg, z0, horizon, noise,
                                    actions)


def rollout_states(dyn_params: Dict, cfg: Config, z0: torch.Tensor,
                   horizon: int, sample: bool = True,
                   generator: Optional[torch.Generator] = None,
                   prepared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Counterpart of `pallas_rollout.rollout_states`: the rollout's states
    (B, horizon, O, 6+cl) without actions, through `rollout`."""
    return rollout(dyn_params, cfg, z0, horizon, sample, generator,
                   prepared)[0]
