"""Graph-net transition model p(z_t | z_{t−1}, a_{t−1}).

Counterpart of `stove_tpu/models/dynamics.py` (`init_params`, `apply`):
per-object embed and self MLPs, a relational MLP over all ordered pairs
whose first layer is factored into receiver and sender halves,
attention-gated pair sums with the diagonal masked, an output MLP giving
(Δv, Δℓ, raw σ), Euler integration, and the optional open-loop std head
and geometry-aware reward head.  Parameters are the JAX tree's dicts/lists with (in, out) weights.

State layout per object: z_o = [sx, sy, x, y, vx, vy, ℓ_1..ℓ_cl].
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from stove_tpu_torch.config import Config
from stove_tpu_torch.ops import gaussians

# state slicing
SIZE = slice(0, 2)
POS = slice(2, 4)
VEL = slice(4, 6)
LAT = slice(6, None)


class DynOut(NamedTuple):
    mean: torch.Tensor      # (B, O, 6+cl) predicted next-state mean
    std: torch.Tensor       # (B, O, 6+cl) transition std (sizes: size_std)
    reward: torch.Tensor    # (B,) predicted reward (zeros without a head)
    std_open: torch.Tensor  # (B, O, 6+cl) open-loop std (aliases std
    #   unless cfg.open_loop_sigma and the checkpoint has the head)


def _mlp_init(generator, sizes, scale: float, device):
    return [{"w": (torch.randn((din, dout), generator=generator)
                   * (scale / din) ** 0.5).to(device),
             "b": torch.zeros((dout,), device=device)}
            for din, dout in zip(sizes[:-1], sizes[1:])]


def init_params(cfg: Config, generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """Counterpart of `dynamics.init_params` (dynamics.py:71): dense
    weights N(0, 2/fan_in) (the output MLP at 1/fan_in, its last layer zero
    so the transition starts as the identity flow), zero biases; the
    open-loop std and reward heads when the config asks for them."""
    h = cfg.dyn_hidden
    d_in = cfg.full_state_dim + (cfg.num_actions if cfg.action_conditioned
                                 else 0)
    d_out = 2 + cfg.cl + (4 + cfg.cl)
    hid = [h] * cfg.dyn_layers
    params = {
        "embed": _mlp_init(generator, [d_in] + hid, 2.0, device),
        "self": _mlp_init(generator, [h] + hid, 2.0, device),
        "rel": _mlp_init(generator, [2 * h] + hid + [h + 1], 2.0, device),
        "out": _mlp_init(generator, [2 * h] + hid + [d_out], 1.0, device),
    }
    params["out"][-1]["w"] = torch.zeros_like(params["out"][-1]["w"])
    if cfg.open_loop_sigma:
        params["open"] = _mlp_init(generator, [2 * h, h, 4 + cfg.cl], 2.0,
                                   device)
    if cfg.reward_head:
        params["reward"] = _mlp_init(generator, [2 * h + 2] + hid + [1], 2.0,
                                     device)
        params["reward_att"] = _mlp_init(generator, [2 * h + 2] + hid + [1],
                                         2.0, device)
    return params


# The dynamics' three precisions.  "float32"; "dense_bf16", the dense
# path under compute_dtype=bfloat16 (dynamics.py:61-68, :120): both
# operands of every product rounded to bfloat16 -- the relational attention
# column, recv and send, every layer of the open and both reward heads
# with their geometry rows and last columns included -- sums in float32;
# "bfloat16", the TPU kernels' bf16 variant (pallas_rollout.py::make_mm),
# which rounds the same products but for the attention column and the
# reward heads' geometry rows and last layers, which it keeps in float32.
# The last is what `scan_impl=pallas` and the `pallas` planner leaves run
# whatever compute_dtype is; the first two follow compute_dtype.
PRECISIONS = ("float32", "bfloat16", "dense_bf16")


def precision_of(cfg: Config) -> str:
    """The precision `cfg.compute_dtype` asks of the dense path."""
    return "dense_bf16" if cfg.compute_dtype == "bfloat16" else "float32"


def check_precision(precision: Optional[str], cfg: Config) -> str:
    """`precision`, or `cfg`'s when None; ValueError for an unknown one."""
    precision = precision_of(cfg) if precision is None else precision
    if precision not in PRECISIONS:
        raise ValueError(f"precision (dtype) {precision!r}: one of "
                         f"{PRECISIONS}")
    return precision


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest even) and back to its dtype; its
    gradient is rounded so too, as the cotangent of JAX's astype is."""
    return x.to(torch.bfloat16).to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor, bf16: bool = False
           ) -> torch.Tensor:
    """x @ w; with `bf16` both operands rounded to bfloat16 first and the
    products summed in x's dtype (an exact bf16 x bf16 product, f32 sums:
    `jnp.dot(..., preferred_element_type=f32)`, and the TPU kernels'
    make_mm)."""
    return bf16_round(x) @ bf16_round(w) if bf16 else x @ w


def mlp(layers, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Dense stack x @ w + b with ReLU between layers, none after the last."""
    for i, lyr in enumerate(layers):
        x = matmul(x, lyr["w"], bf16) + lyr["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def apply(params: Dict, cfg: Config, z: torch.Tensor,
          action: Optional[torch.Tensor] = None,
          precision: Optional[str] = None) -> DynOut:
    """One transition step.  z: (B, O, 6+cl); action: (B,) int64 or None.

    `precision` (`PRECISIONS`; None: `precision_of(cfg)`, as JAX's apply
    reads compute_dtype): "dense_bf16" rounds both operands of every
    product; "bfloat16", the TPU kernels' variant, overrides
    compute_dtype as those kernels ignore it, and keeps the relational
    attention column and the reward heads' geometry rows and last layers
    in float32.  Sums stay in z's dtype."""
    precision = check_precision(precision, cfg)
    kernel_bf16 = precision == "bfloat16"
    bf16 = precision != "float32"
    B, O, _ = z.shape
    inp = z
    if cfg.action_conditioned:
        if action is None:
            action = torch.zeros((B,), dtype=torch.long, device=z.device)
        onehot = F.one_hot(action.long(), cfg.num_actions).to(z.dtype)
        inp = torch.cat([z, onehot[:, None, :].expand(B, O, -1)], -1)

    def dense(layers, x):
        return mlp(layers, x, True) if bf16 else mlp(layers, x)

    e = dense(params["embed"], inp)                           # (B, O, h)
    s = dense(params["self"], e)                              # (B, O, h)

    # W·[e_o; e_j] = W_recv·e_o + W_send·e_j: no (B, O, O, 2h) concat
    w1, rest = params["rel"][0], params["rel"][1:]
    h_e = e.shape[-1]
    recv = matmul(e, w1["w"][:h_e], bf16)                     # (B, O, h)
    send = matmul(e, w1["w"][h_e:], bf16)
    pair_h = torch.relu(recv[:, :, None, :] + send[:, None, :, :]
                        + w1["b"])                            # (B, O, O, h)
    if kernel_bf16:
        # features through rounded operands, the attention column in full
        x = pair_h
        for lyr in rest[:-1]:
            x = torch.relu(matmul(x, lyr["w"], True) + lyr["b"])
        last = rest[-1]
        rel = matmul(x, last["w"][:, :-1], bf16) + last["b"][:-1]
        att = torch.sigmoid(x @ last["w"][:, -1:] + last["b"][-1:])
    else:
        rel_att = dense(rest, pair_h)                         # (B, O, O, h+1)
        rel = rel_att[..., :-1]
        att = torch.sigmoid(rel_att[..., -1:])
    mask = (1.0 - torch.eye(O, dtype=z.dtype, device=z.device)
            )[None, :, :, None]
    r = torch.sum(rel * att * mask, dim=2)                    # (B, O, h)

    sr = torch.cat([s, r], -1)
    out = dense(params["out"], sr)                            # (B, O, d_out)
    cl = cfg.cl
    dv = out[..., 0:2]
    dl = out[..., 2:2 + cl]
    raw_std = out[..., 2 + cl:6 + 2 * cl]

    vel = z[..., VEL] + dv
    pos = z[..., POS] + vel
    lat = (z[..., LAT] + dl) if cfg.latent_residual else dl
    mean = torch.cat([z[..., SIZE], pos, vel, lat], dim=-1)

    std_pvl = gaussians.bounded_std(raw_std, cfg.min_dyn_std,
                                    cfg.max_dyn_std)
    size_std = torch.full_like(z[..., SIZE], cfg.size_std)
    std = torch.cat([size_std, std_pvl], dim=-1)
    if cfg.open_loop_sigma and "open" in params:
        raw_open = dense(params["open"], sr.detach())
        open_pvl = gaussians.bounded_std(raw_open, cfg.min_open_std,
                                         cfg.max_dyn_std)
        std_open = torch.cat([size_std, open_pvl], dim=-1)
    else:
        std_open = std

    if cfg.reward_head and "reward" in params:
        # contact geometry of the predicted next state: per object its
        # signed contact gap and raw min distance to the others, then an
        # attention pool of per-object scores (dynamics.py:171-195)
        ppos = mean[..., POS]
        psize = torch.mean(mean[..., SIZE], dim=-1)           # (B, O)
        pdiff = ppos[:, :, None, :] - ppos[:, None, :, :]
        pdist = torch.sqrt(torch.sum(pdiff ** 2, -1) + 1e-8)  # (B, O, O)
        gap = pdist - (psize[:, :, None] + psize[:, None, :])
        big = 10.0 * torch.eye(O, dtype=z.dtype, device=z.device)[None]
        min_gap = torch.amin(gap + big, dim=-1)
        min_dist = torch.amin(pdist + big, dim=-1)
        geo = torch.stack([min_gap, min_dist], -1)            # (B, O, 2)
        if kernel_bf16:
            h = s.shape[-1]

            def head(layers):
                w0 = layers[0]["w"]
                f = torch.relu(matmul(sr, w0[:2 * h], True) + geo @ w0[2 * h:]
                               + layers[0]["b"])
                for lyr in layers[1:-1]:
                    f = torch.relu(matmul(f, lyr["w"], True) + lyr["b"])
                return (f @ layers[-1]["w"] + layers[-1]["b"])[..., 0]

            score = head(params["reward"])                    # (B, O)
            att_r = torch.softmax(head(params["reward_att"]), -1)
        else:
            feat = torch.cat([s, r, geo], -1)
            score = dense(params["reward"], feat)[..., 0]     # (B, O)
            att_r = torch.softmax(dense(params["reward_att"], feat)[..., 0],
                                  -1)
        reward = torch.sigmoid(torch.sum(att_r * score, dim=-1))
    else:
        reward = torch.zeros((B,), dtype=z.dtype, device=z.device)
    return DynOut(mean, std, reward, std_open)
