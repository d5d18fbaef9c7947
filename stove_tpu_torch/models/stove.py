"""STOVE inference and rollout (counterpart of `stove_tpu/models/stove.py`).

The eval path of the state-space model: encode every frame at once, the
SuPAIR-only init at t = 0, 1, the posterior recursion (dynamics step,
slot alignment, products of Gaussians, reparameterized sample, KL
increment) for t ≥ 2, and the open-loop rollout.

Noise is explicit.  `infer` takes an `InferNoise` (the t=0/1 box draws,
the initial latents and the per-step ε of stove.py:155-191) or draws one
from a `torch.Generator`; the parity tests hand in JAX's own draws.  The
posterior recursion is the plain loop `_scan_plain`, the reference
semantics of `_scan_xla`; its fused kernel is the next slice of the port.
`rollout` sends CUDA tensors to the fused rollout kernel and CPU tensors
to the plain loop.
"""

from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from stove_tpu_torch.config import Config
from stove_tpu_torch.models import dynamics as dyn_lib
from stove_tpu_torch.models import supair as supair_lib
from stove_tpu_torch.models.dynamics import LAT, POS, SIZE, VEL
from stove_tpu_torch.ops import fused_rollout, gaussians


# --------------------------------------------------------------------------
# slot alignment
# --------------------------------------------------------------------------

def _exact_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Min-cost assignment by enumerating all O! permutations.

    cost (B, O, O): cost[b, i, j] of matching ref slot i to new slot j.
    Returns sel (B, O) with sel[b, i] = chosen j; ties go to the first
    minimal permutation in itertools order (argmin's first occurrence).
    """
    B, O, _ = cost.shape
    perms = torch.tensor(list(itertools.permutations(range(O))),
                         dtype=torch.long, device=cost.device)      # (P, O)
    onehot = F.one_hot(perms, O).to(cost.dtype)                     # (P, O, O)
    percost = torch.einsum("bij,pij->bp", cost, onehot)
    return perms[torch.argmin(percost, dim=-1)]


def _greedy_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Repeatedly take the globally cheapest unmatched (ref, new) pair; used
    above O = 4 where O! enumeration explodes."""
    B, O, _ = cost.shape
    big = torch.tensor(1e9, dtype=cost.dtype, device=cost.device)
    sel = torch.zeros((B, O), dtype=torch.long, device=cost.device)
    c = cost
    for _ in range(O):
        idx = torch.argmin(c.reshape(B, O * O), dim=-1)
        i, j = idx // O, idx % O
        hit_i = F.one_hot(i, O).bool()
        hit_j = F.one_hot(j, O).bool()
        sel = torch.where(hit_i, j[:, None], sel)
        c = torch.where(hit_i[:, :, None] | hit_j[:, None, :], big, c)
    return sel


def align_slots(ref_pos: torch.Tensor, new_pos: torch.Tensor,
                *arrays: torch.Tensor):
    """Permute the O slots of `arrays` so new_pos best matches ref_pos
    (exact assignment for O ≤ 4, greedy above)."""
    B, O, _ = ref_pos.shape
    cost = torch.sum(
        (ref_pos[:, :, None, :] - new_pos[:, None, :, :]) ** 2, -1)
    sel = _exact_assignment(cost) if O <= 4 else _greedy_assignment(cost)
    out = tuple(
        torch.gather(a, 1, sel.reshape(B, O, *([1] * (a.ndim - 2))).expand(
            B, O, *a.shape[2:]))
        for a in arrays)
    return out if len(out) > 1 else out[0]


# --------------------------------------------------------------------------
# inference
# --------------------------------------------------------------------------

class InferNoise(NamedTuple):
    """Every standard normal `infer` consumes (stove.py:155-191)."""
    z0_where: torch.Tensor    # (B, O, 4) t = 0 box sample
    z1_where: torch.Tensor    # (B, O, 4) t = 1 box sample
    lat1: torch.Tensor        # (B, O, cl) initial latents
    eps: torch.Tensor         # (B, T−2, O, 6+cl) per-step posterior ε


def draw_infer_noise(cfg: Config, B: int, T: int,
                     generator: Optional[torch.Generator],
                     device: torch.device) -> InferNoise:
    """Standard normals for `infer`, drawn on the CPU from `generator` (so
    a CPU generator serves every device) and moved to `device`."""
    O, D = cfg.num_obj, cfg.full_state_dim

    def n(*shape):
        return torch.randn(shape, generator=generator).to(device)

    return InferNoise(n(B, O, 4), n(B, O, 4), n(B, O, cfg.cl),
                      n(B, max(T - 2, 0), O, D))


class InferOut(NamedTuple):
    z: torch.Tensor           # (B, T, O, 6+cl) posterior samples
    z_mean: torch.Tensor      # (B, T, O, 6+cl) posterior means
    pos_mean: torch.Tensor    # (B, T, O, 2) posterior position means
    kl: torch.Tensor          # (B,) Σ_{t≥2} [log p(z_t|z_{t−1}) − log q]
    init_logq: torch.Tensor   # (B,)
    init_logp: torch.Tensor   # (B,)
    rewards: torch.Tensor     # (B, T) r̂ (zeros for t < 2)


def infer(params: Dict, cfg: Config, frames: torch.Tensor,
          actions: Optional[torch.Tensor] = None,
          noise: Optional[InferNoise] = None,
          generator: Optional[torch.Generator] = None) -> InferOut:
    """Posterior over a (B, T, H, W) window; noise given or drawn."""
    B, T = frames.shape[:2]
    O, cl = cfg.num_obj, cfg.cl
    if noise is None:
        noise = draw_infer_noise(cfg, B, T, generator, frames.device)

    mean_flat, std_flat = supair_lib.encode(
        params["supair"], cfg, frames.reshape(B * T, *frames.shape[2:]))
    sup_mean = mean_flat.reshape(B, T, O, 4)
    sup_std = std_flat.reshape(B, T, O, 4)

    # ---- t = 0, 1: SuPAIR-only init
    z0_where = gaussians.sample(sup_mean[:, 0], sup_std[:, 0],
                                noise.z0_where)
    m1, s1 = align_slots(sup_mean[:, 0, :, 2:4], sup_mean[:, 1, :, 2:4],
                         sup_mean[:, 1], sup_std[:, 1])
    z1_where = gaussians.sample(m1, s1, noise.z1_where)
    v1 = z1_where[..., 2:4] - z0_where[..., 2:4]
    lat1 = noise.lat1
    z1 = torch.cat([z1_where[..., 0:2], z1_where[..., 2:4], v1, lat1], -1)
    z0 = torch.cat([z0_where[..., 0:2], z0_where[..., 2:4], v1, lat1], -1)

    init_logq = (
        torch.sum(gaussians.log_prob(z0_where, sup_mean[:, 0],
                                     sup_std[:, 0]), (-2, -1))
        + torch.sum(gaussians.log_prob(z1_where, m1, s1), (-2, -1)))
    init_logp = (supair_lib.where_prior_logp(cfg, z0_where)
                 + supair_lib.where_prior_logp(cfg, z1_where))

    # ---- t ≥ 2: the posterior recursion
    if actions is None:
        actions = torch.zeros((B, T), dtype=torch.long, device=frames.device)
    zs_r, zm_r, kl, rew_r = scan_posterior(
        params["dynamics"], cfg, z1, m1[..., 2:4], s1[..., 2:4],
        sup_mean[:, 2:], sup_std[:, 2:], actions[:, 1:T - 1], noise.eps)

    z_all = torch.cat([z0[:, None], z1[:, None], zs_r], dim=1)
    v1_mean = m1[..., 2:4] - sup_mean[:, 0, :, 2:4]
    zeros_lat = torch.zeros_like(lat1)
    z1_mean = torch.cat([m1[..., 0:2], m1[..., 2:4], v1_mean, zeros_lat], -1)
    z0_mean = torch.cat([sup_mean[:, 0, :, 0:2], sup_mean[:, 0, :, 2:4],
                         v1_mean, zeros_lat], -1)
    z_mean_all = torch.cat([z0_mean[:, None], z1_mean[:, None], zm_r], 1)
    pos_mean = torch.cat([sup_mean[:, 0:1, :, 2:4], m1[:, None, :, 2:4],
                          zm_r[..., POS]], dim=1)
    rewards = torch.cat([frames.new_zeros((B, 2)), rew_r], dim=1)
    return InferOut(z_all, z_mean_all, pos_mean, kl, init_logq, init_logp,
                    rewards)


def _scan_plain(dyn_params: Dict, cfg: Config, z1, carry_m, carry_s,
                sup_mean, sup_std, actions, eps):
    """The posterior recursion as a plain loop over t (reference semantics
    of `_scan_xla`, stove.py:217-302).  sup_mean/sup_std (B, T2, O, 4) for
    t = 2..T−1; actions (B, T2) = a_{t−1}; eps (B, T2, O, D).
    Returns (z (B,T2,O,D), z_mean (B,T2,O,D), kl (B,), rewards (B,T2)).
    """
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
        D = z1.shape[-1]
        empty = z1.new_zeros((B, 0, cfg.num_obj, D))
        return empty, empty, kl, z1.new_zeros((B, 0))
    return (torch.stack(zs, 1), torch.stack(zms, 1), kl,
            torch.stack(rews, 1))


def scan_posterior(dyn_params: Dict, cfg: Config, z1, carry_m, carry_s,
                   sup_mean, sup_std, actions, eps):
    """The phase-2 recursion.  Every `scan_impl` runs the plain loop in this
    slice of the port: the fused scan kernel (pallas_scan.scan_fused)
    is the next slice."""
    return _scan_plain(dyn_params, cfg, z1, carry_m, carry_s, sup_mean,
                       sup_std, actions, eps)


# --------------------------------------------------------------------------
# rollout
# --------------------------------------------------------------------------

def rollout(params: Dict, cfg: Config, z0: torch.Tensor,
            actions: Optional[torch.Tensor], horizon: int,
            generator: Optional[torch.Generator] = None,
            sample: bool = False,
            prepared: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterate the transition prior from z0 for `horizon` steps.

    z0: (B, O, 6+cl); actions: (B, horizon) or None (ignored unless the
    config is action-conditioned).  Returns (states (B, H, O, 6+cl),
    rewards (B, H)), from `fused_rollout.rollout`: the kernel for CUDA
    tensors (`prepared` = its packed weights, cached by the caller), the
    plain loop for CPU tensors, with noise drawn from `generator`.
    """
    acts = actions if cfg.action_conditioned else None
    return fused_rollout.rollout(params["dynamics"], cfg, z0.contiguous(),
                                 horizon, sample, generator, prepared, acts)
