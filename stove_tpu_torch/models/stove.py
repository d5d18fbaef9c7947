"""STOVE: inference, the training ELBO and rollout (counterpart of
`stove_tpu/models/stove.py`).

Encode every frame at once, the SuPAIR-only init at t = 0, 1, the
posterior recursion (dynamics step, slot alignment, products of
Gaussians, reparameterized sample, KL increment) for t ≥ 2, the SuPAIR
likelihood of every frame at its sampled boxes, latent overshooting, and
the open-loop rollout.

Noise is explicit.  `infer` takes an `InferNoise` (the t=0/1 box draws,
the initial latents and the per-step ε of stove.py:155-191) and `elbo` an
`ElboNoise` (that plus the overshoot draws), or draws them from a
`torch.Generator`; the parity tests hand in JAX's own draws.  The
recursion dispatches on `scan_impl` (`scan_posterior`): the fused scan
kernel for "pallas" on the card, the plain loop otherwise.  `rollout`
sends CUDA tensors to the fused rollout kernel and CPU tensors to the
plain loop.
"""

from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from stove_tpu_torch.config import Config
from stove_tpu_torch.models import dynamics as dyn_lib
from stove_tpu_torch.models import supair as supair_lib
from stove_tpu_torch.models.dynamics import POS, SIZE
from stove_tpu_torch.ops import fused_rollout, fused_scan, gaussians


class StoveSpecs(NamedTuple):
    supair: supair_lib.SupairSpecs


def make_specs(cfg: Config, seeds: supair_lib.SpecSeeds) -> StoveSpecs:
    return StoveSpecs(supair_lib.make_specs(cfg, seeds))


def init_params(cfg: Config, specs: StoveSpecs,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    return {
        "supair": supair_lib.init_params(cfg, specs.supair, generator, device),
        "dynamics": dyn_lib.init_params(cfg, generator, device),
    }


# --------------------------------------------------------------------------
# slot alignment
# --------------------------------------------------------------------------

# constants of the step's path, each built once on its device, so that a
# step copies nothing from the host (and a CUDA graph can capture it)
_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def _permutations(O: int, device: torch.device) -> torch.Tensor:
    """The O! permutations of range(O) in itertools order, (P, O) long on
    `device`, built once a (O, device)."""
    key = ("perms", O, str(device))
    got = _CONSTANTS.get(key)
    if got is None:
        got = _CONSTANTS[key] = torch.tensor(
            list(itertools.permutations(range(O))), dtype=torch.long,
            device=device)
    return got


def _constant(value: float, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """`value` as a 0-d `dtype` tensor on `device`, built once."""
    key = ("scalar", value, dtype, str(device))
    got = _CONSTANTS.get(key)
    if got is None:
        got = _CONSTANTS[key] = torch.tensor(value, dtype=dtype,
                                             device=device)
    return got


def _exact_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Min-cost assignment by enumerating all O! permutations.

    cost (B, O, O): cost[b, i, j] of matching ref slot i to new slot j.
    Returns sel (B, O) with sel[b, i] = chosen j; ties go to the first
    minimal permutation in itertools order (argmin's first occurrence).
    """
    B, O, _ = cost.shape
    perms = _permutations(O, cost.device)                           # (P, O)
    onehot = F.one_hot(perms, O).to(cost.dtype)                     # (P, O, O)
    percost = torch.einsum("bij,pij->bp", cost, onehot)
    return perms[torch.argmin(percost, dim=-1)]


def _greedy_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Repeatedly take the globally cheapest unmatched (ref, new) pair; used
    above O = 4 where O! enumeration explodes."""
    B, O, _ = cost.shape
    big = _constant(1e9, cost.dtype, cost.device)
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


def draw_normals(shape: Tuple[int, ...],
                 generator: Optional[torch.Generator],
                 device: torch.device) -> torch.Tensor:
    """Standard normals drawn from `generator` on its own device (the
    CPU's default generator without one) and moved to `device` where that
    differs: a CPU generator serves every device, and a CUDA one draws
    on the card with no copy."""
    where = generator.device if generator is not None else None
    return torch.randn(shape, generator=generator, device=where).to(device)


def draw_infer_noise(cfg: Config, B: int, T: int,
                     generator: Optional[torch.Generator],
                     device: torch.device) -> InferNoise:
    """Standard normals for `infer`, drawn from `generator` on its device
    (`draw_normals`) and moved to `device`."""
    O, D = cfg.num_obj, cfg.full_state_dim

    def n(*shape):
        return draw_normals(shape, generator, device)

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


def scan_posterior(dyn_params: Dict, cfg: Config, z1, carry_m, carry_s,
                   sup_mean, sup_std, actions, eps):
    """The phase-2 recursion, dispatched as stove.py:338-347 does:
    `scan_impl="pallas"` with T−2 > 0 goes through `fused_scan.scan_fused`
    (the CUDA kernel on the card, the plain loop on the CPU, the plain
    loop's gradient on both); otherwise the plain loop
    `fused_scan.scan_reference`."""
    if cfg.scan_impl == "pallas" and sup_mean.shape[1] > 0:
        return fused_scan.scan_fused(dyn_params, cfg, z1, carry_m, carry_s,
                                     sup_mean, sup_std, actions, eps)
    return fused_scan.scan_reference(dyn_params, cfg, z1, carry_m, carry_s,
                                     sup_mean, sup_std, actions, eps)


class ElboNoise(NamedTuple):
    """Every standard normal `elbo` consumes: `infer`'s, and the
    overshoot's open-loop draws (K, B·(T−K), O, D) when
    cfg.overshoot_sample is on (else None)."""
    infer: InferNoise
    overshoot: Optional[torch.Tensor]


def draw_elbo_noise(cfg: Config, B: int, T: int,
                    generator: Optional[torch.Generator],
                    device: torch.device) -> ElboNoise:
    """Standard normals for `elbo`, drawn from `generator` on its device
    (`draw_normals`) and moved to `device`."""
    inf = draw_infer_noise(cfg, B, T, generator, device)
    over = None
    K = cfg.overshoot_k
    if cfg.overshoot_sample and K > 0 and T > K:
        over = draw_normals((K, B * (T - K), cfg.num_obj,
                             cfg.full_state_dim), generator, device)
    return ElboNoise(inf, over)


def noise_rows(noise: ElboNoise, rows: slice, B: int) -> ElboNoise:
    """The draws of rows `rows` of a batch of B windows: each InferNoise
    field's rows, and the overshoot draws of those windows' start steps
    (their (K, B·S, O, D) rows are window-major)."""
    inf = InferNoise(*(x[rows] for x in noise.infer))
    over = noise.overshoot
    if over is not None:
        K, BS = over.shape[:2]
        over = over.reshape(K, B, BS // B, *over.shape[2:])[:, rows]
        over = over.reshape(K, -1, *over.shape[3:])
    return ElboNoise(inf, over)


class ElboOut(NamedTuple):
    loss: torch.Tensor
    elbo: torch.Tensor
    log_lik: torch.Tensor
    kl: torch.Tensor
    reward_loss: torch.Tensor
    overshoot_loss: torch.Tensor
    overshoot_reward_loss: torch.Tensor
    open_sigma_nll: torch.Tensor
    inferred: InferOut


def _balanced_bce(pred: torch.Tensor, target: torch.Tensor, balanced: bool,
                  label_smooth: float = 0.0, pos_rate: float = 0.0,
                  batch_target: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Binary cross-entropy, optionally inverse-frequency class-weighted
    (by `pos_rate` when > 0, else the batch mean, clipped to [0.05, 0.95])
    and label-smoothed; the class weights use the hard labels.  The batch
    mean is over `batch_target` when given: the whole batch's targets when
    `target` is one shard of it, as XLA takes jnp.mean over a sharded
    batch."""
    eps = 1e-6
    soft = target * (1.0 - label_smooth) + 0.5 * label_smooth
    bce = -(soft * torch.log(pred + eps)
            + (1 - soft) * torch.log(1 - pred + eps))
    if balanced:
        pr = (torch.clamp(_constant(pos_rate, pred.dtype, pred.device),
                          0.05, 0.95)
              if pos_rate > 0 else torch.clamp(torch.mean(
                  target if batch_target is None else batch_target),
                  0.05, 0.95))
        w = torch.where(target > 0.5, 0.5 / pr, 0.5 / (1.0 - pr))
        bce = bce * w
    return torch.mean(bce)


def overshoot_losses(params: Dict, cfg: Config, inf: InferOut,
                     actions: Optional[torch.Tensor],
                     rewards: Optional[torch.Tensor],
                     noise: Optional[torch.Tensor] = None,
                     batch_rewards: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Latent overshooting (stove.py:386-520): from every posterior sample
    z_t (t ≤ T−K) the dynamics rolls K steps open loop; predicted positions
    are held to the detached posterior position means at t+k.  Also the
    open-loop reward loss (reward head with actions) and the open-loop std
    NLL (open_loop_sigma).  `noise` (K, B·S, O, D): the open-loop draws
    when cfg.overshoot_sample is on; `batch_rewards` as `elbo`'s.  Returns
    (position, reward, sigma NLL) losses."""
    K = cfg.overshoot_k
    B, T = inf.z.shape[:2]
    S = T - K
    zero = inf.z.new_zeros(())
    if K <= 0:
        if cfg.open_loop_sigma:
            raise ValueError(
                "open_loop_sigma=True requires overshoot_k >= 1: the "
                "sigma-open NLL is computed inside the overshoot loss, so "
                "with overshoot_k=0 the open-loop std head never trains.")
        return zero, zero, zero
    if S <= 0:
        raise ValueError(
            f"overshoot_k={K} requires window > K (window={T}): no valid "
            "open-loop start indices — the overshoot losses would silently "
            "vanish. Lower overshoot_k or raise window.")
    if actions is None:
        actions = torch.zeros((B, T), dtype=torch.long, device=inf.z.device)

    z = inf.z[:, :S].reshape(B * S, *inf.z.shape[2:])
    targets = inf.pos_mean.detach()                            # (B, T, O, 2)
    mean_targets = inf.z_mean.detach()                         # (B, T, O, D)
    supervise_reward = (cfg.action_conditioned and cfg.reward_head
                        and rewards is not None
                        and cfg.reward_overshoot_weight > 0)
    total_pos, total_rew, sigma_nll = zero, zero, zero

    if cfg.open_loop_sigma and T >= 3:
        horizons = tuple(k for k in sorted(set(cfg.open_loop_sigma_horizons))
                         if 1 <= k <= T - 2) or (1,)
        kmax = horizons[-1]
        Sm = T - 1 - kmax
        zm = mean_targets[:, 1:1 + Sm].reshape(B * Sm, *mean_targets.shape[2:])
        z_roll = zm
        var_acc = torch.zeros_like(zm[..., 2:])
        terms = []
        for k in range(1, kmax + 1):
            act_m = actions[:, k:k + Sm].reshape(B * Sm)
            dyn_m = dyn_lib.apply(params["dynamics"], cfg, z_roll, act_m)
            var_acc = var_acc + dyn_m.std_open[..., 2:] ** 2
            if k in horizons:
                tgt = mean_targets[:, 1 + k:1 + k + Sm].reshape(
                    B * Sm, *mean_targets.shape[2:])
                nll = -gaussians.log_prob(tgt[..., 2:],
                                          dyn_m.mean[..., 2:].detach(),
                                          torch.sqrt(var_acc))
                terms.append(torch.mean(torch.sum(nll, dim=(-2, -1))))
            z_roll = dyn_m.mean.detach()
        sigma_nll = sum(terms) / len(terms)

    for k in range(1, K + 1):
        act_k = actions[:, k - 1:k - 1 + S]
        dyn = dyn_lib.apply(params["dynamics"], cfg, z, act_k.reshape(B * S))
        if cfg.overshoot_sample and noise is not None:
            z = gaussians.sample(dyn.mean, dyn.std.detach(), noise[k - 1])
        else:
            z = dyn.mean
        pred_pos = z[..., POS].reshape(B, S, cfg.num_obj, 2)
        tgt = targets[:, k:k + S]
        total_pos = total_pos + torch.mean(
            torch.sum((pred_pos - tgt) ** 2, -1))
        if supervise_reward:
            r_tgt = rewards[:, k - 1:k - 1 + S]
            total_rew = total_rew + _balanced_bce(
                dyn.reward.reshape(B, S), r_tgt, cfg.reward_balanced_loss,
                cfg.reward_label_smooth, cfg.reward_pos_rate,
                None if batch_rewards is None
                else batch_rewards[:, k - 1:k - 1 + S])
    return total_pos / K, total_rew / K, sigma_nll


def elbo(params: Dict, cfg: Config, specs: StoveSpecs, frames: torch.Tensor,
         actions: Optional[torch.Tensor], rewards: Optional[torch.Tensor],
         noise: Optional[ElboNoise] = None,
         generator: Optional[torch.Generator] = None,
         batch_rewards: Optional[torch.Tensor] = None) -> ElboOut:
    """Negative training loss for a window (stove.py:523-566): −ELBO/T plus
    the reward and overshoot terms.  frames (B, T, H, W).

    Every term is a mean over the windows, so the loss of a batch is the
    mean of its shards' losses, but for the balanced reward BCE's batch
    rate (reward_pos_rate <= 0): when `frames` is one shard of a batch,
    `batch_rewards` (the whole batch's rewards) gives it."""
    B, T = frames.shape[:2]
    if noise is None:
        noise = draw_elbo_noise(cfg, B, T, generator, frames.device)
    inf = infer(params, cfg, frames, actions, noise.infer)

    boxes = torch.cat([inf.z[..., SIZE], inf.z[..., POS]], -1)  # (B,T,O,4)
    ll = supair_lib.likelihood(
        params["supair"], cfg, specs.supair,
        frames.reshape(B * T, *frames.shape[2:]),
        boxes.reshape(B * T, cfg.num_obj, 4))
    log_lik = torch.sum(ll.reshape(B, T), dim=1)               # (B,)

    elbo_b = log_lik + inf.kl + inf.init_logp - inf.init_logq
    elbo_mean = torch.mean(elbo_b) / T

    zero = frames.new_zeros(())
    if cfg.action_conditioned and rewards is not None:
        reward_loss = _balanced_bce(inf.rewards[:, 2:], rewards[:, 1:T - 1],
                                    cfg.reward_balanced_loss,
                                    cfg.reward_label_smooth,
                                    cfg.reward_pos_rate,
                                    None if batch_rewards is None
                                    else batch_rewards[:, 1:T - 1])
    else:
        reward_loss = zero
    if cfg.overshoot_k > 0:
        ov, ov_rew, ov_nll = overshoot_losses(params, cfg, inf, actions,
                                              rewards, noise.overshoot,
                                              batch_rewards)
    else:
        ov = ov_rew = ov_nll = zero

    loss = (-elbo_mean + reward_loss + cfg.overshoot_weight * ov
            + cfg.reward_overshoot_weight * ov_rew
            + cfg.open_loop_sigma_weight * ov_nll)
    return ElboOut(loss, elbo_mean, torch.mean(log_lik) / T,
                   torch.mean(inf.kl) / T, reward_loss, ov, ov_rew, ov_nll,
                   inf)


# --------------------------------------------------------------------------
# rollout
# --------------------------------------------------------------------------

def rollout(params: Dict, cfg: Config, z0: torch.Tensor,
            actions: Optional[torch.Tensor], horizon: int,
            generator: Optional[torch.Generator] = None,
            sample: bool = False,
            prepared: Optional[torch.Tensor] = None,
            dtype: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterate the transition prior from z0 for `horizon` steps.

    z0: (B, O, 6+cl); actions: (B, horizon) or None (ignored unless the
    config is action-conditioned).  Returns (states (B, H, O, 6+cl),
    rewards (B, H)), from `fused_rollout.rollout` at `dtype`
    (`dynamics.PRECISIONS`; None: cfg.compute_dtype's, as stove.py:592
    reads it): the kernel for CUDA tensors (`prepared` = its packed
    weights for that dtype, cached by the caller), the plain loop for CPU
    tensors, with noise drawn from `generator`.
    """
    acts = actions if cfg.action_conditioned else None
    return fused_rollout.rollout(params["dynamics"], cfg, z0.contiguous(),
                                 horizon, sample, generator, prepared, acts,
                                 dtype)
