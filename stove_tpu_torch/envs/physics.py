"""Billiards, gravity and avoidance physics and rendering (counterpart of
`stove_tpu/envs/physics.py`).

Everything is batched over a leading sequence axis N as plain tensor code:
`EnvState` holds (N, O, 2) positions and velocities and (N, O) radii and
masses.  O equal-radius balls move at constant speed in a square arena
with elastic ball-ball and ball-wall collisions, resolved pair by pair in
the JAX package's sequential order, with collision substepping.  In the
gravity task the balls attract each other (softened N-body forces, a weak
pull to the arena's centre, semi-implicit Euler, no collisions).  In the
avoidance task ball 0's velocity is set each step by one of 9 discrete
actions (no-op and 8 compass directions), and the reward is
`reward_contact` when ball 0 touched another ball during the step,
`reward_free` otherwise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from stove_tpu_torch.config import Config


class EnvState(NamedTuple):
    pos: torch.Tensor      # (N, O, 2) ball centers in [0, arena]^2
    vel: torch.Tensor      # (N, O, 2) per-step velocities
    radii: torch.Tensor    # (N, O)
    masses: torch.Tensor   # (N, O)


# no-op + the 8 compass directions (E, NE, N, NW, W, SW, S, SE), computed
# in float32 as the reference's table is (physics.py:46-50)
_DIRS = torch.stack([torch.zeros(2)] + [
    torch.stack([torch.cos(a), torch.sin(a)])
    for a in (torch.tensor(i * math.pi / 4, dtype=torch.float32)
              for i in range(8))])


def action_directions() -> torch.Tensor:
    """Unit direction per discrete action, (9, 2) float32; action 0 is
    the no-op."""
    return _DIRS


def init_state(cfg: Config, n: int, generator: Optional[torch.Generator],
               device: torch.device = torch.device("cpu")) -> EnvState:
    """n random non-overlapping states (physics.py:62-110; avoidance
    starts as billiards does).

    Uniform positions; 40 sweeps redraw every ball that overlaps another;
    8 projection passes push any remaining overlaps apart.  Billiards and
    avoidance: uniform random headings at speed `init_speed`.  Gravity:
    normal velocities of std 0.3·init_speed + 0.05 with their mean over
    the balls removed (zero net momentum).  Unit masses.  Draws come from
    `generator` on the CPU (the same numbers on every device), then move to
    `device`.
    """
    O = cfg.num_obj
    lo, hi = cfg.ball_radius, cfg.arena_size - cfg.ball_radius
    r = torch.full((n, O), cfg.ball_radius, dtype=torch.float32)
    eye = torch.eye(O, dtype=torch.bool)

    def sample_pos():
        return lo + (hi - lo) * torch.rand((n, O, 2), generator=generator)

    def overlapping(pos):
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        dist = torch.sqrt(torch.sum(diff ** 2, -1) + 1e-12)
        sep = r[:, :, None] + r[:, None, :]
        return torch.any((dist < sep) & ~eye, dim=2)           # (n, O)

    pos = sample_pos()
    for _ in range(40):
        pos = torch.where(overlapping(pos)[..., None], sample_pos(), pos)
    pos = _separate_overlaps(pos, r, iters=8)
    pos = torch.clamp(pos, lo, hi)
    if cfg.task == "gravity":
        vel = torch.randn((n, O, 2), generator=generator) * (
            0.3 * cfg.init_speed + 0.05)
        vel = vel - torch.mean(vel, dim=1, keepdim=True)
    else:
        ang = 2.0 * math.pi * torch.rand((n, O), generator=generator)
        vel = cfg.init_speed * torch.stack([torch.cos(ang), torch.sin(ang)],
                                           -1)
    return EnvState(pos.to(device), vel.to(device), r.to(device),
                    torch.ones((n, O), dtype=torch.float32, device=device))


def _separate_overlaps(pos: torch.Tensor, radii: torch.Tensor,
                       iters: int) -> torch.Tensor:
    """Push overlapping balls apart along their center lines."""
    O = pos.shape[1]
    not_eye = ~torch.eye(O, dtype=torch.bool, device=pos.device)
    for _ in range(iters):
        diff = pos[:, :, None, :] - pos[:, None, :, :]         # (n, O, O, 2)
        dist = torch.sqrt(torch.sum(diff ** 2, -1) + 1e-12)
        sep = radii[:, :, None] + radii[:, None, :]
        pen = torch.clamp(sep - dist, min=0.0) * not_eye
        push = diff / dist[..., None] * (0.5 * pen)[..., None]
        pos = pos + torch.sum(push, dim=2)
    return pos


def _wall_bounce(pos, vel, radii, arena: float):
    """Elastic wall reflection: flip the velocity component, mirror the
    position."""
    lo = radii[..., None]
    hi = arena - radii[..., None]
    below = pos < lo
    above = pos > hi
    vel = torch.where(below | above, -vel, vel)
    pos = torch.where(below, 2 * lo - pos, pos)
    pos = torch.where(above, 2 * hi - pos, pos)
    return pos, vel


def _ball_collisions(pos, vel, radii, masses):
    """Sequential elastic impulse exchange over the pairs (i, j), i < j, in
    row order (physics.py:127-168).  Returns (pos, vel, touched (N, O))."""
    O = pos.shape[1]
    touched = torch.zeros(pos.shape[:2], dtype=torch.bool, device=pos.device)
    pos, vel = pos.clone(), vel.clone()
    for i in range(O):
        for j in range(i + 1, O):
            diff = pos[:, i] - pos[:, j]                         # (N, 2)
            dist = torch.sqrt(torch.sum(diff ** 2, -1) + 1e-12)  # (N,)
            nrm = diff / dist[:, None]
            sep = radii[:, i] + radii[:, j]
            closing = torch.sum((vel[:, i] - vel[:, j]) * nrm, -1)
            contact = dist < sep
            hit = contact & (closing < 0.0)
            mi, mj = masses[:, i], masses[:, j]
            zero = torch.zeros_like(closing)
            imp_i = torch.where(hit, 2.0 * mj / (mi + mj) * closing,
                                zero)[:, None] * nrm
            imp_j = torch.where(hit, 2.0 * mi / (mi + mj) * closing,
                                zero)[:, None] * nrm
            vel[:, i] = vel[:, i] - imp_i
            vel[:, j] = vel[:, j] + imp_j
            pen = torch.where(contact, sep - dist, zero)
            pos[:, i] = pos[:, i] + (0.5 * pen)[:, None] * nrm
            pos[:, j] = pos[:, j] + (-0.5 * pen)[:, None] * nrm
            touched[:, i] |= contact
            touched[:, j] |= contact
    return pos, vel, touched


def billiards_step_full(cfg: Config, state: EnvState
                        ) -> Tuple[EnvState, torch.Tensor]:
    """One frame of elastic billiards with collision substepping.
    Returns (state, touched (N, O))."""
    sub = max(1, cfg.physics_substeps)
    dt = 1.0 / sub
    touched = torch.zeros(state.pos.shape[:2], dtype=torch.bool,
                          device=state.pos.device)
    for _ in range(sub):
        pos = state.pos + state.vel * dt
        pos, vel, t = _ball_collisions(pos, state.vel, state.radii,
                                       state.masses)
        pos, vel = _wall_bounce(pos, vel, state.radii, cfg.arena_size)
        state = EnvState(pos, vel, state.radii, state.masses)
        touched = touched | t
    return state, touched


def billiards_step(cfg: Config, state: EnvState) -> EnvState:
    return billiards_step_full(cfg, state)[0]


def gravity_step(cfg: Config, state: EnvState) -> EnvState:
    """One frame of softened N-body gravity with a weak centering pull
    (physics.py:209-232): a_i = G Σ_j≠i m_j (p_j − p_i) / (|p_j − p_i|² +
    ε)^{3/2} − k (p_i − c), then v ← v + a·dt, p ← p + v·dt, and the
    elastic wall reflection."""
    pos, vel = state.pos, state.vel
    O = pos.shape[1]
    eye = torch.eye(O, dtype=torch.bool, device=pos.device)
    diff = pos[:, None, :, :] - pos[:, :, None, :]             # p_j − p_i
    r2 = torch.sum(diff ** 2, -1) + cfg.gravity_eps
    inv = torch.where(eye, torch.zeros_like(r2), r2 ** (-1.5))
    mj = state.masses[:, None, :]
    acc = cfg.gravity_strength * torch.sum((mj * inv)[..., None] * diff,
                                           dim=2)              # (N, O, 2)
    center = cfg.arena_size / 2.0
    acc = acc - cfg.gravity_center_pull * (pos - center)
    vel = vel + acc * cfg.gravity_dt
    pos = pos + vel * cfg.gravity_dt
    pos, vel = _wall_bounce(pos, vel, state.radii, cfg.arena_size)
    return EnvState(pos, vel, state.radii, state.masses)


def avoidance_step(cfg: Config, state: EnvState, action: torch.Tensor
                   ) -> Tuple[EnvState, torch.Tensor]:
    """Action-conditioned billiards (physics.py:235): ball 0's velocity is
    set by `action` (N,) to its direction at `action_speed`, then one
    billiards frame.  Returns (state, reward (N,) float32): `reward_contact`
    where ball 0 touched another ball, `reward_free` elsewhere."""
    vel = state.vel.clone()
    vel[:, 0] = _DIRS.to(vel.device)[action.long()] * cfg.action_speed
    new, touched = billiards_step_full(
        cfg, EnvState(state.pos, vel, state.radii, state.masses))
    return new, torch.where(touched[:, 0], cfg.reward_contact,
                            cfg.reward_free).to(torch.float32)


def env_step(cfg: Config, state: EnvState,
             action: Optional[torch.Tensor] = None
             ) -> Tuple[EnvState, torch.Tensor]:
    """Dispatch on cfg.task (physics.py:251).  Returns (state, reward (N,)),
    the reward zeros for billiards and gravity."""
    zeros = torch.zeros(state.pos.shape[0], dtype=torch.float32,
                        device=state.pos.device)
    if cfg.task == "gravity":
        return gravity_step(cfg, state), zeros
    if cfg.task == "avoidance":
        if action is None:
            raise ValueError("the avoidance task needs an action")
        return avoidance_step(cfg, state, action)
    return billiards_step(cfg, state), zeros


def render(cfg: Config, pos: torch.Tensor, radii: torch.Tensor
           ) -> torch.Tensor:
    """Anti-aliased white discs on black: pos (..., O, 2), radii (..., O)
    → (..., img, img) float32 in [0, 1]; per pixel
    clip(Σ_o clip((r − d)·scale + 0.5, 0, 1), 0, 1)."""
    n = cfg.img_size
    scale = n / cfg.arena_size
    grid = (torch.arange(n, dtype=torch.float32, device=pos.device)
            + 0.5) / scale
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")         # row=y, col=x
    px = pos[..., 0][..., None, None]                          # (..., O, 1, 1)
    py = pos[..., 1][..., None, None]
    d = torch.sqrt((gx - px) ** 2 + (gy - py) ** 2)            # (..., O, n, n)
    disc = torch.clamp((radii[..., None, None] - d) * scale + 0.5, 0.0, 1.0)
    return torch.clamp(torch.sum(disc, dim=-3), 0.0, 1.0)


def render_sequence(cfg: Config, positions: torch.Tensor,
                    radii: torch.Tensor) -> torch.Tensor:
    """(N, T, O, 2) arena positions, (N, O) radii → (N, T, img, img)."""
    return render(cfg, positions, radii[:, None, :])
