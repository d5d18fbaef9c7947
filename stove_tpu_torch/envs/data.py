"""In-memory corpora and window batches (counterpart of
`stove_tpu/envs/data.py`, without storage).

`generate` simulates and renders a batch of billiards, gravity or avoidance
sequences on the requested device (avoidance with uniformly random
per-step actions and the environment's rewards) and quantises the frames
to uint8 like the JAX corpora.
Nothing is written to disk: the training and test corpora are made anew
from a seed.  `sample_windows` draws a training batch of windows on the
corpus's device.
Ground-truth `states` per object are (x, y, vx, vy) in arena coordinates,
recorded *before* each step (the reference layout).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from stove_tpu_torch.config import Config
from stove_tpu_torch.envs import physics


class Episode(NamedTuple):
    """One batch of trajectories (leading dims N, T)."""
    frames: torch.Tensor    # (N, T, img, img) uint8 or float32
    states: torch.Tensor    # (N, T, O, 4) x, y, vx, vy (arena coords)
    actions: torch.Tensor   # (N, T) int64 (zeros without actions)
    rewards: torch.Tensor   # (N, T) float32
    radii: torch.Tensor     # (N, O) float32


def simulate(cfg: Config, state: physics.EnvState, actions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step `state` with actions (N, T): the (N, T, O, 4) recorded states
    (frame t holds the state before step t) and the (N, T) rewards of the
    steps (`physics.env_step`)."""
    states, rewards = [], []
    for t in range(actions.shape[1]):
        states.append(torch.cat([state.pos, state.vel], -1))
        state, r = physics.env_step(cfg, state, actions[:, t])
        rewards.append(r)
    return torch.stack(states, 1), torch.stack(rewards, 1)


def generate(cfg: Config, num: int, generator: Optional[torch.Generator],
             device: torch.device = torch.device("cpu")) -> Episode:
    """`num` sequences of cfg.seq_len frames from random initial states,
    frames quantised to uint8 (data.py:45-69).  Avoidance draws uniform
    actions from `generator` after the initial states; other tasks draw
    none, so their corpora do not depend on the action draw."""
    state = physics.init_state(cfg, num, generator, device)
    T = cfg.seq_len
    if cfg.task == "avoidance":
        actions = torch.randint(0, cfg.num_actions, (num, T),
                                generator=generator).to(device)
    else:
        actions = torch.zeros((num, T), dtype=torch.long, device=device)
    states, rewards = simulate(cfg, state, actions)
    frames = physics.render_sequence(cfg, states[..., :2], state.radii)
    frames = torch.round(frames * 255.0).to(torch.uint8)
    return Episode(frames, states, actions, rewards, state.radii)


def split(cfg: Config, name: str,
          device: torch.device = torch.device("cpu")) -> Episode:
    """The "train" (cfg.num_train sequences from cfg.seed) or "test"
    (cfg.num_test from cfg.seed + 1) corpus: the Trainer and mode=eval
    read the same test split, as the reference's `ensure_dataset` serves
    both."""
    num, seed = {"train": (cfg.num_train, cfg.seed),
                 "test": (cfg.num_test, cfg.seed + 1)}[name]
    return generate(cfg, num, torch.Generator().manual_seed(seed), device)


def normalize_frames(frames: torch.Tensor) -> torch.Tensor:
    """uint8 → float32 in [0, 1] (a cast only when already float)."""
    if frames.dtype == torch.uint8:
        return frames.to(torch.float32) / 255.0
    return frames.to(torch.float32)


def arena_to_model(cfg: Config, pos: torch.Tensor) -> torch.Tensor:
    """Arena [0, A] coords → model/ST [−1, 1] coords."""
    return pos / (cfg.arena_size / 2.0) - 1.0


def model_to_arena(cfg: Config, pos: torch.Tensor) -> torch.Tensor:
    return (pos + 1.0) * (cfg.arena_size / 2.0)


def sample_windows(ep: Episode, cfg: Config, generator: torch.Generator,
                   batch: int) -> Dict[str, torch.Tensor]:
    """`batch` random cfg.window-frame windows (data.py:219): a sequence
    and a start offset per window, drawn from `generator`, which lives on
    the corpus's device; frames normalised to float32 in [0, 1]."""
    N, T = ep.frames.shape[:2]
    W = cfg.window
    dev = ep.frames.device
    seq = torch.randint(0, N, (batch,), generator=generator, device=dev)
    off = torch.randint(0, T - W + 1, (batch,), generator=generator,
                        device=dev)
    t_idx = off[:, None] + torch.arange(W, device=dev)[None, :]
    s_idx = seq[:, None]
    return dict(frames=normalize_frames(ep.frames[s_idx, t_idx]),
                states=ep.states[s_idx, t_idx],
                actions=ep.actions[s_idx, t_idx],
                rewards=ep.rewards[s_idx, t_idx])
