"""Corpora, their files, and window batches (counterpart of
`stove_tpu/envs/data.py`).

`generate` simulates and renders a batch of billiards, gravity or avoidance
sequences on the requested device (avoidance with uniformly random
per-step actions and the environment's rewards) and quantises the frames
to uint8 like the JAX corpora.  `ensure_dataset` reads a split from
`cfg.data_dir` (under the JAX package's file name, `dataset_path`) or,
where no file is there, generates it as `split` does and writes it: the
same `.npz` schema and dtypes as the JAX package's `save`, so a corpus
either package wrote is read by both.  `load` also reads the reference's
pickles (`X`, `y`, `action`, `reward`, `r`).  The two packages draw
different sequences at one seed (torch.Generator against threefry keys).
`sample_windows` draws a training batch of windows on the corpus's device.
Ground-truth `states` per object are (x, y, vx, vy) in arena coordinates,
recorded *before* each step (the reference layout).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
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
             device: torch.device = torch.device("cpu"),
             quantize: bool = True) -> Episode:
    """`num` sequences of cfg.seq_len frames from random initial states,
    frames quantised to uint8 unless `quantize` is false (data.py:45-69).
    Avoidance draws uniform actions from `generator` after the initial
    states; other tasks draw none, so their corpora do not depend on the
    action draw."""
    state = physics.init_state(cfg, num, generator, device)
    T = cfg.seq_len
    if cfg.task == "avoidance":
        actions = torch.randint(0, cfg.num_actions, (num, T),
                                generator=generator).to(device)
    else:
        actions = torch.zeros((num, T), dtype=torch.long, device=device)
    states, rewards = simulate(cfg, state, actions)
    frames = physics.render_sequence(cfg, states[..., :2], state.radii)
    if quantize:
        frames = torch.round(frames * 255.0).to(torch.uint8)
    return Episode(frames, states, actions, rewards, state.radii)


def split(cfg: Config, name: str,
          device: torch.device = torch.device("cpu")) -> Episode:
    """The "train" (cfg.num_train sequences from cfg.seed) or "test"
    (cfg.num_test from cfg.seed + 1) corpus, generated in memory: what
    `ensure_dataset` writes where it finds no file."""
    num, seed = {"train": (cfg.num_train, cfg.seed),
                 "test": (cfg.num_test, cfg.seed + 1)}[name]
    return generate(cfg, num, torch.Generator().manual_seed(seed), device)


# the fields a corpus's content depends on besides task, objects, count and
# length (data.py:100-120): a config that differs from `Config()` in any of
# them names its file with the md5 of those differences
PHYSICS_KEYS = ("arena_size", "ball_radius", "init_speed", "gravity_strength",
                "gravity_eps", "gravity_center_pull", "gravity_dt",
                "physics_substeps", "num_actions", "action_speed",
                "reward_contact", "reward_free", "img_size")


def _physics_tag(cfg: Config) -> str:
    """"" for default physics, else "_p" and 8 hex digits of the md5 of
    the differing fields as "key=value" joined by commas."""
    defaults = Config()
    diffs = [f"{k}={getattr(cfg, k)}" for k in PHYSICS_KEYS
             if getattr(cfg, k) != getattr(defaults, k)]
    if not diffs:
        return ""
    return "_p" + hashlib.md5(",".join(diffs).encode()).hexdigest()[:8]


def dataset_path(cfg: Config, split: str) -> str:
    """`<data_dir>/<task>_o<O>_n<N>_t<T><physics tag>_<split>.npz`, the
    JAX package's name for the split."""
    num = cfg.num_train if split == "train" else cfg.num_test
    name = (f"{cfg.task}_o{cfg.num_obj}_n{num}_t{cfg.seq_len}"
            f"{_physics_tag(cfg)}_{split}.npz")
    return os.path.join(cfg.data_dir, name)


def save(ep: Episode, path: str) -> None:
    """Write `ep` as the JAX package's compressed npz (frames, states,
    actions as int32, rewards, radii), atomically: a temporary file in the
    same directory, then a rename, so a reader never sees half a file."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    arrays = dict(frames=ep.frames.cpu().numpy(),
                  states=ep.states.cpu().numpy().astype(np.float32),
                  actions=ep.actions.cpu().numpy().astype(np.int32),
                  rewards=ep.rewards.cpu().numpy().astype(np.float32),
                  radii=ep.radii.cpu().numpy().astype(np.float32))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_", suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load(path: str, device: torch.device = torch.device("cpu")) -> Episode:
    """An `.npz` corpus (either package's) or a reference-style pickle
    (data.py:142): `X` (N, T, H, W[, 1]), float frames quantised to uint8
    as round(clip(X, 0, 1)·255); `y` (N, T, O, ≥4), its first four
    columns; `action` one-hot (N, T, A) or indices, zeros if absent;
    `reward`, zeros if absent; `r` radii, 1.2 if absent.  Actions come
    back as int64, the port's `Episode` dtype."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            arrays = [z[k] for k in ("frames", "states", "actions",
                                     "rewards", "radii")]
    else:
        with open(path, "rb") as f:
            raw = pickle.load(f)
        X = np.asarray(raw["X"])
        if X.ndim == 5:
            X = X[..., 0]
        y = np.asarray(raw["y"])
        N, T = X.shape[:2]
        O = y.shape[2]
        actions = np.asarray(raw.get("action", np.zeros((N, T), np.int32)))
        if actions.ndim == 3:
            actions = actions.argmax(-1)
        rewards = np.asarray(raw.get("reward", np.zeros((N, T), np.float32)))
        rewards = rewards.reshape(N, -1)[:, :T]
        radii = np.asarray(raw.get("r", np.full((N, O), 1.2, np.float32)))
        radii = radii.reshape(N, -1)[:, :O]
        if X.dtype != np.uint8:
            X = np.round(np.clip(X, 0, 1) * 255).astype(np.uint8)
        arrays = [X, y[..., :4], actions, rewards.astype(np.float32),
                  radii.astype(np.float32)]
    frames, states, actions, rewards, radii = (torch.from_numpy(
        np.ascontiguousarray(a)).to(device) for a in arrays)
    return Episode(frames, states.to(torch.float32), actions.to(torch.int64),
                   rewards, radii)


def ensure_dataset(cfg: Config, name: str,
                   device: torch.device = torch.device("cpu")) -> Episode:
    """The split `name` from `dataset_path`, its reference spelling
    "billards", or either as a `.pkl` (data.py:181); where none exists,
    `split(cfg, name, device)` generated and saved there."""
    path = dataset_path(cfg, name)
    alt = path.replace("billiards", "billards")
    for p in (path, alt, path.replace(".npz", ".pkl"),
              alt.replace(".npz", ".pkl")):
        if os.path.exists(p):
            return load(p, device)
    ep = split(cfg, name, device)
    save(ep, path)
    return ep


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
