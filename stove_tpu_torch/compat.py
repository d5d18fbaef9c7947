"""Reference-style compatibility shims (counterpart of `stove_tpu/compat.py`).

Small stateful environments with the reference's `reset()` / `step()`
surface -- `BilliardsEnv` (also under the reference's spelling
`BillardsEnv`), `GravityEnv`, `AvoidanceTask` -- over the port's batched
physics (`envs/physics.py`, one sequence), and `generate_data`, which
writes train and test corpora as the reference's pickles or as the npz
files `envs/data.py` reads.  Randomness comes from a `torch.Generator`
seeded with `seed`, where the JAX package splits a PRNG key.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from stove_tpu_torch.config import Config
from stove_tpu_torch.envs import physics


class PhysicsEnv:
    """Stateful wrapper over the functional simulators (reference API)."""

    task = "billiards"

    def __init__(self, num_obj: int = 3, seed: int = 0, **overrides):
        self.cfg = Config().with_overrides(task=self.task,
                                           num_obj=num_obj, **overrides)
        self.generator = torch.Generator().manual_seed(seed)
        self.state: Optional[physics.EnvState] = None
        self.reset()

    def reset(self) -> np.ndarray:
        """A new random initial state; returns its frame."""
        self.state = physics.init_state(self.cfg, 1, self.generator)
        return self.render()

    def step(self, action: int = 0) -> Tuple[np.ndarray, np.ndarray, float]:
        """Returns (frame, state_vector (O, 4), reward) -- reference layout:
        the frame and the state vector describe the same post-step
        instant."""
        self.state, reward = physics.env_step(
            self.cfg, self.state, torch.tensor([int(action)]))
        sv = torch.cat([self.state.pos, self.state.vel], -1)[0].numpy()
        return self.render(), sv, float(reward[0])

    def render(self) -> np.ndarray:
        """(img, img) float32 frame in [0, 1] of the current state."""
        return physics.render(self.cfg, self.state.pos,
                              self.state.radii)[0].numpy()


class BilliardsEnv(PhysicsEnv):
    task = "billiards"


# the public reference repo spells it "billards"; keep both
BillardsEnv = BilliardsEnv


class GravityEnv(PhysicsEnv):
    task = "gravity"


class AvoidanceTask(PhysicsEnv):
    """Action-conditioned billiards; `step(action)` like the reference."""

    task = "avoidance"


def generate_data(task: str = "billiards", num_obj: int = 3,
                  num_train: int = 1000, num_test: int = 300,
                  seq_len: int = 100, data_dir: str = "data",
                  seed: int = 0, pickle_format: bool = True,
                  **overrides) -> Tuple[str, str]:
    """Train and test corpora (compat.py:86): pickles in the reference's
    schema, `<data_dir>/<task>_o<O>_<split>.pkl` holding `X` (N, T, H, W, 1)
    float32 frames (not quantised), `y` (N, T, O, 4), `action` (N, T)
    int64, `reward` (N, T), `done` (N, T) all false and `r` (N, O); or,
    with pickle_format=False, the npz files `envs/data.py` names and
    reads.  Train from seed, test from seed + 1, each from its own
    `torch.Generator`, as `envs/data.py::split` draws them."""
    from stove_tpu_torch.envs import data as data_lib

    cfg = Config().with_overrides(task=task, num_obj=num_obj,
                                  num_train=num_train, num_test=num_test,
                                  seq_len=seq_len, data_dir=data_dir,
                                  seed=seed, **overrides)
    paths = []
    for split, num, salt in (("train", num_train, 0), ("test", num_test, 1)):
        ep = data_lib.generate(cfg, num,
                               torch.Generator().manual_seed(seed + salt),
                               quantize=not pickle_format)
        if pickle_format:
            os.makedirs(data_dir, exist_ok=True)
            path = os.path.join(data_dir, f"{task}_o{num_obj}_{split}.pkl")
            N, T = ep.frames.shape[:2]
            payload = {
                "X": ep.frames.numpy().astype(np.float32)[..., None],
                "y": ep.states.numpy().astype(np.float32),
                "action": ep.actions.numpy().astype(np.int64),
                "reward": ep.rewards.numpy().astype(np.float32),
                "done": np.zeros((N, T), bool),
                "r": ep.radii.numpy().astype(np.float32),
            }
            with open(path, "wb") as f:
                pickle.dump(payload, f)
        else:
            path = data_lib.dataset_path(cfg, split)
            data_lib.save(ep, path)
        paths.append(path)
    return tuple(paths)
