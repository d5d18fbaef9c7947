"""Reference-style shims of the port (`stove_tpu_torch/compat.py`) against
`stove_tpu/compat.py`.

* `BilliardsEnv` (and `BillardsEnv`), `GravityEnv` and `AvoidanceTask`,
  both packages' envs set to one numpy-seeded initial state, step 5 times
  with the same actions: the state vectors agree to 1e-4 arena units (the
  physics tests' limit), the frames to 4e-3 (one uint8 level: a rendered
  pixel moves by at most ~3.2 x the position difference), the rewards
  exactly.
* `generate_data` writes the reference's pickle schema (`X` (N, T, H, W,
  1) float32 unquantised, `y`, `action` int64, `reward`, `done`, `r`) and
  the JAX package's npz files; both load in either package to equal
  arrays, and the train split is `split()`'s corpus.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu import compat as jcompat
from stove_tpu.envs import data as jdata
from stove_tpu.envs import physics as jphys
from stove_tpu_torch import compat as tcompat
from stove_tpu_torch.config import Config as TConfig
from stove_tpu_torch.envs import data as tdata
from stove_tpu_torch.envs import physics as tphys

ENVS = [("BilliardsEnv", 3), ("BillardsEnv", 2), ("GravityEnv", 3),
        ("AvoidanceTask", 3)]


def _start(env, rng):
    """A non-overlapping numpy start for `env`'s config: balls on a
    diagonal, random headings at the config's speed."""
    cfg = env.cfg
    O = cfg.num_obj
    pos = np.stack([np.linspace(2.0, 8.0, O), np.linspace(2.5, 7.0, O)],
                   -1).astype(np.float32)
    pos += rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, O)
    vel = (0.8 * np.stack([np.cos(ang), np.sin(ang)], -1)).astype(np.float32)
    radii = np.full(O, cfg.ball_radius, np.float32)
    return pos, vel, radii, np.ones(O, np.float32)


@pytest.mark.parametrize("name,num_obj", ENVS)
def test_envs_step_as_jax(name, num_obj):
    rng = np.random.default_rng(num_obj + len(name))
    jenv = getattr(jcompat, name)(num_obj=num_obj, seed=3)
    tenv = getattr(tcompat, name)(num_obj=num_obj, seed=3)
    assert tenv.cfg.task == jenv.cfg.task
    pos, vel, radii, masses = _start(tenv, rng)
    jenv.state = jphys.EnvState(*(jnp.asarray(a) for a in
                                  (pos, vel, radii, masses)))
    tenv.state = tphys.EnvState(*(torch.from_numpy(a)[None] for a in
                                  (pos, vel, radii, masses)))
    np.testing.assert_allclose(tenv.render(), jenv.render(), atol=1e-5)
    actions = rng.integers(0, 9, 5)
    for a in actions:
        jf, js, jr = jenv.step(int(a))
        tf, ts, tr = tenv.step(int(a))
        assert tf.shape == (32, 32) and ts.shape == (num_obj, 4)
        np.testing.assert_allclose(ts, js, atol=1e-4)
        np.testing.assert_allclose(tf, jf, atol=4e-3)
        assert tr == jr


def test_env_reset_draws_from_its_seed():
    a = tcompat.BilliardsEnv(seed=5)
    b = tcompat.BilliardsEnv(seed=5)
    np.testing.assert_array_equal(a.render(), b.render())
    frame = a.reset()
    assert frame.shape == (32, 32) and frame.dtype == np.float32
    assert not np.array_equal(frame, b.render())
    assert tcompat.BillardsEnv is tcompat.BilliardsEnv
    rewards = {tcompat.AvoidanceTask(seed=1).step(a % 9)[2]
               for a in range(3)}
    assert rewards <= {0.0, 1.0}


def test_generate_data_pickles(tmp_path):
    train, test = tcompat.generate_data(task="avoidance", num_obj=3,
                                        num_train=3, num_test=2, seq_len=6,
                                        data_dir=str(tmp_path), seed=2)
    assert train.endswith("avoidance_o3_train.pkl")
    with open(train, "rb") as f:
        raw = pickle.load(f)
    assert raw["X"].shape == (3, 6, 32, 32, 1) and raw["X"].dtype == np.float32
    assert raw["action"].dtype == np.int64 and raw["done"].dtype == bool
    assert set(raw) == {"X", "y", "action", "reward", "done", "r"}
    cfg = TConfig().with_overrides(task="avoidance", num_train=3, seq_len=6,
                                   seed=2)
    ep = tdata.split(cfg, "train")
    got = tdata.load(train)
    for name, a, b in zip(tdata.Episode._fields, got, ep):
        assert torch.equal(a, b), name
    for path in (train, test):
        jep = jdata.load(path)
        for name, a, b in zip(tdata.Episode._fields, tdata.load(path), jep):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


def test_generate_data_npz(tmp_path):
    train, test = tcompat.generate_data(task="gravity", num_obj=3,
                                        num_train=2, num_test=2, seq_len=5,
                                        data_dir=str(tmp_path), seed=4,
                                        pickle_format=False)
    cfg = TConfig().with_overrides(task="gravity", num_train=2, num_test=2,
                                   seq_len=5, seed=4, data_dir=str(tmp_path))
    assert (train, test) == (tdata.dataset_path(cfg, "train"),
                             tdata.dataset_path(cfg, "test"))
    for split, path in (("train", train), ("test", test)):
        ep = tdata.split(cfg, split)
        for name, a, b in zip(tdata.Episode._fields, jdata.load(path), ep):
            np.testing.assert_array_equal(np.asarray(a), b.numpy()
                                          .astype(np.asarray(a).dtype),
                                          err_msg=name)
