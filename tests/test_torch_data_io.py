"""Corpus files of the port (`stove_tpu_torch/envs/data.py`) against the JAX
package's (`stove_tpu/envs/data.py`, `stove_tpu/compat.py`).

* `dataset_path` names every preset's splits, and a config that overrides
  any one physics field, as the JAX package does.
* A file the JAX package's `save` wrote, and the pickles of its
  `compat.generate_data` (float frames, not quantised) and of a
  reference-schema variant (uint8 frames, one-hot actions, keys left out),
  load in the port to arrays equal to what the JAX package's `load` gives.
* The port's files load in the JAX package's `load` equal to the port's
  `Episode`, dtype for dtype (actions int32 in the file, int64 in the
  port).
* `ensure_dataset` on an empty directory writes and returns `split()`'s
  corpus bit for bit; it then reads the file back, finds the reference's
  "billards" spelling and `.pkl` names, and leaves no temporary file.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from stove_tpu import compat as jcompat
from stove_tpu.config import PRESETS as JPRESETS
from stove_tpu.config import Config as JConfig
from stove_tpu.envs import data as jdata
from stove_tpu_torch.config import PRESETS
from stove_tpu_torch.config import Config as TConfig
from stove_tpu_torch.config import make_config
from stove_tpu_torch.envs import data as tdata

FIELDS = ("frames", "states", "actions", "rewards", "radii")


def _equal(port_ep, jax_ep):
    for name, a, b in zip(FIELDS, port_ep, jax_ep):
        a, b = a.numpy(), np.asarray(b)
        if name == "actions":
            assert a.dtype == np.int64 and b.dtype == np.int32, name
            a = a.astype(np.int32)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_presets_match():
    assert sorted(PRESETS) == sorted(JPRESETS)


@pytest.mark.parametrize("preset", sorted(JPRESETS))
def test_dataset_path_matches_jax_for_every_preset(preset):
    tc = make_config(preset)
    jc = JConfig.from_json(tc.to_json())
    for split in ("train", "test"):
        assert tdata.dataset_path(tc, split) == jdata.dataset_path(jc, split)


def test_dataset_path_matches_jax_for_each_physics_override():
    rng = np.random.default_rng(0)
    base = TConfig()
    for key in tdata.PHYSICS_KEYS:
        v = getattr(base, key)
        new = v + 1 if isinstance(v, int) else float(
            np.float32(v * rng.uniform(1.1, 1.9) + 0.1))
        tc = base.with_overrides(**{key: new}, task="avoidance",
                                 num_train=17, seq_len=33)
        jc = JConfig.from_json(tc.to_json())
        got = tdata.dataset_path(tc, "train")
        assert got == jdata.dataset_path(jc, "train"), key
        assert "_p" in os.path.basename(got), key
    assert "_p" not in tdata.dataset_path(base, "test")


@pytest.fixture(scope="module")
def jax_episode():
    jc = JConfig().with_overrides(task="avoidance", seq_len=6)
    return jc, jdata.generate(jc, 3, jax.random.key(4))


def test_jax_npz_loads_in_the_port(tmp_path, jax_episode):
    _, ep = jax_episode
    path = str(tmp_path / "j.npz")
    jdata.save(ep, path)
    _equal(tdata.load(path), jdata.load(path))
    assert bool(np.asarray(ep.actions).any())


def test_port_npz_loads_in_jax(tmp_path):
    tc = TConfig().with_overrides(task="avoidance", seq_len=6, num_train=3)
    ep = tdata.split(tc, "train")
    path = str(tmp_path / "t.npz")
    tdata.save(ep, path)
    _equal(ep, jdata.load(path))
    assert [p.name for p in tmp_path.iterdir()] == ["t.npz"]


@pytest.mark.parametrize("pickle_format", [True, False],
                         ids=["pickle", "npz"])
def test_jax_generate_data_files_load_in_the_port(tmp_path, pickle_format):
    paths = jcompat.generate_data(task="avoidance", num_obj=3, num_train=3,
                                  num_test=2, seq_len=6,
                                  data_dir=str(tmp_path), seed=1,
                                  pickle_format=pickle_format)
    for path in paths:
        assert path.endswith(".pkl" if pickle_format else ".npz")
        _equal(tdata.load(path), jdata.load(path))


def test_reference_pickle_variants_load_as_in_jax(tmp_path):
    """uint8 frames with a channel axis, one-hot actions, y with extra
    columns, rewards and radii left out: the JAX package's defaults."""
    rng = np.random.default_rng(1)
    N, T, O = 2, 5, 3
    raw = {"X": rng.integers(0, 256, (N, T, 32, 32, 1)).astype(np.uint8),
           "y": rng.standard_normal((N, T, O, 6)).astype(np.float32),
           "action": np.eye(9, dtype=np.float32)[
               rng.integers(0, 9, (N, T))]}
    path = str(tmp_path / "billards_o3_train.pkl")
    with open(path, "wb") as f:
        pickle.dump(raw, f)
    _equal(tdata.load(path), jdata.load(path))
    raw2 = {"X": rng.uniform(-0.2, 1.2, (N, T, 32, 32)),
            "y": rng.standard_normal((N, T, O, 4)),
            "reward": rng.uniform(size=(N, T + 1)),
            "r": np.full((N, O + 1), 1.1)}
    with open(path, "wb") as f:
        pickle.dump(raw2, f)
    _equal(tdata.load(path), jdata.load(path))


def test_ensure_dataset_writes_and_reads_the_split(tmp_path):
    tc = make_config("stove_avoidance", "num_train=4", "num_test=3",
                     "seq_len=7", f"data_dir={tmp_path}")
    for split in ("train", "test"):
        got = tdata.ensure_dataset(tc, split)
        want = tdata.split(tc, split)
        for name, a, b in zip(FIELDS, got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        path = tdata.dataset_path(tc, split)
        assert os.path.exists(path)
        again = tdata.ensure_dataset(tc, split)
        for name, a, b in zip(FIELDS, again, want):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        os.path.basename(tdata.dataset_path(tc, s)) for s in ("train", "test"))


def test_ensure_dataset_finds_the_reference_names(tmp_path):
    tc = TConfig().with_overrides(num_train=2, num_test=2, seq_len=5,
                                  data_dir=str(tmp_path))
    ep = tdata.split(tc, "train")
    path = tdata.dataset_path(tc, "train")
    alt = path.replace("billiards", "billards")
    tdata.save(ep, alt)
    for name, a, b in zip(FIELDS, tdata.ensure_dataset(tc, "train"), ep):
        assert torch.equal(a, b), name
    os.remove(alt)
    payload = {"X": ep.frames.numpy(), "y": ep.states.numpy()}
    with open(path.replace(".npz", ".pkl"), "wb") as f:
        pickle.dump(payload, f)
    got = tdata.ensure_dataset(tc, "train")
    assert torch.equal(got.frames, ep.frames)
    assert torch.equal(got.states, ep.states)
    assert not os.path.exists(path)
