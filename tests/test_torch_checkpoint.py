"""The checkpoint bridge reads the JAX run directory into the port's tree."""

import jax
import numpy as np
import pytest
import torch

from stove_tpu.models.bundle import StoveModel as JaxStoveModel
from stove_tpu_torch.train import checkpoint as ckpt

RUN = "ckpts/r4rp_bill_s32"


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def test_load_params_matches_jax_template():
    flat = ckpt.load_flat(RUN)
    assert len(flat) == 135
    assert ckpt.latest_step(RUN) == 7200
    params = ckpt.load_params(RUN, device="cpu")
    cfg = ckpt.load_config(RUN)
    tpl = jax.eval_shape(JaxStoveModel(cfg).init_params)
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(tpl)[0]}
    got = {path: tuple(leaf.shape) for path, leaf in _leaves(params)}
    assert got == want                      # complete, nothing extra
    for path, leaf in _leaves(params):
        assert leaf.dtype == torch.float32
    # weights stay (in, out) as stored: no transposes on the way in
    np.testing.assert_array_equal(
        params["dynamics"]["embed"][0]["w"].numpy(),
        flat["['params']['dynamics']['embed'][0]['w']"])


def test_params_from_numpy_keeps_structure():
    tree = {"a": [{"w": np.ones((2, 3), np.float32)}], "b": np.zeros(4)}
    out = ckpt.params_from_numpy(tree, "cpu")
    assert out["a"][0]["w"].shape == (2, 3)
    assert out["b"].dtype == torch.float32


@pytest.mark.parametrize("key,parts", [
    ("['params']['dynamics']['embed'][0]['w']",
     ["params", "dynamics", "embed", 0, "w"]),
    ("['epoch']", ["epoch"]),
])
def test_parse_keystr(key, parts):
    assert ckpt.parse_keystr(key) == parts


@pytest.mark.parametrize("key", ["params", "['a'].b", "['a'][x]"])
def test_parse_keystr_rejects(key):
    with pytest.raises(ValueError):
        ckpt.parse_keystr(key)
