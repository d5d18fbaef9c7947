"""Helpers shared by the port's parity tests (tests/test_torch_*.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stove_tpu_torch.models.stove import InferNoise


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_infer_noise(key, cfg, B, T):
    """The normals `stove_tpu.models.stove.infer` draws from `key`."""
    key, k0, k1, kl0 = jax.random.split(key, 4)
    O, D = cfg.num_obj, cfg.full_state_dim
    keys = jax.random.split(key, T - 2)
    eps = jnp.moveaxis(jax.vmap(lambda k: jax.random.normal(
        k, (B, O, D), jnp.float32))(keys), 0, 1)
    return InferNoise(
        _t(jax.random.normal(k0, (B, O, 4), jnp.float32)),
        _t(jax.random.normal(k1, (B, O, 4), jnp.float32)),
        _t(jax.random.normal(kl0, (B, O, cfg.cl), jnp.float32)),
        _t(eps))
