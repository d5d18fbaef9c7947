"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
noise the JAX package draws from its keys, handed to the port explicitly."""

import contextlib
import functools

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


def jax_elbo_noise(key, cfg, B, T):
    """The normals `stove_tpu.models.stove.elbo` draws from `key`: infer's,
    then the overshoot's open-loop draws (overshoot_losses)."""
    from stove_tpu_torch.models.stove import ElboNoise
    key, k_os = jax.random.split(key)
    over = None
    K = cfg.overshoot_k
    if cfg.overshoot_sample and 0 < K < T:
        draws = []
        for _ in range(K):
            k_os, k_s = jax.random.split(k_os)
            draws.append(jax.random.normal(
                k_s, (B * (T - K), cfg.num_obj, cfg.full_state_dim),
                jnp.float32))
        over = _t(jnp.stack(draws))
    return ElboNoise(jax_infer_noise(key, cfg, B, T), over)


def jax_supair_noise(key, B, O):
    """The normals `stove_tpu.models.supair.elbo` draws from `key`."""
    return _t(jax.random.normal(key, (B, O, 4), jnp.float32))


def jax_spec_seeds(cfg):
    """The RAT-SPN permutation seeds the JAX package draws for `cfg`
    (StoveModel's key(cfg.seed), split in supair.make_specs)."""
    from stove_tpu_torch.models.supair import SpecSeeds
    k_obj, k_bg = jax.random.split(jax.random.key(cfg.seed))

    def draw(k, n):
        return tuple(int(s) for s in jax.random.randint(k, (n,), 0,
                                                        2 ** 31 - 1))

    return SpecSeeds(draw(k_obj, cfg.obj_spn_repetitions),
                     draw(k_bg, cfg.bg_spn_repetitions))


def to_jax(tree):
    """A nested dict/list of tensors as jnp arrays."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x.detach().numpy()),
                                  tree)


@contextlib.contextmanager
def jax_scan_pallas_interpret(block: int = 8):
    """Within the block (trace inside it), `scan_impl="pallas"` of the JAX
    package runs its Pallas kernel on the CPU, where `scan_posterior` would
    take the XLA scan (its gate `supair._pallas_available()` probes for a
    TPU): `pallas_scan.scan_fused` in interpret mode with `block` samples a
    tile (the TPU's 256 would pad the tests' few windows to 256 rows).  Its
    forward stays the bfloat16 kernel `_scan_pallas` prepares and its
    backward the float32 XLA scan (stove.py:304-333).  Only the scan: the
    configs these tests give JAX keep the other impls off Pallas."""
    from stove_tpu.models import supair
    from stove_tpu.ops import pallas_scan
    orig, gate = pallas_scan.scan_fused, supair._pallas_available
    pallas_scan.scan_fused = functools.partial(orig, block=block,
                                               interpret=True)
    supair._pallas_available = lambda: True
    try:
        yield
    finally:
        pallas_scan.scan_fused, supair._pallas_available = orig, gate


def straight_through_scan(scan_reference):
    """The plain scan with `scan_impl="pallas"`'s semantics, built without
    the port's autograd function: each output has the plain bf16 loop's
    values and passes the float32 loop's gradient straight through
    (bf16 + (f32 - f32.detach())).  Patched in for
    `fused_scan.scan_reference`, it is what the dispatch should equal."""
    def scan(*args, dtype="float32"):
        f32 = scan_reference(*args)
        bf = scan_reference(*args, dtype="bfloat16")
        return tuple(b.detach() + (f - f.detach()) for f, b in zip(f32, bf))
    return scan
