"""The posterior scan of the port against `stove_tpu/models/stove.py::_scan_xla`
and `stove_tpu/ops/pallas_scan.py::scan_fused` (interpret mode, float32
weights), for all three `velocity_obs` modes and without the velocity
posterior.

Inputs are made with JAX's random functions at small shapes (B=8, T2=4,
`debug_shrunk` widths, a nonzero last output layer so the dynamics move)
and handed to both as numpy arrays.  Tolerances: the kernel and XLA hold
each other to rtol 1e-4, atol 2e-4 in tests/test_pallas.py; the port's
plain loop sums the same float32 products in another order, so the same.
Gradients through `scan_impl="pallas"` on the CPU (the autograd function
around the plain loop) equal the plain loop's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.models import dynamics as jdyn
from stove_tpu.models import stove as jstove
from stove_tpu.ops import pallas_rollout as jpr
from stove_tpu.ops import pallas_scan as jps
from stove_tpu_torch import tree
from stove_tpu_torch.config import Config as TConfig
from stove_tpu_torch.models import stove as tstove
from stove_tpu_torch.ops import fused_scan
from stove_tpu_torch.train import checkpoint as ckpt

MODES = {
    "encoder_full_std": dict(velocity_obs="encoder"),
    "encoder_t_frame_std": dict(velocity_obs="encoder",
                                velocity_obs_full_std=False),
    "filtered": dict(velocity_obs="filtered"),
    "no_velocity_posterior": dict(velocity_posterior=False),
}
TOL = dict(rtol=1e-4, atol=2e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _setup(**kw):
    jc = JConfig().debug_shrunk().with_overrides(**kw)
    tc = TConfig.from_json(jc.to_json())
    dyn = jdyn.init_params(jax.random.key(1), jc)
    dyn["out"][-1]["w"] = 0.05 * jax.random.normal(
        jax.random.key(5), dyn["out"][-1]["w"].shape)
    B, T2, O, D = 8, 4, jc.num_obj, jc.full_state_dim
    ks = jax.random.split(jax.random.key(2), 8)
    args = (0.1 * jax.random.normal(ks[0], (B, O, D)),
            0.1 * jax.random.normal(ks[1], (B, O, 2)),
            0.1 + 0.1 * jax.random.uniform(ks[2], (B, O, 2)),
            0.3 * jax.random.normal(ks[3], (B, T2, O, 4)),
            0.05 + 0.1 * jax.random.uniform(ks[4], (B, T2, O, 4)),
            jnp.zeros((B, T2), jnp.int32),
            jax.random.normal(ks[6], (B, T2, O, D)))
    targs = [_t(a) for a in args]
    targs[5] = targs[5].long()
    return jc, tc, dyn, ckpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, dyn), "cpu"), args, targs


@pytest.mark.parametrize("mode", list(MODES))
def test_scan_matches_jax_xla_and_pallas_interpret(mode):
    jc, tc, jdyn_p, tdyn_p, args, targs = _setup(**MODES[mode])
    with jax.default_matmul_precision("float32"):
        want = jstove._scan_xla(jdyn_p, jc, *args)
    prepared = jpr.prepare_params(jdyn_p, jc, jnp.float32)
    kernel = jps.scan_fused(prepared, jc, *args, block=8, dtype=jnp.float32,
                            interpret=True)
    for impl in ("xla", "pallas"):
        got = tstove.scan_posterior(
            tdyn_p, tc.with_overrides(scan_impl=impl), *targs)
        for name, a, b, k in zip(("z", "z_mean", "kl", "rewards"), got, want,
                                 kernel):
            np.testing.assert_allclose(a, b, err_msg=f"{impl} {name} xla",
                                       **TOL)
            np.testing.assert_allclose(a, k, err_msg=f"{impl} {name} kernel",
                                       **TOL)
    assert fused_scan.launch_kernel.launches == 0


def test_scan_gradient_through_pallas_impl_equals_plain():
    jc, tc, jdyn_p, tdyn_p, args, targs = _setup()

    def grads(impl):
        leaves = [x.clone().requires_grad_(True)
                  for x in tree.leaves(tdyn_p)]
        ins = [x.clone().requires_grad_(x.is_floating_point())
               for x in targs]
        z, zm, kl, _ = tstove.scan_posterior(
            tree.unflatten(tdyn_p, leaves),
            tc.with_overrides(scan_impl=impl), *ins)
        (z.square().sum() + zm.sum() + kl.sum()).backward()
        return [x.grad for x in leaves] + [x.grad for x in ins if
                                           x.is_floating_point()]

    for a, b in zip(grads("pallas"), grads("xla")):
        np.testing.assert_array_equal(a, b)


def test_scan_gradient_matches_jax():
    jc, tc, jdyn_p, tdyn_p, args, targs = _setup(velocity_obs="filtered")

    def jloss(p, z1, sm):
        z, zm, kl, _ = jstove._scan_xla(p, jc, z1, args[1], args[2], sm,
                                        *args[4:])
        return jnp.sum(z ** 2) + jnp.sum(zm) + jnp.sum(kl)

    with jax.default_matmul_precision("float32"):
        jg = jax.grad(jloss, argnums=(0, 1, 2))(jdyn_p, args[0], args[3])
    leaves = [x.clone().requires_grad_(True) for x in tree.leaves(tdyn_p)]
    z1 = targs[0].clone().requires_grad_(True)
    sm = targs[3].clone().requires_grad_(True)
    z, zm, kl, _ = tstove.scan_posterior(
        tree.unflatten(tdyn_p, leaves), tc.with_overrides(scan_impl="pallas"),
        z1, targs[1], targs[2], sm, *targs[4:])
    (z.square().sum() + zm.sum() + kl.sum()).backward()
    want = jax.tree_util.tree_leaves(jg[0])
    assert len(want) == len(leaves)
    for a, b in zip([x.grad for x in leaves] + [z1.grad, sm.grad],
                    want + [jg[1], jg[2]]):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a      # unused reward head
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(b).max())))


def test_scan_kernel_rejects_what_it_does_not_implement():
    tc = TConfig(reward_head=False)
    dyn = {"reward": []}
    with pytest.raises(NotImplementedError, match="action-conditioned"):
        fused_scan.check_supported(tc.with_overrides(action_conditioned=True),
                                   {})
    with pytest.raises(NotImplementedError, match="reward head"):
        fused_scan.check_supported(tc.with_overrides(reward_head=True), dyn)
    fused_scan.check_supported(tc, {})
    with pytest.raises(ValueError, match="padded output width"):
        fused_scan.check_supported(tc.debug_shrunk(), {})
    assert [fused_scan.velocity_mode(tc.with_overrides(**kw))
            for kw in MODES.values()] == [2, 1, 3, 0]
