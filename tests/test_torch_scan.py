"""The posterior scan of the port against `stove_tpu/models/stove.py::_scan_xla`
and `stove_tpu/ops/pallas_scan.py::scan_fused` (interpret mode), for all
three `velocity_obs` modes, without the velocity posterior, and for an
action-conditioned model with random actions; every mode runs the reward
head (the reference runs it whenever its weights exist) and compares its
rewards.  `scan_impl="xla"` is held to the XLA scan and the float32
kernel; `scan_impl="pallas"`, whose forward is bfloat16 as `_scan_pallas`
prepares it (stove.py:313), to the bfloat16 kernel.

Inputs are made with JAX's random functions at small shapes (B=8, T2=4,
`debug_shrunk` widths, a nonzero last output layer so the dynamics move)
and handed to both as numpy arrays.  Tolerances: the kernel and XLA hold
each other to rtol 1e-4, atol 2e-4 in tests/test_pallas.py; the port's
plain loop sums the same products in another order, so the same.
Gradients through `scan_impl="pallas"` on the CPU (the autograd function
around the plain loop) are the float32 plain loop's VJP at the cotangents
of the bfloat16 forward, bit for bit, as `_scan_pallas_bwd`.
"""

from pathlib import Path

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
from stove_tpu_torch.models import dynamics as tdyn
from stove_tpu_torch.models import stove as tstove
from stove_tpu_torch.ops import fused_rollout as fr
from stove_tpu_torch.ops import fused_scan
from stove_tpu_torch.train import checkpoint as ckpt
from torch_parity import jax_scan_pallas_interpret

MODES = {
    "encoder_full_std": dict(velocity_obs="encoder"),
    "encoder_t_frame_std": dict(velocity_obs="encoder",
                                velocity_obs_full_std=False),
    "filtered": dict(velocity_obs="filtered"),
    "no_velocity_posterior": dict(velocity_posterior=False),
    "actions_reward_head": dict(action_conditioned=True, reward_head=True),
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
            (jax.random.randint(ks[5], (B, T2), 0, jc.num_actions)
             if jc.action_conditioned else jnp.zeros((B, T2), jnp.int32)),
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
    kernels = {dt: jps.scan_fused(jpr.prepare_params(jdyn_p, jc, dt), jc,
                                  *args, block=8, dtype=dt, interpret=True)
               for dt in (jnp.float32, jnp.bfloat16)}
    refs = {"xla": {"xla": want, "kernel f32": kernels[jnp.float32]},
            "pallas": {"kernel bf16": kernels[jnp.bfloat16]}}
    for impl, against in refs.items():
        got = tstove.scan_posterior(
            tdyn_p, tc.with_overrides(scan_impl=impl), *targs)
        for ref_name, ref in against.items():
            for name, a, b in zip(("z", "z_mean", "kl", "rewards"), got, ref):
                np.testing.assert_allclose(
                    a, b, err_msg=f"{impl} {name} {ref_name}", **TOL)
    # the bf16 forward is another function than the float32 one
    assert np.abs(np.asarray(kernels[jnp.bfloat16][0])
                  - np.asarray(want[0])).max() > 10 * TOL["atol"]
    assert fused_scan.launch_kernel.launches == 0


def test_scan_gradient_through_pallas_impl_equals_plain():
    _, tc, _, tdyn_p, _, targs = _setup()
    _assert_pallas_gradient_equals_plain(tc, tdyn_p, targs)


def test_scan_gradient_with_actions_and_rewards_equals_plain():
    """The action-conditioned scan, with the rewards in the loss."""
    _, tc, _, tdyn_p, _, targs = _setup(**MODES["actions_reward_head"])
    assert targs[5].abs().sum() > 0
    _assert_pallas_gradient_equals_plain(tc, tdyn_p, targs)


def _assert_pallas_gradient_equals_plain(tc, tdyn_p, targs):
    """The gradient through scan_impl="pallas" is the float32 plain loop's
    VJP at the cotangents its (bfloat16) forward gives the loss."""
    def fresh():
        return ([x.clone().requires_grad_(True) for x in tree.leaves(tdyn_p)],
                [x.clone().requires_grad_(x.is_floating_point())
                 for x in targs])

    def grads(leaves, ins):
        return [x.grad for x in leaves] + [x.grad for x in ins if
                                           x.is_floating_point()]

    leaves, ins = fresh()
    z, zm, kl, rew = tstove.scan_posterior(
        tree.unflatten(tdyn_p, leaves),
        tc.with_overrides(scan_impl="pallas"), *ins)
    (z.square().sum() + zm.sum() + kl.sum() + rew.sum()).backward()
    got = grads(leaves, ins)
    leaves, ins = fresh()
    plain = tstove.scan_posterior(tree.unflatten(tdyn_p, leaves),
                                  tc.with_overrides(scan_impl="xla"), *ins)
    assert not torch.equal(plain[0], z)            # the forward is bf16
    torch.autograd.backward(plain, (2 * z.detach(), torch.ones_like(zm),
                                    torch.ones_like(kl),
                                    torch.ones_like(rew)))
    want = grads(leaves, ins)
    assert any(g is not None and g.abs().max() > 0 for g in got)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_scan_gradient_matches_jax():
    """scan_impl="pallas" on both sides: the bfloat16 kernel's forward (in
    interpret mode) and the float32 XLA scan's VJP (_scan_pallas)."""
    jc, tc, jdyn_p, tdyn_p, args, targs = _setup(velocity_obs="filtered")
    jcp = jc.with_overrides(scan_impl="pallas")

    def jloss(p, z1, sm):
        z, zm, kl, _ = jstove.scan_posterior(p, jcp, z1, args[1], args[2], sm,
                                             *args[4:])
        return jnp.sum(z ** 2) + jnp.sum(zm) + jnp.sum(kl)

    with jax.default_matmul_precision("float32"), jax_scan_pallas_interpret():
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
    """Actions and the reward head are in the kernel (their libraries are
    built with -DSTOVE_ACT / -DSTOVE_NA and -DSTOVE_REW, set apart); other
    depths, more than 4 objects and the width rules still raise."""
    tc = TConfig()
    dyn = {"reward": []}
    fused_scan.check_supported(tc.with_overrides(action_conditioned=True), {})
    fused_scan.check_supported(tc.with_overrides(reward_head=True), dyn)
    fused_scan.check_supported(tc.with_overrides(action_conditioned=True,
                                                 reward_head=True), dyn)
    with pytest.raises(ValueError, match="dyn_layers=2"):
        fused_scan.check_supported(tc.with_overrides(dyn_layers=3), {})
    with pytest.raises(ValueError, match="num_obj <= 4"):
        fused_scan.check_supported(tc.with_overrides(num_obj=5), {})
    with pytest.raises(ValueError, match="padded output width"):
        fused_scan.check_supported(tc.debug_shrunk(), {})
    assert [fused_scan.velocity_mode(tc.with_overrides(**kw))
            for kw in MODES.values()] == [2, 1, 3, 0, 2]


def test_scan_jobs_by_variant():
    """One library per variant: the action term with the action count, the
    reward head on its own (the reference runs it without actions too, and
    kernel_config drops it where the params hold none), each at the tile
    `tile_for` picks from B; every variant builds on the one dynamics core,
    whose bf16 matmul is mma.sync m16n8k16, with no switch to another."""
    base = TConfig(reward_head=False)
    jobs = {
        "plain": fused_scan.job(base),
        "reward": fused_scan.job(base.with_overrides(reward_head=True)),
        "actions": fused_scan.job(base.with_overrides(
            action_conditioned=True, num_actions=5)),
        "both": fused_scan.job(ckpt.load_config("ckpts/r4a_dense_s2")),
    }
    heads = {k: tuple(d for d in v[1] if "ACT" in d or "_NA" in d
                      or "REW" in d) for k, v in jobs.items()}
    assert heads == {"plain": (), "reward": ("-DSTOVE_REW=1",),
                     "actions": ("-DSTOVE_ACT=1", "-DSTOVE_NA=5"),
                     "both": ("-DSTOVE_ACT=1", "-DSTOVE_NA=9",
                              "-DSTOVE_REW=1")}
    assert all(v[0] == "scan.cu" for v in jobs.values())
    no_head = fr.kernel_config(TConfig(reward_head=True), {})
    assert fused_scan.job(no_head) == jobs["plain"]
    # the tile: the training batch's by default, tile_for(B) at launch
    tile = fused_scan.tile_for(256)
    assert tile == fr.SMALL_TILE
    for cfg in [base, base.with_overrides(reward_head=True),
                ckpt.load_config("ckpts/r4a_dense_s2")] + [
            base.with_overrides(**kw) for kw in MODES.values()]:
        for dtype in fr.DTYPES:
            for B, want in ((256, tile), (16 * 131, tile), (16 * 132, 16),
                            (16384, 16)):
                d = fused_scan.job(cfg, dtype, fused_scan.tile_for(B))[1]
                assert f"-DSTOVE_TB={want}" in d
                assert ("-DSTOVE_BF16=1" in d) == (dtype == "bfloat16")
            assert f"-DSTOVE_TB={tile}" in fused_scan.job(cfg, dtype)[1]
    csrc = Path(fused_scan.__file__).resolve().parents[1] / "csrc"
    assert '#include "dyn_core.cuh"' in (csrc / "scan.cu").read_text()
    assert "mma.sync.aligned.m16n8k16" in (csrc / "dyn_core.cuh").read_text()
    assert not any("STOVE_MMA" in f.read_text() for f in csrc.iterdir())


SCAN_VARIANTS = {
    "billiards": ("ckpts/r4rp_bill_s32", {}),
    "t_frame_std": ("ckpts/r4rp_bill_s32", dict(velocity_obs_full_std=False)),
    "filtered": ("ckpts/r4rp_bill_s32", dict(velocity_obs="filtered")),
    "no_velocity_posterior": ("ckpts/r4rp_bill_s32",
                              dict(velocity_posterior=False)),
    "actions_reward_head": ("ckpts/r4a_dense_s2", {}),
    "gravity_open_head": ("ckpts/r4rp_grav_s32", {}),
}


@pytest.mark.parametrize("dtype", fr.DTYPES)
@pytest.mark.parametrize("variant", list(SCAN_VARIANTS))
def test_scan_weight_buffer_is_the_rollouts(variant, dtype):
    """The scan's weight buffer (`fused_scan.prepare_params`, what
    `scan_kernel` packs once a call) is the rollout kernel's
    (`fused_rollout.prepare_params`) without the open-loop head, for every
    variant and precision: the size the library reads, the prefix of the
    buffer with the head, and it unpacks to the checkpoint's weights (the
    matrices and action rows rounded to bf16 in the bf16 buffer)."""
    run, kw = SCAN_VARIANTS[variant]
    cfg = ckpt.load_config(run).with_overrides(**kw)
    dyn = ckpt.load_params(run, device="cpu")["dynamics"]
    kcfg = fr.kernel_config(cfg, dyn)
    buf = fused_scan.prepare_params(dyn, cfg, dtype)
    assert buf.dtype == torch.uint8
    assert buf.numel() == fr.kernel_bytes(kcfg, False, dtype)
    no_open = {k: v for k, v in dyn.items() if k != "open"}
    assert torch.equal(buf, fr.prepare_params(no_open, cfg, dtype))
    full = fr.prepare_params(dyn, cfg, dtype)
    assert torch.equal(full[:buf.numel()], buf)
    assert (full.numel() > buf.numel()) == (variant == "gravity_open_head")
    got = fr.unpack_params(buf, kcfg, False, dtype)
    flat, off = fr.flat_params(no_open, cfg), 0
    mats = {n for n, _, m in fr.kernel_layout(kcfg) if m}
    for name, shape in fr.param_layout(kcfg):
        want = flat[off:off + int(np.prod(shape))].reshape(shape)
        off += want.numel()
        if dtype == "bfloat16" and (name in mats or name == "w_e0a"):
            want = tdyn.bf16_round(want)
        g = got[name][:shape[0]] if name == "w_e0" else got[name]
        assert torch.equal(g, want), name
    assert off == flat.numel() == fr.param_count(kcfg)
    assert ("w_h0" in got) == bool(kcfg.reward_head)
    assert ("w_e0a" in got) == bool(kcfg.action_conditioned)
