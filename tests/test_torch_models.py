"""Port modules against the JAX package on the same inputs: Gaussian
algebra, matching, dynamics.apply, the encoder and the SuPAIR prior.

Inputs come from numpy with fixed seeds; random weights come from the JAX
package's own init at `Config().debug_shrunk()` widths, the trained ones
from ckpts/r4rp_bill_s32.  Tolerances: elementwise Gaussian algebra is the
same float32 formula in both frameworks (atol 1e-6); the MLPs and convs
sum in a different order (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.models import dynamics as jdyn
from stove_tpu.models import encoder as jenc
from stove_tpu.models import supair as jsup
from stove_tpu.ops import gaussians as jg
from stove_tpu.ops import matching as jm
from stove_tpu_torch.config import Config as TConfig
from stove_tpu_torch.models import dynamics as tdyn
from stove_tpu_torch.models import encoder as tenc
from stove_tpu_torch.models import supair as tsup
from stove_tpu_torch.ops import gaussians as tg
from stove_tpu_torch.ops import matching as tm
from stove_tpu_torch.train import checkpoint as ckpt


def _t(x):
    return torch.from_numpy(np.array(x))


def _params(jtree):
    return ckpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _cfgs(**kw):
    j = JConfig().debug_shrunk().with_overrides(**kw)
    return j, TConfig.from_json(j.to_json())


# ------------------------------------------------------------------ gaussians

def test_gaussians_match_jax():
    rng = np.random.default_rng(0)
    x, ma, mb = (rng.normal(size=(4, 3, 7)).astype(np.float32)
                 for _ in range(3))
    sa, sb = (rng.uniform(0.05, 2.0, (4, 3, 7)).astype(np.float32)
              for _ in range(2))
    eps = rng.normal(size=(4, 3, 7)).astype(np.float32)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg.log_prob(_t(x), _t(ma), _t(sa)),
                               jg.log_prob(x, ma, sa), **tol)
    np.testing.assert_allclose(tg.log_prob(_t(x), 0.35, 0.25),
                               jg.log_prob(x, 0.35, 0.25), **tol)
    for got, want in zip(tg.product(_t(ma), _t(sa), _t(mb), _t(sb)),
                         jg.product(ma, sa, mb, sb)):
        np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(tg.kl(_t(ma), _t(sa), _t(mb), _t(sb)),
                               jg.kl(ma, sa, mb, sb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg.bounded_std(_t(x), 0.01, 0.3),
                               jg.bounded_std(x, 0.01, 0.3), **tol)
    # sample: the JAX draw is mean + std * normal(key); hand its normals in
    key = jax.random.key(3)
    want = jg.sample(key, ma, sa)
    normals = np.asarray(jax.random.normal(key, ma.shape, jnp.float32))
    np.testing.assert_allclose(tg.sample(_t(ma), _t(sa), _t(normals)),
                               want, **tol)


# ------------------------------------------------------------------ matching

@pytest.mark.parametrize("seed,tie", [(0, False), (1, False), (2, True)])
def test_matching_matches_jax(seed, tie):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (16, 3, 2)).astype(np.float32)
    true = rng.uniform(0, 1, (16, 3, 2)).astype(np.float32)
    if tie:                      # two identical predicted slots: a tie
        pred[:, 2] = pred[:, 1]
    perm = tm.match_positions(_t(pred), _t(true))
    np.testing.assert_array_equal(perm, jm.match_positions(pred, true))
    x = rng.normal(size=(16, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(tm.apply_permutation(_t(x), perm),
                                  jm.apply_permutation(x, np.asarray(perm)))


# ------------------------------------------------------------------ dynamics

@pytest.mark.parametrize("kw", [
    dict(),
    dict(latent_residual=False),
    dict(action_conditioned=True, reward_head=True),
    dict(open_loop_sigma=True),
], ids=["plain", "no_residual", "action_reward", "open_sigma"])
def test_dynamics_apply_random_weights(kw):
    jc, tc = _cfgs(**kw)
    jp = jdyn.init_params(jax.random.key(1), jc)
    # the init zeroes the last out layer; perturb it so Δv, Δℓ, σ are live
    w = jp["out"][-1]["w"]
    jp["out"][-1]["w"] = 0.3 * jax.random.normal(jax.random.key(2), w.shape)
    rng = np.random.default_rng(5)
    z = rng.normal(0, 0.5, (6, jc.num_obj, jc.full_state_dim)).astype(
        np.float32)
    act = rng.integers(0, jc.num_actions, (6,)).astype(np.int32)
    want = jdyn.apply(jp, jc, z, act if jc.action_conditioned else None)
    got = tdyn.apply(_params(jp), tc, _t(z),
                     _t(act).long() if tc.action_conditioned else None)
    for name in ("mean", "std", "reward", "std_open"):
        np.testing.assert_allclose(getattr(got, name),
                                   getattr(want, name), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_dynamics_apply_trained_weights():
    run = "ckpts/r4rp_bill_s32"
    tc = ckpt.load_config(run)
    jc = JConfig.from_json(tc.to_json())
    params = ckpt.load_params(run, device="cpu")["dynamics"]
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), params)
    rng = np.random.default_rng(7)
    z = rng.normal(0, 0.3, (8, 3, tc.full_state_dim)).astype(np.float32)
    want = jdyn.apply(jp, jc, z)
    got = tdyn.apply(params, tc, _t(z))
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.std, want.std, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ encoder

@pytest.mark.parametrize("kw", [
    dict(encoder_space_to_depth=2),
    dict(encoder_space_to_depth=1),
    dict(encoder_space_to_depth=2, encoder_final_stride1=True),
    dict(encoder_space_to_depth=1, img_size=30),
], ids=["s2d2", "s2d1", "final_stride1", "odd_sizes"])
def test_encoder_matches_jax(kw):
    jc, tc = _cfgs(**kw)
    jp = jenc.init_params(jax.random.key(4), jc)
    # the head init is tiny (scale 0.01); widen it so tanh/sigmoid matter
    jp["head"]["w"] = jp["head"]["w"] * 30.0
    rng = np.random.default_rng(6)
    frames = rng.uniform(0, 1, (5, jc.img_size, jc.img_size)).astype(
        np.float32)
    wm, ws = jenc.apply(jp, jc, frames)
    gm, gs = tenc.apply(_params(jp), tc, _t(frames))
    np.testing.assert_allclose(gm, wm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)


def test_where_prior_logp_matches_jax():
    jc, tc = _cfgs()
    rng = np.random.default_rng(8)
    boxes = rng.uniform(-1, 1, (7, jc.num_obj, 4)).astype(np.float32)
    np.testing.assert_allclose(tsup.where_prior_logp(tc, _t(boxes)),
                               jsup.where_prior_logp(jc, boxes),
                               rtol=1e-6, atol=1e-5)
