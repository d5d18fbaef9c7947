"""STOVE inference and rollout of the port against the JAX package.

`infer` gets the very normals JAX draws inside `stove.infer` (the key
splits of stove.py:155-191 reproduced with jax.random), so both run the
same posterior.  The plain rollout is held to `stove.rollout` and to the
Pallas kernel in interpret mode at float32.  Tolerances: one dynamics
step or encoder pass agrees to ~1e-6; the recursion and the rollouts
carry that through a chaotic learned map for up to 8 steps, so
trajectories are held to atol 1e-4 and the KL (a sum of ~300 log
densities of size ~10) to rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.models import dynamics as jdyn
from stove_tpu.models import encoder as jenc
from stove_tpu.models import stove as jstove
from stove_tpu.ops import pallas_rollout as jpr
from stove_tpu_torch.config import Config as TConfig
from stove_tpu_torch.models import stove as tstove
from stove_tpu_torch.ops import fused_rollout as tfr
from stove_tpu_torch.train import checkpoint as ckpt
from torch_parity import jax_infer_noise

RUN = "ckpts/r4rp_bill_s32"


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def trained():
    tc = ckpt.load_config(RUN)
    tp = ckpt.load_params(RUN, device="cpu")
    jc = JConfig.from_json(tc.to_json())
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tp)
    return jc, jp, tc, tp


@pytest.fixture(scope="module")
def frames():
    """8 windows of 8 frames from the JAX physics and renderer."""
    from stove_tpu.envs import data as jdata
    cfg = JConfig.from_json(open(f"{RUN}/config.json").read()).with_overrides(
        seq_len=8)
    ep = jdata.generate(cfg, 8, jax.random.key(11))
    return np.asarray(jdata.normalize_frames(ep.frames))


# ------------------------------------------------------------ align_slots

@pytest.mark.parametrize("O,tie", [(3, False), (3, True), (4, True),
                                   (5, False)])
def test_align_slots_matches_jax(O, tie):
    rng = np.random.default_rng(O + 10 * tie)
    ref = rng.uniform(-1, 1, (32, O, 2)).astype(np.float32)
    new = rng.uniform(-1, 1, (32, O, 2)).astype(np.float32)
    if tie:
        # two new slots at the same place give equal-cost permutations.  On
        # a 1/8 grid every cost and permutation total is exact in float32,
        # so the tie is exact whatever order either framework sums in, and
        # both must keep the first minimal permutation.
        ref = np.round(ref * 8) / 8
        new = np.round(new * 8) / 8
        new[:, 1] = new[:, 0]
    vals = rng.normal(size=(32, O, 4)).astype(np.float32)
    want = jstove.align_slots(ref, new, vals, new)
    got = tstove.align_slots(_t(ref), _t(new), _t(vals), _t(new))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ infer

def test_infer_trained_matches_jax(trained, frames):
    jc, jp, tc, tp = trained
    B, T = frames.shape[:2]
    key = jax.random.key(5)
    want = jstove.infer(jp, jc, None, frames, None, key)
    got = tstove.infer(tp, tc, _t(frames), None,
                       jax_infer_noise(key, jc, B, T))
    for name in ("z", "z_mean", "pos_mean"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-4, err_msg=name)
    for name in ("kl", "init_logq", "init_logp"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-4, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(velocity_obs="encoder"),
    dict(velocity_obs="filtered"),
    dict(velocity_obs="encoder", velocity_obs_full_std=False),
    dict(velocity_posterior=False),
], ids=["encoder", "filtered", "t_frame_std", "no_velocity_posterior"])
def test_infer_velocity_modes_match_jax(kw):
    jc = JConfig().debug_shrunk().with_overrides(**kw)
    tc = TConfig.from_json(jc.to_json())
    # infer reads only the encoder and the dynamics weights
    enc = jenc.init_params(jax.random.key(1), jc)
    enc["head"]["w"] = enc["head"]["w"] * 30.0
    dyn = jdyn.init_params(jax.random.key(2), jc)
    dyn["out"][-1]["w"] = 0.2 * jax.random.normal(
        jax.random.key(3), dyn["out"][-1]["w"].shape)
    jp = {"supair": {"encoder": enc}, "dynamics": dyn}
    specs = None
    tp = ckpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")
    frames = np.random.default_rng(3).uniform(
        0, 1, (3, 6, jc.img_size, jc.img_size)).astype(np.float32)
    key = jax.random.key(9)
    want = jstove.infer(jp, jc, specs, frames, None, key)
    got = tstove.infer(tp, tc, _t(frames), None,
                       jax_infer_noise(key, jc, 3, 6))
    for name in ("z", "z_mean", "pos_mean"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got.kl, want.kl, rtol=1e-4, atol=1e-3)


# ------------------------------------------------------------ rollout

def _z0(cfg, B, seed):
    rng = np.random.default_rng(seed)
    z = np.zeros((B, cfg.num_obj, cfg.full_state_dim), np.float32)
    z[..., 0:2] = 0.24
    z[..., 2:4] = rng.uniform(-0.7, 0.7, (B, cfg.num_obj, 2))
    z[..., 4:6] = rng.normal(0, 0.05, (B, cfg.num_obj, 2))
    z[..., 6:] = rng.normal(0, 0.5, (B, cfg.num_obj, cfg.cl))
    return z


def test_reference_rollout_matches_pallas_interpret(trained):
    jc, jp, tc, tp = trained
    z0 = _z0(tc, 8, 1)
    want = jpr.rollout_pallas(jp["dynamics"], jc, jnp.asarray(z0), 6,
                              sample=False, block=8, dtype=jnp.float32,
                              interpret=True)
    got, _ = tfr.rollout_states_reference(tp["dynamics"], tc, _t(z0), 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("sample", [False, True], ids=["mean", "sampled"])
def test_reference_rollout_matches_stove_rollout(trained, sample):
    jc, jp, tc, tp = trained
    jc = jc.with_overrides(rollout_sigma_temp=0.7)
    tc = TConfig.from_json(jc.to_json())
    z0 = _z0(tc, 8, 2)
    H = 8
    key = jax.random.key(4)
    want, _ = jstove.rollout(jp, jc, jnp.asarray(z0), None, H, key, sample)
    noise = None
    if sample:   # the per-step normals of stove.rollout's gaussians.sample
        noise = _t(jnp.stack([jax.random.normal(k, z0.shape, jnp.float32)
                              for k in jax.random.split(key, H)], 1))
    got, rew = tfr.rollout_states_reference(tp["dynamics"], tc, _t(z0), H,
                                            noise)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert rew.shape == (8, H) and not rew.any()


def test_stove_rollout_cpu_paths(trained):
    """`rollout` on CPU tensors is the plain loop; sampled draws come from
    the caller's generator and are reproducible from its seed."""
    _, _, tc, tp = trained
    z0 = _t(_z0(tc, 4, 3))
    mean, _ = tstove.rollout(tp, tc, z0, None, 5)
    ref, _ = tfr.rollout_states_reference(tp["dynamics"], tc, z0, 5)
    torch.testing.assert_close(mean, ref, rtol=0, atol=0)
    a, _ = tstove.rollout(tp, tc, z0, None, 5,
                          torch.Generator().manual_seed(1), sample=True)
    b = tfr.rollout_states(tp["dynamics"], tc, z0, 5, True,
                           torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, mean)


@pytest.mark.parametrize("kw", [
    dict(action_conditioned=True, reward_head=True),
    dict(open_loop_sigma=True),
], ids=["action_reward", "open_sigma"])
def test_stove_rollout_heads_match_jax(kw):
    """`rollout` on CPU tensors passes the actions to the plain loop and
    returns its rewards: states and rewards against `stove.rollout`, mean
    path, random weights at debug widths with the reward or open-loop
    head live.  atol 1e-4, as for the other rollouts: latents grow to ~10
    over six steps."""
    jc = JConfig().debug_shrunk().with_overrides(**kw)
    tc = TConfig.from_json(jc.to_json())
    jdp = jdyn.init_params(jax.random.key(1), jc)
    w = jdp["out"][-1]["w"]   # the init zeroes it; make Δv, Δℓ, σ live
    jdp["out"][-1]["w"] = 0.3 * jax.random.normal(jax.random.key(2), w.shape)
    rng = np.random.default_rng(7)
    z0 = rng.normal(0, 0.5, (5, jc.num_obj, jc.full_state_dim)).astype(
        np.float32)
    acts = rng.integers(0, jc.num_actions, (5, 6)).astype(np.int32)
    want_s, want_r = jstove.rollout({"dynamics": jdp}, jc, jnp.asarray(z0),
                                    jnp.asarray(acts), 6, jax.random.key(3))
    tp = {"dynamics": ckpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jdp), "cpu")}
    got_s, got_r = tstove.rollout(tp, tc, _t(z0), _t(acts).long(), 6)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=1e-4)
    if jc.reward_head:
        assert got_r.std() > 0     # the head is live, not zeros
