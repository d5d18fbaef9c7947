"""The avoidance environment on the CPU: physics against the JAX package
over 30 steps with the same actions (1e-4 arena units, rewards exactly),
the action table, and the corpora with and without actions.  The gravity
environment's tests are in tests/test_torch_gravity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.envs import physics as jphys
from stove_tpu_torch.config import Config
from stove_tpu_torch.envs import data as tdata
from stove_tpu_torch.envs import physics as tphys
from stove_tpu_torch.train import checkpoint as ckpt


@pytest.fixture(scope="module")
def cfg():
    return ckpt.load_config("ckpts/r4a_dense_s2")


def _jstate(cfg, n, seed):
    jcfg = JConfig.from_json(cfg.to_json())
    keys = jax.random.split(jax.random.key(seed), n)
    return jcfg, jax.vmap(lambda k: jphys.init_state(jcfg, k))(keys)


def _tstate(js):
    return tphys.EnvState(*(torch.from_numpy(np.array(x)) for x in js))


def test_action_directions_match_jax():
    np.testing.assert_array_equal(tphys.action_directions().numpy(),
                                  np.asarray(jphys.action_directions()))


def test_avoidance_physics_matches_jax_over_30_steps(cfg):
    """30 steps of 8 sequences from the JAX package's initial states with
    the same actions.  The free-running trajectories are held to the JAX
    functions evaluated op by op (jax.disable_jit): under jit XLA reorders
    the float32 collision arithmetic, and the chaotic collisions grow that
    1-ulp change to 6.5e-4 of the reference's own op-by-op trajectory by
    step 30 in this run.  Each step is also held to the jitted reference
    started from the port's state."""
    jcfg, js = _jstate(cfg, 8, 3)
    ts = _tstate(js)
    acts = np.random.default_rng(0).integers(0, cfg.num_actions, (8, 30))
    eager = jax.vmap(lambda s, a: jphys.env_step(jcfg, s, a))
    jitted = jax.jit(eager)
    touched = 0.0
    for t in range(30):
        a = jnp.asarray(acts[:, t], jnp.int32)
        one, one_r = jitted(jphys.EnvState(*(jnp.asarray(x.numpy())
                                             for x in ts)), a)
        with jax.disable_jit():
            js, jr = eager(js, a)
        ts, tr = tphys.env_step(cfg, ts, torch.from_numpy(acts[:, t]))
        for got, want in ((ts, js), (ts, one)):
            np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                                       rtol=0, atol=1e-4)
            np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel),
                                       rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(one_r))
        touched += float((tr == cfg.reward_contact).sum())
    assert touched > 0            # the run saw contacts, not only free steps


def test_avoidance_corpus_has_actions_and_rewards(cfg):
    cfg = cfg.with_overrides(seq_len=20)
    ep = tdata.generate(cfg, 6, torch.Generator().manual_seed(1))
    assert ep.actions.dtype == torch.long
    assert 0 <= int(ep.actions.min()) and int(ep.actions.max()) < 9
    assert len(torch.unique(ep.actions)) > 3
    assert set(torch.unique(ep.rewards).tolist()) <= {0.0, 1.0}
    # the recorded rewards are the environment's for the recorded actions
    g = torch.Generator().manual_seed(1)
    s = tphys.init_state(cfg, 6, g)
    acts = torch.randint(0, 9, (6, 20), generator=g)
    torch.testing.assert_close(acts, ep.actions, rtol=0, atol=0)
    for t in range(20):
        s, r = tphys.env_step(cfg, s, acts[:, t])
        torch.testing.assert_close(r, ep.rewards[:, t], rtol=0, atol=0)


def test_billiards_corpus_draws_no_actions():
    """Drawing actions only for avoidance keeps billiards corpora as they
    were: the initial states are the generator's only draws."""
    cfg = Config().with_overrides(seq_len=10)
    g_gen = torch.Generator().manual_seed(2)
    ep = tdata.generate(cfg, 4, g_gen)
    g = torch.Generator().manual_seed(2)
    s = tphys.init_state(cfg, 4, g)
    assert not ep.actions.any() and not ep.rewards.any()
    for t in range(10):
        torch.testing.assert_close(ep.states[:, t],
                                   torch.cat([s.pos, s.vel], -1),
                                   rtol=0, atol=0)
        s = tphys.billiards_step(cfg, s)
    assert torch.equal(torch.rand(3, generator=g_gen),
                       torch.rand(3, generator=g))
