"""Planning on the CPU: the learned simulator's leaf values against the
JAX package's on the same states and action sequences, the search against
the JAX search on one deterministic stub simulator, lockstep against
serial episodes, and the oracle against random."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.config import Config as JConfig
from stove_tpu.models.bundle import StoveModel as JModel
from stove_tpu.planning import mcts as jmcts
from stove_tpu.planning.simulators import LearnedSimulator as JSim
from stove_tpu_torch import main as tmain
from stove_tpu_torch.config import Config
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.ops import fused_rollout as fr
from stove_tpu_torch.planning import mcts as tmcts
from stove_tpu_torch.planning import runner
from stove_tpu_torch.planning.simulators import LearnedSimulator, TrueSimulator
from torch_parity import to_jax

RUN = "ckpts/r4a_dense_s2"


def _cfg(**kw):
    base = dict(task="avoidance", action_conditioned=True, num_obj=3,
                mcts_simulations=27, mcts_horizon=4, mcts_episode_len=12)
    base.update(kw)
    return Config().debug_shrunk().with_overrides(**base)


@pytest.fixture(scope="module")
def trained():
    return StoveModel.from_run(RUN, device="cpu")


def _z(cfg, B, seed):
    g = torch.Generator().manual_seed(seed)
    z = torch.zeros(B, cfg.num_obj, cfg.full_state_dim)
    z[..., 0:2] = 0.24 + 0.05 * torch.rand(B, cfg.num_obj, 2, generator=g)
    z[..., 2:4] = torch.rand(B, cfg.num_obj, 2, generator=g) * 1.4 - 0.7
    z[..., 4:6] = torch.randn(B, cfg.num_obj, 2, generator=g) * 0.05
    z[..., 6:] = torch.randn(B, cfg.num_obj, cfg.cl, generator=g) * 0.5
    return z


@pytest.mark.parametrize("overrides", [
    {},
    {"mcts_depth_shrink": 0.7, "mcts_shrink_mode": "tree",
     "mcts_reward_base_rate": 0.6},
    {"mcts_reward_temp": 2.0, "mcts_depth_shrink": 0.8},
], ids=["leaf", "tree", "temperature"])
def test_leaf_values_match_jax(trained, overrides):
    """One search round of the trained model (step, calibrated reward,
    H-step return of random actions) against the JAX package's, with the
    JAX draws of the round's actions handed to the port: rtol 1e-4."""
    cfg = trained.cfg.with_overrides(**overrides)
    model = StoveModel(cfg, trained.params, "cpu", trained.seeds)
    jcfg = JConfig.from_json(cfg.to_json())
    jsim = JSim(JModel(jcfg), to_jax(trained.params))
    B, H = 8, cfg.mcts_horizon
    z = _z(cfg, B, 0)
    acts = np.arange(B) % cfg.num_actions
    depths = np.array([1, 2, 3, 1, 5, 2, 4, 1])
    key = jax.random.key(3)
    zj, aj = jnp.asarray(z.numpy()), jnp.asarray(acts, jnp.int32)
    if cfg.mcts_shrink_mode == "tree":
        _, jn, jr, jret = jsim.round_one(zj, aj, key, H,
                                         jnp.asarray(depths, jnp.int32))
    else:
        _, jn, jr, jret = jsim.round_one(zj, aj, key, H)
    k_act = jax.random.split(jax.random.split(key, 3)[2])[0]
    eval_acts = torch.from_numpy(np.array(jax.random.randint(
        k_act, (B, H), 0, cfg.num_actions))).long()
    sim = LearnedSimulator(model)
    nxt, rew, ret = sim.step_and_value(z, torch.from_numpy(acts), eval_acts,
                                       torch.from_numpy(depths))
    np.testing.assert_allclose(nxt.numpy(), np.asarray(jn), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jr), rtol=1e-4)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-4)
    assert np.ptp(np.asarray(jret)) > 0.1      # the values discriminate


def test_shrink_pi_ignores_nonpositive_rates():
    cfg = _cfg(reward_pos_rate=-1.0, mcts_reward_base_rate=0.0,
               mcts_depth_shrink=0.6)
    assert LearnedSimulator(StoveModel(cfg, device="cpu"))._shrink_pi == 0.5
    cfg2 = _cfg(reward_pos_rate=0.83, mcts_reward_base_rate=0.0,
                mcts_depth_shrink=0.6)
    assert LearnedSimulator(StoveModel(cfg2, device="cpu"))._shrink_pi == 0.83


def test_round_launches_the_rollout_twice_on_the_card_path(trained,
                                                           monkeypatch):
    """A round is one step rollout (H = 1) and one leaf rollout (H =
    mcts_horizon), both through the one dispatch fused_rollout.rollout."""
    calls = []
    real = fr.rollout

    def spy(dyn, cfg, z0, horizon, *a, **k):
        calls.append((z0.shape[0], horizon))
        return real(dyn, cfg, z0, horizon, *a, **k)

    monkeypatch.setattr(fr, "rollout", spy)
    cfg = trained.cfg
    sim = LearnedSimulator(trained)
    z = _z(cfg, 36, 1).numpy()
    nxt, rew, ret = sim.round_one(z, np.arange(36) % 9,
                                  torch.Generator().manual_seed(0), 10)
    assert calls == [(36, 1), (36, 10)]
    assert nxt.shape == z.shape and rew.shape == ret.shape == (36,)


# ---------------------------------------------------------------- search

class Stub:
    """A deterministic simulator: state x (B, 2) moves by 0.3 · the
    action's direction; reward and return are smooth functions of the new
    state.  `step` is shared by the JAX and the port adapters below."""

    num_actions = 9

    @staticmethod
    def step(states, actions):
        ang = actions * (np.pi / 4)
        d = np.stack([np.cos(ang), np.sin(ang)], -1) * (actions > 0)[:, None]
        nxt = states + 0.3 * d
        rew = np.cos(1.7 * nxt[:, 0]) * np.sin(1.1 * nxt[:, 1])
        ret = np.sin(0.9 * nxt[:, 0] + 0.4 * nxt[:, 1] ** 2)
        return nxt, rew, ret


class JaxStub(Stub, jmcts.Simulator):
    def round_one(self, states, actions, key, horizon, depths=None):
        return (key,) + self.step(np.asarray(states), np.asarray(actions))

    def round_many(self, states, actions, keys_data, horizon, depths=None):
        E, B = actions.shape
        n, r, v = self.step(np.asarray(states).reshape(E * B, 2),
                            np.asarray(actions).reshape(-1))
        return keys_data, n.reshape(E, B, 2), r.reshape(E, B), \
            v.reshape(E, B)


class PortStub(Stub, tmcts.Simulator):
    def round_one(self, states, actions, generator, horizon, depths=None):
        return self.step(states, actions)

    def round_many(self, states, actions, generators, horizon, depths=None):
        E, B = actions.shape
        n, r, v = self.step(states.reshape(E * B, 2), actions.reshape(-1))
        return n.reshape(E, B, 2), r.reshape(E, B), v.reshape(E, B)


@pytest.mark.parametrize("frontier,sims", [(1, 27), (4, 100), (3, 50)])
def test_search_matches_jax_on_a_stub(frontier, sims):
    cfg = _cfg(mcts_frontier=frontier, mcts_simulations=sims)
    jcfg = JConfig.from_json(cfg.to_json())
    roots = [np.array([0.1 * e, -0.2 + 0.05 * e], np.float32)
             for e in range(4)]
    for root in roots:
        ja, jc = jmcts.MCTS(JaxStub(), jcfg).run(root, jax.random.key(0))
        ta, tc = tmcts.MCTS(PortStub(), cfg).run(
            root, torch.Generator().manual_seed(0))
        assert ta == ja
        np.testing.assert_array_equal(tc, jc)
    keys = jax.vmap(lambda e: jax.random.fold_in(jax.random.key(1), e))(
        jnp.arange(4))
    ja, jc = jmcts.MCTSLockstep(JaxStub(), jcfg).run(roots, keys)
    ta, tc = tmcts.MCTSLockstep(PortStub(), cfg).run(
        roots, [torch.Generator().manual_seed(e) for e in range(4)])
    assert ta == ja
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a, b)
    assert sum(int(c.sum()) for c in tc) >= 4 * sims


# ---------------------------------------------------------------- episodes

def test_lockstep_matches_serial_all_policies():
    cfg = _cfg(mcts_simulations=18, mcts_horizon=3, mcts_episode_len=4,
               mcts_episodes=3, mcts_frontier=2)
    model = StoveModel(cfg, device="cpu")
    E, n = cfg.mcts_episodes, cfg.mcts_episode_len
    env_s, env_b = runner.EnvHandles(cfg), runner.BatchedEnvHandles(cfg)

    serial = [runner.run_episode_model(
        cfg, model, runner.episode_generator(cfg, e),
        planner=tmcts.MCTS(LearnedSimulator(model), cfg), env=env_s)
        for e in range(E)]
    lock = runner._lockstep_model(
        cfg, model, runner.episode_generators(cfg, E), n,
        tmcts.MCTSLockstep(LearnedSimulator(model), cfg), env_b)
    np.testing.assert_array_equal(np.asarray(serial), lock)

    serial_o = [runner.run_episode_oracle(
        cfg, runner.episode_generator(cfg, e),
        planner=tmcts.MCTS(TrueSimulator(cfg), cfg), env=env_s)
        for e in range(E)]
    lock_o = runner._lockstep_oracle(
        cfg, runner.episode_generators(cfg, E), n,
        tmcts.MCTSLockstep(TrueSimulator(cfg), cfg), env_b)
    np.testing.assert_array_equal(np.asarray(serial_o), lock_o)

    serial_r = [runner.run_episode_random(cfg, runner.episode_generator(
        cfg, e), env=env_s) for e in range(E)]
    lock_r = runner._lockstep_random(cfg, runner.episode_generators(cfg, E),
                                     n, env_b)
    np.testing.assert_array_equal(np.asarray(serial_r), lock_r)


def test_lockstep_matches_serial_tree_mode():
    cfg = _cfg(mcts_simulations=18, mcts_horizon=3, mcts_episode_len=3,
               mcts_episodes=2, mcts_frontier=2, mcts_depth_shrink=0.7,
               mcts_shrink_mode="tree", mcts_reward_base_rate=0.6)
    model = StoveModel(cfg, device="cpu")
    serial = [runner.run_episode_model(
        cfg, model, runner.episode_generator(cfg, e),
        planner=tmcts.MCTS(LearnedSimulator(model), cfg),
        env=runner.EnvHandles(cfg)) for e in range(2)]
    lock = runner._lockstep_model(
        cfg, model, runner.episode_generators(cfg, 2), 3,
        tmcts.MCTSLockstep(LearnedSimulator(model), cfg),
        runner.BatchedEnvHandles(cfg))
    np.testing.assert_array_equal(np.asarray(serial), lock)


def test_oracle_beats_random():
    """The margin of tests/test_planning.py::test_oracle_beats_random, in
    its config: MCTS on the true environment beats the random policy by at
    least 2.0 reward over 3 episodes."""
    cfg = _cfg(mcts_simulations=36, mcts_horizon=6, mcts_episode_len=20,
               ball_radius=2.2, init_speed=1.4, action_speed=0.6)
    oracle, rand = [], []
    for e in range(3):
        oracle.append(runner.run_episode_oracle(
            cfg, torch.Generator().manual_seed(2 * e)))
        rand.append(runner.run_episode_random(
            cfg, torch.Generator().manual_seed(2 * e + 1)))
    assert np.mean(oracle) >= np.mean(rand) + 2.0, (oracle, rand)


def test_main_mcts_on_cpu_prints_the_planning_keys(capsys):
    assert tmain.main([f"restore={RUN}", "mode=mcts", "device=cpu",
                       "mcts_episodes=2", "mcts_episode_len=2",
                       "mcts_simulations=9", "mcts_horizon=2"]) == 0
    out = capsys.readouterr().out
    for key in ("model_mean_reward", "oracle_mean_reward",
                "random_mean_reward", "model_oracle_gap_mean",
                "model_oracle_gap_sem"):
        assert key in out

