"""The port's planner against the JAX package's at the checkpoint's
planner settings, as statistics over episodes (the two draw their
episodes from different generators).  Its own file: it runs both planners
for 16 episodes of 40 steps on the CPU."""

import numpy as np

from stove_tpu.config import Config as JConfig
from stove_tpu.planning import runner as jrunner
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.planning import runner

RUN = "ckpts/r4a_dense_s2"


def test_planning_statistics_match_the_jax_package(capsys):
    """The checkpoint's planner (100 simulations, horizon 10, frontier 4,
    lockstep) over 16 episodes of 40 steps, in the JAX package and in the
    port, both in float32 on the CPU.  The two draw their episodes from
    different generators, so they are compared as statistics: each
    policy's mean within 3 combined standard errors, and both order
    oracle > model > random."""
    cfg = StoveModel.from_run(RUN, device="cpu").cfg.with_overrides(
        restore=RUN, mcts_episodes=16, mcts_episode_len=40)
    got = runner.run_planning(cfg, device="cpu")
    want = jrunner.run_planning(JConfig.from_json(cfg.to_json()))
    with capsys.disabled():
        for name, r in (("jax", want), ("port", got)):
            print(f"\n[planning] {name}: " + " ".join(
                f"{k} {r[k]:.4f}" for k in (
                    "model_mean_reward", "oracle_mean_reward",
                    "random_mean_reward", "model_oracle_gap_mean",
                    "model_oracle_gap_sem")), end="")
        print()
    n = cfg.mcts_episodes
    for pol in ("model", "oracle", "random"):
        sem = np.hypot(got[f"{pol}_std"], want[f"{pol}_std"]) / np.sqrt(n)
        assert abs(got[f"{pol}_mean_reward"] - want[f"{pol}_mean_reward"]) \
            <= 3 * sem, pol
    for r in (got, want):
        assert r["oracle_mean_reward"] > r["model_mean_reward"] \
            > r["random_mean_reward"]
