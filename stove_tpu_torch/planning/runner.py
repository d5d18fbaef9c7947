"""Planning episodes: MCTS in the real avoidance environment, from pixels
(counterpart of `stove_tpu/planning/runner.py`).

Per environment step: infer the model state from the last `window`
rendered frames, run MCTS from it, act on the visit counts, step the true
environment.  Baselines: MCTS on the true environment (oracle) and a
random policy.  Every policy sees the same episode seeds (common random
numbers): episode e's generator is seeded from (seed + 7, e), and its
first draws make the initial state, so all three policies start from the
same states.  `run_planning` runs the episodes one by one or, with
`mcts_lockstep`, all episodes of a policy together (one batched posterior
and one simulator call per round for all of them), episode by episode the
same as the serial path.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from stove_tpu_torch.config import Config
from stove_tpu_torch.device import resolve_device
from stove_tpu_torch.envs import physics
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.planning.mcts import (MCTS, MCTSLockstep, to_host,
                                           tree_map)
from stove_tpu_torch.planning.simulators import LearnedSimulator, TrueSimulator


def episode_generator(cfg: Config, e: int) -> torch.Generator:
    """Episode e's CPU generator, seeded from (cfg.seed + 7, e)."""
    return torch.Generator().manual_seed(int(
        np.random.SeedSequence([cfg.seed + 7, e]).generate_state(1)[0]))


def episode_generators(cfg: Config, n: int) -> List[torch.Generator]:
    return [episode_generator(cfg, e) for e in range(n)]


class EnvHandles:
    """The avoidance environment of one episode on `device`: batched
    states with N = 1."""

    def __init__(self, cfg: Config, device=torch.device("cpu")):
        self.cfg = cfg
        self.device = torch.device(device)

    def init(self, generator: torch.Generator) -> physics.EnvState:
        return physics.init_state(self.cfg, 1, generator, self.device)

    def step(self, state: physics.EnvState, action: int):
        return physics.avoidance_step(
            self.cfg, state, torch.tensor([action], device=self.device))

    def render(self, state: physics.EnvState) -> torch.Tensor:
        return physics.render(self.cfg, state.pos, state.radii)


class BatchedEnvHandles(EnvHandles):
    """E episodes' environments as one batch: episode e's initial state
    is drawn from generators[e] as `EnvHandles.init` draws it."""

    def init(self, generators) -> physics.EnvState:
        parts = [super(BatchedEnvHandles, self).init(g) for g in generators]
        return physics.EnvState(*(torch.cat(x, 0) for x in zip(*parts)))

    def step(self, state: physics.EnvState, actions: np.ndarray):
        return physics.avoidance_step(
            self.cfg, state, torch.as_tensor(actions, device=self.device))


def _window(frames: List[torch.Tensor], W: int) -> torch.Tensor:
    """The last W frames (each (N, img, img)) as (N, W, img, img)."""
    return torch.stack(frames[-W:], 1)


def run_episode_model(cfg: Config, model: StoveModel,
                      generator: torch.Generator,
                      episode_len: Optional[int] = None,
                      planner: Optional[MCTS] = None,
                      env: Optional[EnvHandles] = None) -> float:
    """One avoidance episode planned with the learned model from pixels."""
    episode_len = episode_len or cfg.mcts_episode_len
    planner = planner or MCTS(LearnedSimulator(model), cfg)
    env = env or EnvHandles(cfg, model.device)
    state = env.init(generator)
    W = cfg.window
    frames = [env.render(state)] * W
    # actions[t] is applied at frame t (the transition t -> t+1), as in
    # the corpora; the newest frame's slot holds a placeholder until the
    # planner picks its action (infer never reads the last action)
    actions = np.zeros((W,), np.int64)
    total = 0.0
    with torch.no_grad():
        for _ in range(episode_len):
            inf = model.infer(_window(frames, W), torch.as_tensor(
                actions[-W:][None], device=model.device),
                generator=generator)
            action, _ = planner.run(inf.z_mean[0, -1], generator)
            actions[-1] = action
            state, reward = env.step(state, action)
            total += float(reward[0])
            frames.append(env.render(state))
            actions = np.append(actions, 0)
    return total


def run_episode_oracle(cfg: Config, generator: torch.Generator,
                       episode_len: Optional[int] = None,
                       planner: Optional[MCTS] = None,
                       env: Optional[EnvHandles] = None) -> float:
    """MCTS with the true simulator (the upper baseline)."""
    episode_len = episode_len or cfg.mcts_episode_len
    env = env or EnvHandles(cfg)
    planner = planner or MCTS(TrueSimulator(cfg, env.device), cfg)
    state = env.init(generator)
    total = 0.0
    for _ in range(episode_len):
        root = tree_map(lambda x: x[0], to_host(state))
        action, _ = planner.run(root, generator)
        state, reward = env.step(state, action)
        total += float(reward[0])
    return total


def run_episode_random(cfg: Config, generator: torch.Generator,
                       episode_len: Optional[int] = None,
                       env: Optional[EnvHandles] = None) -> float:
    episode_len = episode_len or cfg.mcts_episode_len
    env = env or EnvHandles(cfg)
    state = env.init(generator)
    total = 0.0
    for _ in range(episode_len):
        a = int(torch.randint(0, cfg.num_actions, (1,), generator=generator))
        state, reward = env.step(state, a)
        total += float(reward[0])
    return total


# --------------------------------------------------------------------------
# lockstep: all episodes of a policy advance together
# --------------------------------------------------------------------------

def _lockstep_model(cfg: Config, model: StoveModel,
                    generators: List[torch.Generator], episode_len: int,
                    planner: MCTSLockstep,
                    env: BatchedEnvHandles) -> np.ndarray:
    """E avoidance episodes planned with the learned model, in lockstep;
    episode by episode equal to `run_episode_model` with the same
    generators."""
    E, W = len(generators), cfg.window
    state = env.init(generators)
    frames = [env.render(state)] * W                       # (E, img, img)
    actions = np.zeros((E, W), np.int64)
    totals = np.zeros((E,), np.float64)
    with torch.no_grad():
        for _ in range(episode_len):
            inf = model.infer_each(
                _window(frames, W)[:, None],
                torch.as_tensor(actions[:, -W:][:, None], device=model.device),
                generators)
            z = inf.z_mean[:, 0, -1].cpu().numpy()         # (E, O, D)
            acts, _ = planner.run([z[e] for e in range(E)], generators)
            acts = np.asarray(acts, np.int64)
            actions[:, -1] = acts
            state, rewards = env.step(state, acts)
            totals += rewards.cpu().numpy().astype(np.float64)
            frames.append(env.render(state))
            actions = np.concatenate([actions, np.zeros((E, 1), np.int64)], 1)
    return totals


def _lockstep_oracle(cfg: Config, generators: List[torch.Generator],
                     episode_len: int, planner: MCTSLockstep,
                     env: BatchedEnvHandles) -> np.ndarray:
    E = len(generators)
    state = env.init(generators)
    totals = np.zeros((E,), np.float64)
    for _ in range(episode_len):
        host = to_host(state)
        roots = [tree_map(lambda x: x[e], host) for e in range(E)]
        acts, _ = planner.run(roots, generators)
        state, rewards = env.step(state, np.asarray(acts, np.int64))
        totals += rewards.cpu().numpy().astype(np.float64)
    return totals


def _lockstep_random(cfg: Config, generators: List[torch.Generator],
                     episode_len: int, env: BatchedEnvHandles) -> np.ndarray:
    E = len(generators)
    state = env.init(generators)
    totals = np.zeros((E,), np.float64)
    for _ in range(episode_len):
        acts = np.asarray([int(torch.randint(0, cfg.num_actions, (1,),
                                             generator=g))
                           for g in generators], np.int64)
        state, rewards = env.step(state, acts)
        totals += rewards.cpu().numpy().astype(np.float64)
    return totals


def run_planning(cfg: Config, model: Optional[StoveModel] = None,
                 device=None) -> Dict[str, float]:
    """Evaluate planning (runner.py:237): learned-model MCTS against oracle
    MCTS and a random policy, over cfg.mcts_episodes episodes.  The model
    is restored from cfg.restore (untrained weights without one)."""
    if model is None:
        dev = resolve_device(device)
        model = (StoveModel.from_run(cfg.restore, cfg=cfg, device=dev)
                 if cfg.restore is not None else StoveModel(cfg, device=dev))
    if cfg.mcts_lockstep:
        return _run_planning_lockstep(cfg, model)
    env = EnvHandles(cfg, model.device)
    model_planner = MCTS(LearnedSimulator(model), cfg)
    oracle_planner = MCTS(TrueSimulator(cfg, model.device), cfg)
    policies = (
        ("model", lambda g: run_episode_model(cfg, model, g,
                                              planner=model_planner, env=env)),
        ("oracle", lambda g: run_episode_oracle(cfg, g,
                                                planner=oracle_planner,
                                                env=env)),
        ("random", lambda g: run_episode_random(cfg, g, env=env)),
    )
    scores: Dict[str, list] = {name: [] for name, _ in policies}
    for ep in range(cfg.mcts_episodes):
        for name, fn in policies:
            # a fresh generator with the episode's seed for every policy
            scores[name].append(fn(episode_generator(cfg, ep)))
        print(f"[plan] episode {ep}: " + "  ".join(
            f"{n}={scores[n][-1]:.0f}" for n, _ in policies), flush=True)
    return _summarize(cfg, scores)


def _run_planning_lockstep(cfg: Config, model: StoveModel
                           ) -> Dict[str, float]:
    """run_planning with each policy's episodes in lockstep (runner.py:277):
    the same episode seeds as the serial path."""
    E = cfg.mcts_episodes
    env = BatchedEnvHandles(cfg, model.device)
    model_planner = MCTSLockstep(LearnedSimulator(model), cfg)
    oracle_planner = MCTSLockstep(TrueSimulator(cfg, model.device), cfg)
    n = cfg.mcts_episode_len
    scores: Dict[str, list] = {}
    for name, fn in (
            ("model", lambda g: _lockstep_model(cfg, model, g, n,
                                                model_planner, env)),
            ("oracle", lambda g: _lockstep_oracle(cfg, g, n, oracle_planner,
                                                  env)),
            ("random", lambda g: _lockstep_random(cfg, g, n, env))):
        t0 = time.perf_counter()
        scores[name] = list(fn(episode_generators(cfg, E)))
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        print(f"[plan] {name}: {len(scores[name])} episodes in "
              f"{time.perf_counter() - t0:.1f}s (lockstep)", flush=True)
    for ep in range(E):
        print(f"[plan] episode {ep}: " + "  ".join(
            f"{k}={scores[k][ep]:.0f}" for k in scores), flush=True)
    return _summarize(cfg, scores)


def _summarize(cfg: Config, scores: Dict[str, list]) -> Dict[str, float]:
    """Mean and std per policy, and the paired model − oracle gap with its
    SEM (runner.py:310): with common random numbers the per-episode
    difference cancels the spread between initial states."""
    out: Dict[str, float] = {}
    n_ep = len(next(iter(scores.values())))
    for name in scores:
        out[f"{name}_mean_reward"] = float(np.mean(scores[name]))
        out[f"{name}_std"] = float(np.std(scores[name]))
        print(f"[plan] {name}: mean={out[f'{name}_mean_reward']:.2f} "
              f"± {out[f'{name}_std']:.2f} over {n_ep} episodes", flush=True)
    gap = np.asarray(scores["model"]) - np.asarray(scores["oracle"])
    out["model_oracle_gap_mean"] = float(np.mean(gap))
    out["model_oracle_gap_sem"] = float(np.std(gap) /
                                        np.sqrt(max(len(gap), 1)))
    out["episode_scores"] = {k: [float(x) for x in v]
                             for k, v in scores.items()}
    print(f"[plan] paired model−oracle gap: {out['model_oracle_gap_mean']:.2f}"
          f" ± {out['model_oracle_gap_sem']:.2f} (SEM, n={len(gap)})",
          flush=True)
    return out
