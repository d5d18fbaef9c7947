"""Simulators for MCTS: the learned STOVE model and the true environment
(counterpart of `stove_tpu/planning/simulators.py`).

`LearnedSimulator` steps latent states z (B, O, 6+cl) with the model's
rollout and values each child by a rollout of uniformly random actions,
summing discounted, calibrated reward probabilities.  Every rollout goes
through `fused_rollout.rollout`, the port's one dispatch: on the card each
round launches the rollout kernel twice (the step, H = 1, and the leaf
evaluation, H = mcts_horizon); on the CPU it runs the plain loop.  As in
the JAX planner (simulators.py:147-158), `mcts_rollout_impl` sets the
leaf's precision: "pallas" values leaves with the TPU kernel's bfloat16
variant (its `prepare_params(..., jnp.bfloat16)`, whatever compute_dtype
is), "xla" at compute_dtype's precision (`stove.rollout`: float32, or
"dense_bf16" under compute_dtype=bfloat16); the step runs at
compute_dtype's either way.  `TrueSimulator` does the same on the batched
avoidance physics (the oracle).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from stove_tpu_torch.config import Config
from stove_tpu_torch.envs import physics
from stove_tpu_torch.models.bundle import StoveModel
from stove_tpu_torch.planning.mcts import Simulator, tree_map


def _draw_actions(cfg: Config, generators: Sequence[torch.Generator],
                  rows: int, horizon: int, device) -> torch.Tensor:
    """`rows` × `horizon` uniform actions from each generator in turn,
    stacked: (len(generators) · rows, horizon) on `device`."""
    return torch.cat([torch.randint(0, cfg.num_actions, (rows, horizon),
                                    generator=g) for g in generators]
                     ).to(device)


class LearnedSimulator(Simulator):
    """Latent-space simulator on a `StoveModel` (simulators.py:20)."""

    def __init__(self, model: StoveModel):
        self.model = model
        cfg = self.cfg = model.cfg
        self.num_actions = cfg.num_actions
        # shrink target: the first POSITIVE rate (reward_pos_rate=-1 is a
        # documented control and must not become the target)
        self._shrink_pi = next(
            (r for r in (cfg.mcts_reward_base_rate, cfg.reward_pos_rate)
             if r > 0), 0.5)
        self._tree_mode = (cfg.mcts_shrink_mode == "tree"
                           and cfg.mcts_depth_shrink < 1.0)
        if cfg.mcts_rollout_impl not in ("xla", "pallas"):
            raise ValueError(f"mcts_rollout_impl {cfg.mcts_rollout_impl!r}: "
                             f"'xla' or 'pallas'")
        if cfg.mcts_rollout_impl == "pallas" and self._tree_mode:
            raise ValueError(
                "mcts_shrink_mode='tree' needs per-leaf depth inputs, which "
                "the fused rollout kernel does not take; use "
                "mcts_rollout_impl='xla' with tree mode.")
        # the leaves' precision (simulators.py:100, :154-159)
        self.leaf_dtype = ("bfloat16" if cfg.mcts_rollout_impl == "pallas"
                           else model.precision)

    def _calibrate(self, q: torch.Tensor) -> torch.Tensor:
        """Undo the class-balanced BCE's distortion (simulators.py:34):
        with base rate π the balanced head learns q = pβ/(pβ + (1−p)(1−β)),
        β = 1 − π, so p = qπ/(qπ + (1−q)(1−π)); then the temperature."""
        cfg = self.cfg
        pi = cfg.mcts_reward_base_rate or cfg.reward_pos_rate
        if pi > 0 and cfg.reward_balanced_loss:
            q = q * pi / (q * pi + (1.0 - q) * (1.0 - pi))
        if cfg.mcts_reward_temp != 1.0:
            eps = 1e-6
            logit = torch.log(q + eps) - torch.log1p(-q + eps)
            q = torch.sigmoid(logit / cfg.mcts_reward_temp)
        return q

    def _depth_shrink(self, p: torch.Tensor,
                      depths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Shrink step-t predictions (B, H) toward π by λ^(t+1), or in tree
        mode by λ^(depth+t+1) with depth the rollout's start depth
        (simulators.py:63)."""
        lam = self.cfg.mcts_depth_shrink
        if lam >= 1.0:
            return p
        pi = self._shrink_pi
        w = lam ** torch.arange(1, p.shape[-1] + 1, dtype=p.dtype,
                                device=p.device)
        if depths is not None:
            w = w * lam ** depths[:, None].to(p.dtype)
        return pi + (p - pi) * w

    def _edge_shrink(self, r: torch.Tensor,
                     depths: Optional[torch.Tensor]) -> torch.Tensor:
        """Tree mode: the edge reward into depth d, shrunk by λ^d
        (simulators.py:85)."""
        if not self._tree_mode or depths is None:
            return r
        pi = self._shrink_pi
        return pi + (r - pi) * self.cfg.mcts_depth_shrink ** depths.to(r.dtype)

    def leaf_values(self, z: torch.Tensor, actions: torch.Tensor,
                    depths: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """The return of each of the B states z under given action
        sequences (B·S, H), S = mcts_eval_samples rollouts per state (each
        state repeated S times; sampled rollouts when S > 1, their noise
        from `generator`): Σ_t γ^t · shrink(calibrate(r̂_t)), averaged over
        the S rollouts.  `depths` (B,) only in tree mode.  One rollout
        launch on the card, at `leaf_dtype`."""
        cfg = self.cfg
        S = max(1, cfg.mcts_eval_samples)
        B, H = z.shape[0], actions.shape[1]
        zr = torch.repeat_interleave(z, S, 0) if S > 1 else z
        _, rew = self.model.rollout(zr.contiguous(), actions, H, generator,
                                    sample=S > 1, dtype=self.leaf_dtype)
        if self._tree_mode:
            d = torch.repeat_interleave(depths, S, 0) if S > 1 else depths
            p = self._depth_shrink(self._calibrate(rew), d)
        else:
            p = self._depth_shrink(self._calibrate(rew))
        disc = cfg.mcts_discount ** torch.arange(H, dtype=rew.dtype,
                                                 device=rew.device)
        ret = torch.sum(p * disc[None, :], dim=1)
        return ret.reshape(B, S).mean(1) if S > 1 else ret

    def step_and_value(self, z: torch.Tensor, actions: torch.Tensor,
                       eval_actions: torch.Tensor,
                       depths: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
        """One search round on given action sequences: step the B states z
        with `actions` (B,) (a mean rollout of one step), calibrate (and in
        tree mode shrink) the step's reward, and value the children with
        `leaf_values` on `eval_actions` (B·S, H).  Returns tensors
        (next (B, O, D), rewards (B,), returns (B,))."""
        nxt, rew = self.model.rollout(z.contiguous(), actions[:, None], 1,
                                      sample=False)
        nxt, rew = nxt[:, 0], self._calibrate(rew[:, 0])
        if self._tree_mode:
            rew = self._edge_shrink(rew, depths)
        return nxt, rew, self.leaf_values(
            nxt, eval_actions, depths if self._tree_mode else None,
            generator)

    def _round(self, states: np.ndarray, actions: np.ndarray,
               generators: List[torch.Generator], horizon: int,
               depths: Optional[np.ndarray]):
        """`step_and_value` over (G·B) rows, B per generator, with each
        row block's evaluation actions drawn from its generator; one
        transfer back to the host."""
        cfg, dev = self.cfg, self.model.device
        z = torch.as_tensor(states, dtype=torch.float32, device=dev)
        n = z.shape[0]
        S = max(1, cfg.mcts_eval_samples)
        eval_acts = _draw_actions(cfg, generators, n // len(generators) * S,
                                  horizon, dev)
        # sampled leaves (S > 1): the kernel's noise seed or the CPU normals
        # come from the first generator of the round, so with S > 1 a
        # lockstep round equals the serial ones in distribution only
        nxt, rew, ret = self.step_and_value(
            z, torch.as_tensor(actions, device=dev), eval_acts,
            None if depths is None else torch.as_tensor(depths, device=dev),
            generators[0])
        host = torch.cat([nxt.reshape(n, -1), rew[:, None], ret[:, None]],
                         1).cpu().numpy()
        return (host[:, :-2].reshape(states.shape), host[:, -2],
                host[:, -1])

    def round_one(self, states, actions, generator, horizon, depths=None):
        return self._round(states, actions, [generator], horizon, depths)

    def round_many(self, states, actions, generators, horizon, depths=None):
        E, B = actions.shape
        nxt, rew, ret = self._round(
            states.reshape(E * B, *states.shape[2:]), actions.reshape(-1),
            list(generators), horizon,
            None if depths is None else depths.reshape(-1))
        return nxt.reshape(states.shape), rew.reshape(E, B), ret.reshape(E, B)


class TrueSimulator(Simulator):
    """Ground-truth simulator on the batched avoidance physics
    (simulators.py:286): states are `physics.EnvState` trees of numpy
    arrays.  The oracle baseline; it has no open-loop rot, so depths are
    ignored."""

    def __init__(self, cfg: Config, device=torch.device("cpu")):
        self.cfg = cfg
        self.device = torch.device(device)
        self.num_actions = cfg.num_actions

    def _round(self, states, actions: np.ndarray,
               generators: List[torch.Generator], horizon: int):
        cfg, dev = self.cfg, self.device
        s = physics.EnvState(*(torch.as_tensor(x, device=dev)
                               for x in states))
        n = s.pos.shape[0]
        nxt, rew = physics.avoidance_step(cfg, s, torch.as_tensor(
            actions, device=dev))
        eval_acts = _draw_actions(cfg, generators, n // len(generators),
                                  horizon, dev)
        roll, rs = nxt, []
        for t in range(horizon):
            roll, r = physics.avoidance_step(cfg, roll, eval_acts[:, t])
            rs.append(r)
        disc = cfg.mcts_discount ** torch.arange(horizon, dtype=torch.float32,
                                                 device=dev)
        ret = torch.sum(torch.stack(rs, 1) * disc[None, :], dim=1)
        host = torch.cat([torch.cat([x.reshape(n, -1) for x in nxt], 1),
                          rew[:, None], ret[:, None]], 1).cpu().numpy()
        out, col = [], 0
        for x in states:
            w = int(np.prod(x.shape[1:]))
            out.append(host[:, col:col + w].reshape(x.shape))
            col += w
        return physics.EnvState(*out), host[:, -2], host[:, -1]

    def round_one(self, states, actions, generator, horizon, depths=None):
        return self._round(states, actions, [generator], horizon)

    def round_many(self, states, actions, generators, horizon, depths=None):
        E, B = actions.shape
        flat = tree_map(lambda x: x.reshape(E * B, *x.shape[2:]), states)
        nxt, rew, ret = self._round(flat, actions.reshape(-1),
                                    list(generators), horizon)
        return (tree_map(lambda x, ref: x.reshape(ref.shape), nxt, states),
                rew.reshape(E, B), ret.reshape(E, B))
