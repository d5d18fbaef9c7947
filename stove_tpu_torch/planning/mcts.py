"""MCTS (UCT) over the discrete avoidance actions, with batched leaf
evaluation (counterpart of `stove_tpu/planning/mcts.py`).

Selection by UCB1 under a virtual loss picks up to K = `mcts_frontier`
leaves a round; all K·A children are stepped and evaluated by one
simulator call (`Simulator.round_one`), and the mean child value is backed
up.  `MCTSLockstep` advances E independent searches together, one
simulator call for all E frontiers a round (`Simulator.round_many`).

The trees live on the host as Python objects with numpy states; the
simulator sees only stacked batches, and a round brings back one array
from the device.  Randomness comes from one `torch.Generator` per search
(per episode lane in lockstep), which only the simulator draws from: a
lockstep search draws from each active lane's generator exactly what the
serial search of that episode draws, so the two agree episode by episode.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stove_tpu_torch.config import Config


def tree_map(fn, *trees):
    """Apply `fn` leaf-wise to numpy arrays or (named) tuples of them."""
    first = trees[0]
    if isinstance(first, tuple):
        return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def to_host(tree):
    """Tensors (or tuples of them) as numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else np.asarray(x), tree)


class Simulator:
    """Pluggable simulator interface (learned model or true env).

    States are numpy arrays or tuples of them with leading batch dims.
    """

    num_actions: int

    def round_one(self, states, actions: np.ndarray,
                  generator: torch.Generator, horizon: int,
                  depths: Optional[np.ndarray] = None):
        """One search round: step the (B,) frontier states with `actions`,
        then evaluate the children by `horizon`-step rollouts of random
        actions drawn from `generator`, summing discounted rewards.
        Returns numpy (next_states (B, ...), rewards (B,), returns (B,)).
        `depths` (B,) is each child's depth in the tree; only tree-mode
        depth shrink reads it."""
        raise NotImplementedError

    def round_many(self, states, actions: np.ndarray,
                   generators: Sequence[torch.Generator], horizon: int,
                   depths: Optional[np.ndarray] = None):
        """`round_one` for E searches in one call: states (E, B, ...),
        actions and depths (E, B), one generator per search; returns
        (E, B, ...) results equal, search by search, to `round_one`."""
        raise NotImplementedError


class _Node:
    __slots__ = ("state", "reward", "children", "N", "W")

    def __init__(self, state, reward: float = 0.0):
        self.state = state          # host-side numpy tree (leading dim 1)
        self.reward = reward        # transition reward from the parent
        self.children: Optional[List["_Node"]] = None
        self.N = 0
        self.W = 0.0

    @property
    def value(self) -> float:
        return self.W / self.N if self.N else 0.0


def _ucb(node: _Node, child: _Node, c: float) -> float:
    if child.N == 0:
        return float("inf")
    return child.value + c * math.sqrt(math.log(node.N) / child.N)


class _Search:
    """One tree's in-flight search state (host side)."""

    __slots__ = ("root", "visits", "n_sim", "leaves", "paths")

    def __init__(self, root_state, n_sim: int):
        self.root = _Node(tree_map(lambda x: x[None], to_host(root_state)))
        self.visits = 0
        self.n_sim = n_sim
        self.leaves: List[_Node] = []
        self.paths: List[List[_Node]] = []

    @property
    def done(self) -> bool:
        return self.visits >= self.n_sim


class MCTS:
    """UCT with batched expansion and evaluation (one simulator call per
    round)."""

    def __init__(self, sim: Simulator, cfg: Config):
        self.sim = sim
        self.cfg = cfg

    def _select_round(self, search: _Search) -> int:
        """Select up to K distinct leaves under a virtual loss (paths' visit
        counts pre-incremented, pessimistic value charged, so consecutive
        selections diverge).  Fills search.leaves/paths; returns k."""
        cfg = self.cfg
        A = self.sim.num_actions
        K = max(1, cfg.mcts_frontier)
        root = search.root
        search.leaves, search.paths = [], []
        for _ in range(K):
            path = [root]
            node = root
            while node.children is not None:
                node = max(node.children,
                           key=lambda ch: _ucb(node, ch, cfg.mcts_c_uct))
                path.append(node)
            if node in search.leaves:
                break  # tree exhausted for this round
            search.leaves.append(node)
            search.paths.append(path)
            for n in path:  # virtual loss: discourage re-selection
                n.N += A
                n.W -= A * cfg.mcts_virtual_loss
            if node is root:
                break  # root not yet expanded: only one leaf exists
        return len(search.leaves)

    def _stack_frontier(self, search: _Search):
        """The selected leaves' states as a fixed (K·A, ...) batch (padded
        by repeating the last leaf), the action of each child and its tree
        depth (leaf depth + 1)."""
        A = self.sim.num_actions
        K = max(1, self.cfg.mcts_frontier)
        states = [leaf.state for leaf in search.leaves] or [search.root.state]
        states = states + [states[-1]] * (K - len(states))
        stacked = tree_map(
            lambda *xs: np.repeat(np.concatenate(xs, axis=0), A, axis=0),
            *states)                                            # (K·A, ...)
        acts = np.tile(np.arange(A, dtype=np.int64), K)
        leaf_depths = [len(p) for p in search.paths] or [1]
        leaf_depths = leaf_depths + [leaf_depths[-1]] * (K - len(leaf_depths))
        depths = np.repeat(np.asarray(leaf_depths, dtype=np.int64), A)
        return stacked, acts, depths

    def _apply_round(self, search: _Search, nxt_np, rewards_np: np.ndarray,
                     returns_np: np.ndarray) -> None:
        """Expand the selected leaves with the children's results and back
        up (undoing the virtual loss)."""
        cfg = self.cfg
        A = self.sim.num_actions
        g = cfg.mcts_discount
        child_values = rewards_np + g * returns_np              # (K·A,)
        for i, (leaf, path) in enumerate(zip(search.leaves, search.paths)):
            leaf.children = []
            for a in range(A):
                j = i * A + a
                # a copy, not a view: a view would keep the whole round's
                # batch alive for the life of the tree
                child = _Node(tree_map(lambda x: np.array(x[j:j + 1]),
                                       nxt_np), float(rewards_np[j]))
                child.N = 1
                child.W = float(child_values[j])
                leaf.children.append(child)
            mean_v = float(np.mean(child_values[i * A:(i + 1) * A]))
            for n in reversed(path):
                n.W += A * (mean_v + cfg.mcts_virtual_loss)
                mean_v = n.reward + g * mean_v
            search.visits += A
        search.leaves, search.paths = [], []

    @staticmethod
    def _best(search: _Search) -> Tuple[int, np.ndarray]:
        counts = np.array([ch.N for ch in search.root.children])
        # prefer higher value among equally-visited children
        best = int(np.argmax(counts + 1e-3 * np.array(
            [ch.value for ch in search.root.children])))
        return best, counts

    def run(self, root_state: Any, generator: torch.Generator,
            n_simulations: Optional[int] = None) -> Tuple[int, np.ndarray]:
        """Search from root_state (unbatched).  Returns (best action,
        visit counts of the root's children)."""
        cfg = self.cfg
        search = _Search(root_state, n_simulations or cfg.mcts_simulations)
        while not search.done:
            self._select_round(search)
            stacked, acts, depths = self._stack_frontier(search)
            nxt, rewards, returns = self.sim.round_one(
                stacked, acts, generator, cfg.mcts_horizon, depths)
            self._apply_round(search, nxt, np.asarray(rewards, np.float64),
                              np.asarray(returns, np.float64))
        return self._best(search)


class MCTSLockstep:
    """E independent UCT searches advanced in lockstep: per round every
    running search selects its frontier, the running searches' frontiers
    go to the simulator as one (E', K·A) batch with their generators, and
    the results scatter back.  Finished searches take no part, and their
    generators are not drawn from, so each search's result equals a serial
    `MCTS.run` with the same generator."""

    def __init__(self, sim: Simulator, cfg: Config):
        self.sim = sim
        self.cfg = cfg
        self._mcts = MCTS(sim, cfg)

    def run(self, root_states: Sequence, generators: Sequence[torch.Generator],
            n_simulations: Optional[int] = None
            ) -> Tuple[List[int], List[np.ndarray]]:
        """root_states: E unbatched states; generators: one per search.
        Returns (best actions, visit counts) per search."""
        cfg = self.cfg
        n_sim = n_simulations or cfg.mcts_simulations
        searches = [_Search(s, n_sim) for s in root_states]
        while any(not s.done for s in searches):
            active = [e for e, s in enumerate(searches) if not s.done]
            frontiers = []
            for e in active:
                self._mcts._select_round(searches[e])
                frontiers.append(self._mcts._stack_frontier(searches[e]))
            stacked = tree_map(lambda *xs: np.stack(xs, axis=0),
                               *[f[0] for f in frontiers])   # (E', K·A, ...)
            acts = np.stack([f[1] for f in frontiers], axis=0)
            depths = np.stack([f[2] for f in frontiers], axis=0)
            nxt, rewards, returns = self.sim.round_many(
                stacked, acts, [generators[e] for e in active],
                cfg.mcts_horizon, depths)
            rewards = np.asarray(rewards, np.float64)
            returns = np.asarray(returns, np.float64)
            for i, e in enumerate(active):
                self._mcts._apply_round(
                    searches[e], tree_map(lambda x: x[i], nxt), rewards[i],
                    returns[i])
        results = [MCTS._best(s) for s in searches]
        return [r[0] for r in results], [r[1] for r in results]
