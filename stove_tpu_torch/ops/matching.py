"""Object matching for evaluation (predicted slots ↔ ground-truth objects).

Counterpart of `stove_tpu/ops/matching.py`: exact min-cost assignment by
enumerating all O! permutations (O ≤ ~6), ties resolved to the first
minimal permutation as `argmin` does in both frameworks.
"""

from __future__ import annotations

import itertools

import torch


def assignment_bruteforce(cost: torch.Tensor) -> torch.Tensor:
    """cost (..., O, O), cost[..., i, j] matches row i to column j.
    Returns column indices (..., O): row i ↔ column out[..., i]."""
    O = cost.shape[-1]
    perms = torch.tensor(list(itertools.permutations(range(O))),
                         dtype=torch.long, device=cost.device)   # (P, O)
    rows = torch.arange(O, device=cost.device)
    totals = torch.sum(cost[..., rows, perms], dim=-1)            # (..., P)
    return perms[torch.argmin(totals, dim=-1)]


def match_positions(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """pred, true (B, O, 2) → perm (B, O) with pred[b, perm[b, i]] ↔
    true[b, i]."""
    cost = torch.sum((true[:, :, None, :] - pred[:, None, :, :]) ** 2, -1)
    return assignment_bruteforce(cost)


def apply_permutation(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Gather slots: x (B, O, ...) reordered by perm (B, O)."""
    B, O = perm.shape
    idx = perm.reshape(B, O, *([1] * (x.ndim - 2))).expand(B, O, *x.shape[2:])
    return torch.gather(x, 1, idx)
