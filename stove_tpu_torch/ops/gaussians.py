"""Diagonal-Gaussian algebra (counterpart of `stove_tpu/ops/gaussians.py`).

Elementwise on matching-shape mean/std tensors, so everything broadcasts
over (B, O, D).  `sample` takes its noise as an argument: the caller draws
it from its own `torch.Generator` (or hands in the JAX package's draws in
the parity tests).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_LOG2PI = math.log(2.0 * math.pi)


def log_prob(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Elementwise log N(x; mean, std²). Sum over trailing dims yourself."""
    z = (x - mean) / std
    log_std = (math.log(std) if isinstance(std, (int, float))
               else torch.log(std))
    return -0.5 * (z * z + _LOG2PI) - log_std


def sample(mean: torch.Tensor, std: torch.Tensor,
           eps: torch.Tensor) -> torch.Tensor:
    """Reparameterized sample mean + std ⊙ ε with ε given."""
    return mean + std * eps


def product(mean_a: torch.Tensor, std_a: torch.Tensor,
            mean_b: torch.Tensor, std_b: torch.Tensor,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precision-weighted product of two Gaussian densities (variance form):
    1/σ² = 1/σa² + 1/σb²,  μ = σ²·(μa/σa² + μb/σb²)."""
    va, vb = std_a * std_a, std_b * std_b
    denom = va + vb
    var = va * vb / denom
    mean = (mean_a * vb + mean_b * va) / denom
    return mean, torch.sqrt(var)


def kl(mean_q: torch.Tensor, std_q: torch.Tensor,
       mean_p: torch.Tensor, std_p: torch.Tensor) -> torch.Tensor:
    """Elementwise KL(N_q || N_p) for diagonal Gaussians."""
    vq, vp = std_q * std_q, std_p * std_p
    return 0.5 * (vq / vp + (mean_q - mean_p) ** 2 / vp - 1.0) \
        + torch.log(std_p) - torch.log(std_q)


def bounded_std(raw: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Map unconstrained raw values to std ∈ (lo, hi) via scaled sigmoid."""
    return lo + (hi - lo) * torch.sigmoid(raw)
