"""SuPAIR recognition, inference half only.

Counterpart of `stove_tpu/models/supair.py::encode` and
`::where_prior_logp`.  The SPN likelihood and the SuPAIR ELBO belong to the
training path and are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from stove_tpu_torch.config import Config
from stove_tpu_torch.models import encoder as encoder_lib
from stove_tpu_torch.ops import gaussians


def encode(params: Dict, cfg: Config, frames: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (B, H, W) → q(z_where) (mean, std), each (B, O, 4)."""
    return encoder_lib.apply(params["encoder"], cfg, frames)


def where_prior_logp(cfg: Config, boxes: torch.Tensor) -> torch.Tensor:
    """log p(z_where): Gaussian prior on scales, uniform on [−1, 1]²
    positions (constant −log 2 per coordinate).  boxes (B, O, 4) → (B,)."""
    s_mean = 0.5 * (cfg.scale_min + cfg.scale_max)
    s_std = 0.5 * (cfg.scale_max - cfg.scale_min)
    lp_scale = gaussians.log_prob(boxes[..., 0:2], s_mean, s_std)
    lp_pos = torch.full_like(boxes[..., 2:4], -math.log(2.0))
    return torch.sum(lp_scale, (-2, -1)) + torch.sum(lp_pos, (-2, -1))
