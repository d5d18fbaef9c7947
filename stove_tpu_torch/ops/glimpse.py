"""Spatial-transformer glimpses as separable hat-weight matmuls.

Counterpart of `stove_tpu/ops/glimpse.py`.  Boxes are axis-aligned
(sx, sy, tx, ty) in ST [−1, 1] coordinates, sampled with align_corners=True
and border clamping, so bilinear sampling is separable: each patch is
W_y (P×H) · image (H×W) · W_xᵀ (W×P), with W_y, W_x dense hat-function
weight matrices (at most two nonzeros per row).  No gathers: the gradient
with respect to the image and the boxes is the same matmuls transposed.

Also the soft per-pixel box coverage masks the likelihood needs for
background marginalisation.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _hat_weights(coords: torch.Tensor, size: int) -> torch.Tensor:
    """(..., P) sampling positions in pixel units → (..., P, size) bilinear
    weights max(0, 1 − |clip(c) − src|), i.e. linear interpolation with
    border clamping."""
    c = torch.clamp(coords, 0.0, size - 1.0)
    src = torch.arange(size, dtype=coords.dtype, device=coords.device)
    return torch.clamp(1.0 - torch.abs(c[..., None] - src), min=0.0)


def glimpse_weights(boxes: torch.Tensor, img_size: int, patch_size: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-box interpolation matrices (W_y, W_x), each (..., patch, img)."""
    sx, sy, tx, ty = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    g = torch.linspace(-1.0, 1.0, patch_size, dtype=boxes.dtype,
                       device=boxes.device)
    u = tx[..., None] + sx[..., None] * g
    v = ty[..., None] + sy[..., None] * g
    half = (img_size - 1) / 2.0
    return (_hat_weights((v + 1.0) * half, img_size),
            _hat_weights((u + 1.0) * half, img_size))


def extract_glimpses(images: torch.Tensor, boxes: torch.Tensor,
                     patch_size: int) -> torch.Tensor:
    """images (B, H, W), boxes (B, O, 4) → patches (B, O, P, P)."""
    wy, wx = glimpse_weights(boxes, images.shape[-2], patch_size)
    rows = torch.einsum("boph,bhw->bopw", wy, images)
    return torch.einsum("bopw,boqw->bopq", rows, wx)


def edge(t, s, c, sharpness: float = 8.0):
    """Separable sigmoid box edge: ≈1 where |c − t| < s, width ~1/sharpness
    in ST units (glimpse.box_coverage's and supair.likelihood's `edge`)."""
    return torch.sigmoid(sharpness * (s - torch.abs(c - t))
                         / torch.clamp(s, min=1e-3))


def box_coverage(boxes: torch.Tensor, img_size: int,
                 sharpness: float = 8.0) -> torch.Tensor:
    """boxes (B, O, 4) → (B, O, H, W) soft coverage masks in (0, 1)."""
    coord = torch.linspace(-1.0, 1.0, img_size, dtype=boxes.dtype,
                           device=boxes.device)
    sx, sy, tx, ty = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    mx = edge(tx[..., None], sx[..., None], coord, sharpness)   # (B, O, W)
    my = edge(ty[..., None], sy[..., None], coord, sharpness)   # (B, O, H)
    return my[..., :, None] * mx[..., None, :]


def background_visibility(boxes: torch.Tensor, img_size: int,
                          sharpness: float = 8.0) -> torch.Tensor:
    """(B, H, W) background weight per pixel: Π_o (1 − cover_o)."""
    return torch.prod(1.0 - box_coverage(boxes, img_size, sharpness), dim=1)
