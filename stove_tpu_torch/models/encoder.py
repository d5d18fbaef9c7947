"""Per-frame encoder CNN: image → q(z_where) box parameters per object.

Counterpart of `stove_tpu/models/encoder.py` (`init_params`, `apply`).
Parameters keep the JAX layouts (conv weights HWIO, dense weights
(in, out)); three layout points have to match the JAX code exactly:

* space-to-depth folds each s×s pixel block into channels in (row, col)
  order within the block (encoder.py:79-82);
* XLA's padding="SAME" at stride 2 pads (0, 1) on even sizes, not (1, 1);
  `_same_pad` computes XLA's split and pads explicitly before the conv;
* the flatten before `mlp1` is over NHWC, so features are moved back to
  the last axis first (encoder.py:94).

With cfg.compute_dtype="bfloat16" it computes what encoder.py:71-99 does:
the frames and conv weights in bf16, each conv's output bf16 (the f32 sum
of the rounded operands' products, rounded once: F.conv2d on bf16
tensors, as JAX's bf16 conv_general_dilated without
preferred_element_type), bias and ReLU in f32 and the result rounded to
bf16 again; the dense layers on rounded operands with f32 outputs (an f32
product of the rounded values: `torch.matmul` on two bf16 tensors would
round its output to bf16, which JAX's preferred_element_type=f32 does not).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from stove_tpu_torch.config import Config
from stove_tpu_torch.ops import gaussians


def _normal(generator, shape, scale: float, device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator) * scale).to(device)


def init_params(cfg: Config, generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """Counterpart of `encoder.init_params` (encoder.py:37): He-normal conv
    weights (HWIO) and dense weights N(0, scale/fan_in) with scale 2, the
    head at scale 0.01 so boxes start centred; zero biases."""
    def dense(din, dout, scale):
        return {"w": _normal(generator, (din, dout), (scale / din) ** 0.5,
                             device),
                "b": torch.zeros((dout,), device=device)}

    params: Dict = {"convs": []}
    s2d = max(1, cfg.encoder_space_to_depth)
    cin = cfg.channels * s2d * s2d
    size = cfg.img_size // s2d
    n_convs = len(cfg.encoder_channels)
    for i, cout in enumerate(cfg.encoder_channels):
        params["convs"].append({
            "w": _normal(generator, (3, 3, cin, cout), (2.0 / (9 * cin)) ** 0.5,
                         device),
            "b": torch.zeros((cout,), device=device)})
        cin = cout
        if not (cfg.encoder_final_stride1 and i == n_convs - 1):
            size = (size + 1) // 2
    hidden = cfg.encoder_mlp_hidden
    params["mlp1"] = dense(size * size * cin, hidden, 2.0)
    params["mlp2"] = dense(hidden, hidden, 2.0)
    params["head"] = dense(hidden, cfg.num_obj * 8, 0.01)
    return params


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA "SAME" padding (before, after) for one spatial dim."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def apply(params: Dict, cfg: Config, frames: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (B, H, W) → (mean, std), each (B, O, 4) = (sx, sy, tx, ty)."""
    cd = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    x = frames[..., None].to(cd)                              # (B, H, W, 1)
    s2d = max(1, cfg.encoder_space_to_depth)
    if s2d > 1:
        B, H, W, C = x.shape
        x = x.reshape(B, H // s2d, s2d, W // s2d, s2d, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(
            B, H // s2d, W // s2d, s2d * s2d * C)
    x = x.permute(0, 3, 1, 2)                                 # NCHW
    n_convs = len(params["convs"])
    for i, conv in enumerate(params["convs"]):
        stride = 1 if (cfg.encoder_final_stride1 and i == n_convs - 1) else 2
        w = conv["w"].permute(3, 2, 0, 1).to(cd)              # HWIO → OIHW
        kh, kw = w.shape[2:]
        top, bottom = _same_pad(x.shape[2], kh, stride)
        left, right = _same_pad(x.shape[3], kw, stride)
        x = F.pad(x, (left, right, top, bottom))
        x = F.conv2d(x, w, stride=stride)
        x = torch.relu(x.to(torch.float32)
                       + conv["b"][None, :, None, None]).to(cd)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)         # NHWC flatten

    def dense(layer, v):
        return (v.to(torch.float32) @ layer["w"].to(cd).to(torch.float32)
                + layer["b"])

    x = torch.relu(dense(params["mlp1"], x)).to(cd)
    x = torch.relu(dense(params["mlp2"], x)).to(cd)
    out = dense(params["head"], x).reshape(-1, cfg.num_obj, 8)
    raw_mean, raw_std = out[..., :4], out[..., 4:]

    smin, smax = cfg.scale_min, cfg.scale_max
    scales = smin + (smax - smin) * torch.sigmoid(raw_mean[..., 0:2] + 0.5)
    pos = torch.tanh(raw_mean[..., 2:4]) * (1.0 - smin)
    mean = torch.cat([scales, pos], dim=-1)
    std = gaussians.bounded_std(raw_std, cfg.min_enc_std, cfg.max_enc_std)
    return mean, std
