"""The SuPAIR likelihood of a frame as one hand-written CUDA kernel.

Counterpart of `stove_tpu/ops/pallas_likelihood.py::likelihood_fused`.
The kernel (`csrc/likelihood.cu`) carries each frame from its pixels and
boxes to the summed log-density: glimpses, patch-space claim weights,
background visibility, the object SPN on every patch and the background
SPN on the frame, with the SPN device function it shares with
`csrc/spn.cu`; see the notes at the top of the source.

* `patch_weights` and `likelihood_reference` are the plain version
  (`supair.likelihood` on the patch-space overlap path with dense SPNs,
  supair.py:158-241); `models/supair.py` builds its `likelihood_impl="xla"`
  path from `patch_weights` too.
* `launch_kernel` checks its inputs, launches once on the current stream
  and counts its launches (`launch_kernel.launches`).
* `likelihood_fused` is the dispatch `likelihood_impl="pallas"` takes: the
  kernel on CUDA tensors, the plain version on CPU tensors, and the plain
  version's gradient on both.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Dict, Tuple

import torch

from stove_tpu_torch.config import Config
from stove_tpu_torch.models import spn as spn_lib
from stove_tpu_torch.ops import _build, fused_spn, glimpse
from stove_tpu_torch.ops._vjp import with_plain_vjp

if TYPE_CHECKING:
    from stove_tpu_torch.models.supair import SupairSpecs


def _overlap(cfg: Config, num_obj: int) -> bool:
    return bool(cfg.overlap_correction) and num_obj > 1


def patch_weights(cfg: Config, boxes: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-patch-pixel object weights (B, O, P, P) and background weights
    (B, H, W) for boxes (B, O, 4).

    With the overlap correction (patch space, supair.py:160-205): object o
    marginalises what earlier objects claim at its own sample points,
    w = clip(1 − max_{j<o} edge_y(j)·edge_x(j), 0, 1); the background
    weight is 1 − max_o cover_o.  Without it: ones, and Π_o (1 − cover_o).
    """
    B, O = boxes.shape[:2]
    P, H = cfg.patch_size, cfg.img_size
    if not _overlap(cfg, O):
        return (boxes.new_ones((B, O, P, P)),
                glimpse.background_visibility(boxes, H))
    g = torch.linspace(-1.0, 1.0, P, dtype=boxes.dtype, device=boxes.device)
    u = boxes[..., 2:3] + boxes[..., 0:1] * g                 # (B, O, P) x
    v = boxes[..., 3:4] + boxes[..., 1:2] * g                 # (B, O, P) y
    sx, sy, tx, ty = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    ey = glimpse.edge(ty[:, :, None, None], sy[:, :, None, None], v[:, None])
    ex = glimpse.edge(tx[:, :, None, None], sx[:, :, None, None], u[:, None])
    ws = [boxes.new_ones((B, P, P))]
    for o in range(1, O):
        claimed = ey[:, 0, o, :, None] * ex[:, 0, o, None, :]
        for j in range(1, o):
            claimed = torch.maximum(
                claimed, ey[:, j, o, :, None] * ex[:, j, o, None, :])
        ws.append(torch.clamp(1.0 - claimed, 0.0, 1.0))
    coord = torch.linspace(-1.0, 1.0, H, dtype=boxes.dtype,
                           device=boxes.device)
    by = glimpse.edge(ty[:, :, None], sy[:, :, None], coord)  # (B, O, H)
    bx = glimpse.edge(tx[:, :, None], sx[:, :, None], coord)  # (B, O, W)
    cover = by[:, 0, :, None] * bx[:, 0, None, :]
    for o in range(1, O):
        cover = torch.maximum(cover, by[:, o, :, None] * bx[:, o, None, :])
    return torch.stack(ws, dim=1), 1.0 - cover


def likelihood_reference(cfg: Config, specs: SupairSpecs, params: Dict,
                         frames: torch.Tensor, boxes: torch.Tensor
                         ) -> torch.Tensor:
    """The plain version: frames (B, H, W), boxes (B, O, 4) → (B,)."""
    B, O = boxes.shape[:2]
    P = cfg.patch_size
    patches = glimpse.extract_glimpses(frames, boxes, P)
    patch_w, bg_vis = patch_weights(cfg, boxes)
    obj_ll = spn_lib.spn_log_prob(specs.obj, params["obj_spn"],
                                  patches.reshape(B * O, P * P),
                                  patch_w.reshape(B * O, P * P))
    bg_ll = spn_lib.spn_log_prob(specs.bg, params["bg_spn"],
                                 frames.reshape(B, -1), bg_vis.reshape(B, -1))
    return torch.sum(obj_ll.reshape(B, O), dim=1) + bg_ll


def job(cfg: Config, specs: SupairSpecs) -> _build.Job:
    return ("likelihood.cu",
            (f"-DLIK_O={cfg.num_obj}", f"-DLIK_P={cfg.patch_size}",
             f"-DLIK_IMG={cfg.img_size}",
             f"-DLIK_OVERLAP={int(_overlap(cfg, cfg.num_obj))}",
             *fused_spn.spec_defines(specs.obj, "OBJ"),
             *fused_spn.spec_defines(specs.bg, "BG")))


def _setup(lib: ctypes.CDLL) -> None:
    lib.stove_lik_smem_bytes.restype = ctypes.c_int
    lib.stove_lik_smem_bytes.argtypes = []
    lib.stove_lik_launch.restype = ctypes.c_int
    lib.stove_lik_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 18


def load(cfg: Config, specs: SupairSpecs) -> ctypes.CDLL:
    src, defines = job(cfg, specs)
    return _build.load(src, defines, _setup)


_SPN_ORDER = ("perm", "bounds", "mu", "sd", "logsd", "sumw", "root")


def launch_kernel(cfg: Config, specs: SupairSpecs, obj_prep: Dict,
                  bg_prep: Dict, frames: torch.Tensor, boxes: torch.Tensor
                  ) -> torch.Tensor:
    """One launch: frames (B, H, W), boxes (B, O, 4) f32 CUDA → (B,)."""
    _build.check_device(frames, boxes, *obj_prep.values(), *bg_prep.values())
    B = frames.shape[0]
    O, P, H = cfg.num_obj, cfg.patch_size, cfg.img_size
    if tuple(frames.shape) != (B, H, H) or tuple(boxes.shape) != (B, O, 4):
        raise ValueError(f"frames {tuple(frames.shape)}, boxes "
                         f"{tuple(boxes.shape)}: expected (B, {H}, {H}) and "
                         f"(B, {O}, 4)")
    if frames.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError("the likelihood kernel takes float32 frames and boxes")
    frames, boxes = frames.contiguous(), boxes.contiguous()
    out = torch.empty((B,), dtype=torch.float32, device=frames.device)
    if B == 0:
        return out
    lib = load(cfg, specs)
    grid_p = torch.linspace(-1.0, 1.0, P, device=frames.device)
    grid_img = torch.linspace(-1.0, 1.0, H, device=frames.device)
    with torch.cuda.device(frames.device):
        err = lib.stove_lik_launch(
            frames.data_ptr(), boxes.data_ptr(), B, grid_p.data_ptr(),
            grid_img.data_ptr(), *[obj_prep[k].data_ptr() for k in _SPN_ORDER],
            *[bg_prep[k].data_ptr() for k in _SPN_ORDER], out.data_ptr(),
            _build.stream_of(frames))
    if err != 0:
        raise RuntimeError(f"likelihood kernel launch failed: CUDA error {err}")
    launch_kernel.launches += 1
    return out


launch_kernel.launches = 0


def likelihood_fused(cfg: Config, specs: SupairSpecs, params: Dict,
                     frames: torch.Tensor, boxes: torch.Tensor
                     ) -> torch.Tensor:
    """`likelihood_impl="pallas"`: (B, H, W) frames, (B, O, 4) boxes →
    (B,); params is the supair dict (obj_spn, bg_spn).  Patch-space
    overlap only, as supair.py:149-156 requires."""
    if _overlap(cfg, boxes.shape[1]) and cfg.overlap_impl != "patch":
        raise ValueError(
            "likelihood_impl='pallas' implements the patch-space overlap "
            "correction; set overlap_impl='patch' (default) or "
            "likelihood_impl='xla'.")
    ko, kb = fused_spn.param_keys(specs.obj), fused_spn.param_keys(specs.bg)
    n = len(ko)

    def split(args):
        return {"obj_spn": dict(zip(ko, args[:n])),
                "bg_spn": dict(zip(kb, args[n:n + len(kb)]))}

    def plain(*args):
        return likelihood_reference(cfg, specs, split(args), args[-2],
                                    args[-1])

    def fast(*args):
        p = split(args)
        return launch_kernel(cfg, specs,
                             fused_spn.prepare(specs.obj, p["obj_spn"]),
                             fused_spn.prepare(specs.bg, p["bg_spn"]),
                             args[-2], args[-1])

    inputs = ([params["obj_spn"][k] for k in ko]
              + [params["bg_spn"][k] for k in kb] + [frames, boxes])
    if frames.device.type == "cuda":
        return with_plain_vjp(fast, plain, *inputs)
    if frames.device.type != "cpu":
        raise ValueError(f"the likelihood runs on cuda or cpu, not "
                         f"{frames.device}")
    return with_plain_vjp(plain, plain, *inputs)
