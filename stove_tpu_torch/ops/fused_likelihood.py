"""The SuPAIR likelihood of a frame as one hand-written CUDA kernel.

Counterpart of `stove_tpu/ops/pallas_likelihood.py::likelihood_fused`.
The kernel (`csrc/likelihood.cu`) carries each frame from its pixels and
boxes to the summed log-density: glimpses, patch-space claim weights,
background visibility, the object SPN on every patch and the background
SPN on the frame, a tile of frames a block, with the SPN tile evaluator it
shares with `csrc/spn.cu`; see the notes at the top of the sources.

* `patch_weights` and `likelihood_reference` are the plain version
  (`supair.likelihood` on the patch-space overlap path with dense SPNs,
  supair.py:158-241); `models/supair.py` builds its `likelihood_impl="xla"`
  path from `patch_weights` too.
* `prepare` packs both SPNs' parameters in one launch of the library's
  packing kernel (`fused_spn.layout`); `grids` caches the sample grids.
* `launch_kernel` checks its inputs, launches once on the current stream
  and counts its launches (`launch_kernel.launches`, and by library in
  `launch_kernel.by_library`; the packing kernel's in
  `prepare.by_library`).
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
             f"-DLIK_IMG={cfg.img_size}", f"-DLIK_TB={fused_spn.TILE}",
             f"-DLIK_OVERLAP={int(_overlap(cfg, cfg.num_obj))}",
             *fused_spn.spec_defines(specs.obj, "OBJ"),
             *fused_spn.spec_defines(specs.bg, "BG")))


def _setup(lib: ctypes.CDLL) -> None:
    lib.stove_lik_smem_bytes.restype = ctypes.c_int
    lib.stove_lik_smem_bytes.argtypes = []
    lib.stove_lik_floats.restype = ctypes.c_int
    lib.stove_lik_floats.argtypes = [ctypes.c_int]
    lib.stove_lik_launch.restype = ctypes.c_int
    lib.stove_lik_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                                     + [ctypes.c_void_p] * 6)
    half = [ctypes.c_void_p] * 8 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    lib.stove_lik_pack.restype = ctypes.c_int
    lib.stove_lik_pack.argtypes = half * 2 + [ctypes.c_void_p]


def load(cfg: Config, specs: SupairSpecs) -> ctypes.CDLL:
    src, defines = job(cfg, specs)
    return _build.load(src, defines, _setup)


_GRIDS: Dict[Tuple[str, int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def grids(device: torch.device, patch: int, img: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The patch grid linspace(−1, 1, P) and the pixel grid linspace(−1, 1,
    H) on `device` as the plain version builds them, cached per (device,
    P, H)."""
    key = (str(device), patch, img)
    got = _GRIDS.get(key)
    if got is None:
        got = (torch.linspace(-1.0, 1.0, patch, device=device),
               torch.linspace(-1.0, 1.0, img, device=device))
        _GRIDS[key] = got
    return got


def prepare(cfg: Config, specs: SupairSpecs, params: Dict
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both SPNs' packed buffers (`fused_spn.layout`): one launch of the
    library's packing kernel on CUDA parameters, `fused_spn.pack_reference`
    on CPU ones."""
    po, pb = params["obj_spn"], params["bg_spn"]
    dev = po["leaf_mu"].device
    if dev.type == "cpu":
        return (fused_spn.pack_reference(specs.obj, po),
                fused_spn.pack_reference(specs.bg, pb))
    _build.check_device(*po.values(), *pb.values())
    lib = load(cfg, specs)
    floats = [fused_spn.layout(s)["floats"] for s in (specs.obj, specs.bg)]
    if [lib.stove_lik_floats(0), lib.stove_lik_floats(1)] != floats:
        raise RuntimeError(f"packed layouts: the library's "
                           f"{[lib.stove_lik_floats(i) for i in (0, 1)]} "
                           f"floats, layout()'s {floats}")
    bufs = tuple(torch.empty(n, dtype=torch.float32, device=dev)
                 for n in floats)
    ao, _keep_o = fused_spn.pack_args(specs.obj, po)
    ab, _keep_b = fused_spn.pack_args(specs.bg, pb)
    with torch.cuda.device(dev):
        err = lib.stove_lik_pack(*ao, bufs[0].data_ptr(), *ab,
                                 bufs[1].data_ptr(), _build.stream_of(bufs[0]))
    if err != 0:
        raise RuntimeError(f"likelihood packing kernel failed: CUDA error "
                           f"{err}")
    key = " ".join(job(cfg, specs)[1])
    prepare.by_library[key] = prepare.by_library.get(key, 0) + 1
    return bufs


prepare.by_library = {}           # launches by library (its defines)


def launch_kernel(cfg: Config, specs: SupairSpecs,
                  packed: Tuple[torch.Tensor, torch.Tensor],
                  frames: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """One launch: frames (B, H, W), boxes (B, O, 4) f32 CUDA → (B,);
    `packed` the two buffers of `prepare`."""
    _build.check_device(frames, boxes, *packed)
    B = frames.shape[0]
    O, P, H = cfg.num_obj, cfg.patch_size, cfg.img_size
    if tuple(frames.shape) != (B, H, H) or tuple(boxes.shape) != (B, O, 4):
        raise ValueError(f"frames {tuple(frames.shape)}, boxes "
                         f"{tuple(boxes.shape)}: expected (B, {H}, {H}) and "
                         f"(B, {O}, 4)")
    if frames.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError("the likelihood kernel takes float32 frames and boxes")
    for spec, buf in zip((specs.obj, specs.bg), packed):
        if (buf.dtype != torch.float32
                or buf.numel() != fused_spn.layout(spec)["floats"]):
            raise ValueError("packed buffers: float32, as `prepare` lays "
                             "them out")
    frames, boxes = fused_spn.aligned(frames), boxes.contiguous()
    packed = [fused_spn.aligned(b) for b in packed]
    out = torch.empty((B,), dtype=torch.float32, device=frames.device)
    if B == 0:
        return out
    lib = load(cfg, specs)
    grid_p, grid_img = grids(frames.device, P, H)
    with torch.cuda.device(frames.device):
        err = lib.stove_lik_launch(
            frames.data_ptr(), boxes.data_ptr(), B, grid_p.data_ptr(),
            grid_img.data_ptr(), packed[0].data_ptr(), packed[1].data_ptr(),
            out.data_ptr(), _build.stream_of(frames))
    if err != 0:
        raise RuntimeError(f"likelihood kernel launch failed: CUDA error {err}")
    launch_kernel.launches += 1
    key = " ".join(job(cfg, specs)[1])
    launch_kernel.by_library[key] = launch_kernel.by_library.get(key, 0) + 1
    return out


launch_kernel.launches = 0
launch_kernel.by_library = {}     # launches by library (its defines)


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
        return launch_kernel(cfg, specs, prepare(cfg, specs, split(args)),
                             args[-2], args[-1])

    inputs = ([params["obj_spn"][k] for k in ko]
              + [params["bg_spn"][k] for k in kb] + [frames, boxes])
    if frames.device.type == "cuda":
        return with_plain_vjp(fast, plain, *inputs)
    if frames.device.type != "cpu":
        raise ValueError(f"the likelihood runs on cuda or cpu, not "
                         f"{frames.device}")
    return with_plain_vjp(plain, plain, *inputs)
