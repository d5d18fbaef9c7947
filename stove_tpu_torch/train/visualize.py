"""Frame grids and rollout GIFs with box overlays (counterpart of
`stove_tpu/train/visualize.py`).

The frames are composed as the reference composes them (`_to_rgb`,
`_draw_box`, the side-by-side rows and the grid canvas, in numpy), but the
files are written by this module's own encoders, in numpy and the standard
library, since the port does not depend on Pillow:

* PNG (`write_png`): 8-bit RGB, one zlib stream of unfiltered rows.
* GIF89a (`write_gif`): one global palette, LZW-coded frames, the
  NETSCAPE2.0 loop extension and a delay a frame in hundredths of a
  second.  A GIF holds at most 256 colours; a composed frame holds up to
  256 grey levels and the 6 box colours.  The palette (`PALETTE`) is a
  ramp of 250 greys, round(k·255/249) for k = 0..249, and the 6 colours,
  so every decoded pixel is its composed colour exactly (the box colours)
  or a grey at most one level away (`GREY_ERROR`).  The reference lets
  Pillow's adaptive quantiser choose.

`read_gif_info` reads a GIF's size, frame count, delays and loop count
without decoding it.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from stove_tpu_torch.config import Config

# distinct RGB colors per object slot (visualize.py:21)
_COLORS = np.array([
    [255, 80, 80], [80, 255, 80], [100, 140, 255],
    [255, 220, 80], [255, 100, 255], [80, 255, 255],
], dtype=np.uint8)

_GREYS = np.round(np.arange(250) * 255.0 / 249.0).astype(np.uint8)
PALETTE = np.concatenate([np.repeat(_GREYS[:, None], 3, 1), _COLORS])
GREY_ERROR = 1           # largest |decoded - composed| of a grey pixel
# grey level -> the index of the nearest palette grey
_GREY_INDEX = np.abs(np.arange(256)[:, None] - _GREYS[None, :].astype(int)
                     ).argmin(1).astype(np.uint8)


def _to_rgb(frame: np.ndarray, scale: int = 4) -> np.ndarray:
    """(H, W) float [0,1] → (H*s, W*s, 3) uint8."""
    img = np.clip(np.asarray(frame), 0.0, 1.0)
    img = (img * 255).astype(np.uint8)
    img = np.repeat(np.repeat(img, scale, 0), scale, 1)
    return np.stack([img] * 3, axis=-1)


def _draw_box(rgb: np.ndarray, box: np.ndarray, color: np.ndarray,
              scale: int = 4) -> None:
    """Draw one box outline in place.  box = (sx, sy, tx, ty) in [−1,1]."""
    H = rgb.shape[0]
    n = H // scale
    sx, sy, tx, ty = box
    half = (n - 1) / 2.0
    x0 = int(np.clip((tx - sx + 1) * half, 0, n - 1) * scale)
    x1 = int(np.clip((tx + sx + 1) * half, 0, n - 1) * scale) + scale - 1
    y0 = int(np.clip((ty - sy + 1) * half, 0, n - 1) * scale)
    y1 = int(np.clip((ty + sy + 1) * half, 0, n - 1) * scale) + scale - 1
    rgb[y0:y1 + 1, x0] = color
    rgb[y0:y1 + 1, x1] = color
    rgb[y0, x0:x1 + 1] = color
    rgb[y1, x0:x1 + 1] = color


def _boxed(frame: np.ndarray, boxes: Optional[np.ndarray], scale: int
           ) -> np.ndarray:
    """One frame as RGB with the (O, 4) boxes drawn in their colours."""
    rgb = _to_rgb(frame, scale)
    if boxes is not None:
        for o in range(boxes.shape[0]):
            _draw_box(rgb, np.asarray(boxes[o]), _COLORS[o % len(_COLORS)],
                      scale)
    return rgb


def side_by_side_rows(rows: Sequence[np.ndarray],
                      boxes: Optional[Sequence[Optional[np.ndarray]]] = None,
                      scale: int = 4) -> List[np.ndarray]:
    """The frames of `side_by_side_gif`: the (T, H, W) sequences next to
    each other at each t, 2·scale columns of grey 60 between them."""
    gap = 2 * scale
    out = []
    for t in range(rows[0].shape[0]):
        panels = [_boxed(seq[t], None if boxes is None or boxes[i] is None
                         else boxes[i][t], scale)
                  for i, seq in enumerate(rows)]
        sep = np.full((panels[0].shape[0], gap, 3), 60, np.uint8)
        row = panels[0]
        for p in panels[1:]:
            row = np.concatenate([row, sep, p], axis=1)
        out.append(row)
    return out


def grid_canvas(frames: np.ndarray, boxes: Optional[np.ndarray] = None,
                cols: int = 8, scale: int = 4) -> np.ndarray:
    """The image of `frame_grid`: (T, H, W) frames in rows of `cols`,
    `scale` pixels of grey 30 between them."""
    T = frames.shape[0]
    rows = (T + cols - 1) // cols
    H = frames.shape[1] * scale
    gap = scale
    canvas = np.full((rows * (H + gap) - gap, cols * (H + gap) - gap, 3),
                     30, np.uint8)
    for t in range(T):
        r, c = divmod(t, cols)
        y, x = r * (H + gap), c * (H + gap)
        canvas[y:y + H, x:x + H] = _boxed(
            frames[t], None if boxes is None else boxes[t], scale)
    return canvas


# --------------------------------------------------------------- encoders

def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> str:
    """(H, W, 3) uint8 → an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    H, W = rgb.shape[:2]
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           rgb.reshape(H, W * 3)], axis=1)   # filter 0
    _write(path, b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _png_chunk(b"IEND", b""))
    return path


def palette_indices(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) composed frame → (H, W) indices into PALETTE: greys to the
    nearest ramp entry, box colours to their own; any other colour
    raises."""
    r, g, b = (rgb[..., i] for i in range(3))
    idx = _GREY_INDEX[r]
    grey = (r == g) & (g == b)
    for k, c in enumerate(_COLORS):
        hit = (r == c[0]) & (g == c[1]) & (b == c[2])
        idx = np.where(hit, np.uint8(len(_GREYS) + k), idx)
        grey |= hit
    if not grey.all():
        raise ValueError("frame holds a colour outside the GIF palette")
    return idx


def _lzw(indices: np.ndarray, min_size: int = 8) -> bytes:
    """GIF LZW code stream (variable width, LSB first) of 8-bit indices."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    data = indices.tobytes()
    size, nxt, table = min_size + 1, eoi + 1, {}
    emit(clear, size)
    prefix = data[0]
    for k in data[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, size)
        table[key] = nxt
        if nxt >= (1 << size) and size < 12:
            size += 1
        nxt += 1
        if nxt == 4096:                     # table full: start again
            emit(clear, size)
            size, nxt, table = min_size + 1, eoi + 1, {}
        prefix = k
    emit(prefix, size)
    if nxt >= (1 << size) and size < 12:    # the decoder's entry for prefix
        size += 1
    emit(eoi, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(path: str, frames: Sequence[np.ndarray], duration_ms: int,
              loop: int = 0) -> str:
    """(H, W, 3) uint8 frames → an animated GIF89a on PALETTE, each frame
    shown for duration_ms (stored in hundredths of a second, truncated,
    as Pillow stores it), looping `loop` times (0: for ever)."""
    H, W = frames[0].shape[:2]
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(PALETTE)] = PALETTE
    parts = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0),
             pal.tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop)
             + b"\x00"]
    delay = int(duration_ms / 10)
    for rgb in frames:
        if rgb.shape[:2] != (H, W):
            raise ValueError("every frame of a GIF has one size")
        codes = _lzw(palette_indices(rgb))
        parts += [b"\x21\xf9\x04\x00" + struct.pack("<H", delay)
                  + b"\x00\x00",
                  b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0), b"\x08"]
        parts += [bytes([len(codes[i:i + 255])]) + codes[i:i + 255]
                  for i in range(0, len(codes), 255)]
        parts.append(b"\x00")
    parts.append(b"\x3b")
    _write(path, b"".join(parts))
    return path


def read_gif_info(path: str) -> Dict:
    """{"width", "height", "frames", "delays_cs", "loop"} of a GIF file,
    read from its blocks (the image data is skipped, not decoded)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path} is not a GIF")
    W, H, packed = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    info = {"width": W, "height": H, "frames": 0, "delays_cs": [],
            "loop": None}

    def skip_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            label = data[pos + 1]
            if label == 0xF9:
                info["delays_cs"].append(
                    struct.unpack("<H", data[pos + 4:pos + 6])[0])
            elif label == 0xFF and data[pos + 3:pos + 14] == b"NETSCAPE2.0":
                info["loop"] = struct.unpack("<H", data[pos + 16:pos + 18])[0]
            pos = skip_blocks(pos + 2)
        elif data[pos] == 0x2C:
            info["frames"] += 1
            local = data[pos + 9]
            pos += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0)
            pos = skip_blocks(pos + 1)
        else:
            raise ValueError(f"{path}: unknown block {data[pos]:#x}")
    return info


# --------------------------------------------------------------- the files

def frames_to_gif(path: str, frames: np.ndarray,
                  boxes: Optional[np.ndarray] = None,
                  scale: int = 4, fps: int = 8) -> str:
    """frames (T, H, W) [0,1]; boxes (T, O, 4) optional → animated gif."""
    return write_gif(path, [_boxed(frames[t], None if boxes is None
                                   else boxes[t], scale)
                            for t in range(frames.shape[0])],
                     int(1000 / fps))


def side_by_side_gif(path: str, rows: Sequence[np.ndarray],
                     boxes: Optional[Sequence[Optional[np.ndarray]]] = None,
                     scale: int = 4, fps: int = 8) -> str:
    """Stack several (T, H, W) sequences horizontally (true | recon | pred)."""
    return write_gif(path, side_by_side_rows(rows, boxes, scale),
                     int(1000 / fps))


def frame_grid(path: str, frames: np.ndarray,
               boxes: Optional[np.ndarray] = None,
               cols: int = 8, scale: int = 4) -> str:
    """(T, H, W) frames → one PNG grid image."""
    return write_png(path, grid_canvas(frames, boxes, cols, scale))


def render_states(cfg: Config, positions: np.ndarray, radii: np.ndarray
                  ) -> np.ndarray:
    """Render (T, O, 2) model-coordinate positions to (T, H, W) frames
    with the port's physics renderer (for pure-latent rollouts)."""
    from stove_tpu_torch.envs import physics
    from stove_tpu_torch.envs.data import model_to_arena

    arena = model_to_arena(cfg, torch.as_tensor(np.asarray(positions),
                                                dtype=torch.float32))
    r = torch.as_tensor(np.asarray(radii), dtype=torch.float32)
    return physics.render(cfg, arena, r[None, :]).numpy()


def dump_rollout_gif(cfg: Config, run_dir: str, tag: str,
                     true_frames: np.ndarray, pred_pos_model: np.ndarray,
                     boxes: Optional[np.ndarray] = None,
                     pred_sizes: Optional[np.ndarray] = None) -> str:
    """true | predicted-rendered side-by-side gif for one sequence,
    `<run_dir>/rollout_<tag>.gif`.

    pred_sizes (T, O, 2): the model's inferred box scales (fraction of
    image); when given, predicted balls render at the inferred size
    (radius = scale·arena/2) so size-estimate drift is visible."""
    if pred_sizes is not None:
        radii = np.mean(np.asarray(pred_sizes), axis=(0, 2)) \
            * cfg.arena_size / 2.0
    else:
        radii = np.full((pred_pos_model.shape[1],), cfg.ball_radius)
    pred_frames = render_states(cfg, pred_pos_model, radii)
    path = os.path.join(run_dir, f"rollout_{tag}.gif")
    return side_by_side_gif(path, [true_frames, pred_frames],
                            [boxes, None])
