"""GIF and PNG dumps of the port (`stove_tpu_torch/train/visualize.py`)
against `stove_tpu/train/visualize.py`, which writes through Pillow.

* The composed images -- `_to_rgb`, `_draw_box`, the side-by-side rows of
  a rollout GIF and the grid canvas -- are bit-equal to the JAX package's
  on the same numpy-seeded arrays (its rows and canvas caught where it
  hands them to `PIL.Image.fromarray`).
* The port's PNG, decoded with Pillow, equals the JAX package's decoded
  PNG pixel for pixel.
* The port's GIF has the JAX package's frame count, size, frame duration
  and loop count, and decodes to its composed frames within
  `visualize.GREY_ERROR` (one grey level; the box colours exactly).
* `render_states` equals the JAX renderer's frames to 1e-6.
"""

import numpy as np
import pytest
from PIL import Image, ImageSequence

from stove_tpu.config import Config as JConfig
from stove_tpu.train import visualize as jviz
from stove_tpu_torch.config import Config as TConfig
from stove_tpu_torch.train import visualize as tviz


def _frames(rng, T=5, n=32):
    f = rng.uniform(size=(T, n, n)).astype(np.float32)
    f[:, :4] = 0.0
    f[:, -4:] = 1.0
    return f


def _boxes(rng, T=5, O=4):
    s = rng.uniform(0.05, 0.6, (T, O, 2))
    t = rng.uniform(-1.2, 1.2, (T, O, 2))
    return np.concatenate([s, t], -1).astype(np.float32)


@pytest.fixture
def captured(monkeypatch):
    """Every array the JAX package hands to PIL.Image.fromarray."""
    seen = []
    real = Image.fromarray

    def record(a, *args, **kw):
        seen.append(np.array(a))
        return real(a, *args, **kw)

    monkeypatch.setattr(Image, "fromarray", record)
    return seen


def _decode(path):
    im = Image.open(path)
    return im, [np.asarray(f.convert("RGB")) for f in
                ImageSequence.Iterator(im)]


def test_rgb_and_boxes_bit_equal():
    rng = np.random.default_rng(0)
    frames, boxes = _frames(rng), _boxes(rng)
    for t in range(frames.shape[0]):
        for scale in (1, 4):
            a, b = tviz._to_rgb(frames[t], scale), jviz._to_rgb(frames[t],
                                                                scale)
            np.testing.assert_array_equal(a, b)
            for o in range(boxes.shape[1]):
                tviz._draw_box(a, boxes[t, o], tviz._COLORS[o], scale)
                jviz._draw_box(b, boxes[t, o], jviz._COLORS[o], scale)
            np.testing.assert_array_equal(a, b)


def test_side_by_side_gif_matches_jax(tmp_path, captured):
    rng = np.random.default_rng(1)
    rows = [_frames(rng), _frames(rng), _frames(rng)]
    boxes = [_boxes(rng, O=3), None, _boxes(rng, O=6)]
    jpath = jviz.side_by_side_gif(str(tmp_path / "j.gif"), rows, boxes)
    tpath = tviz.side_by_side_gif(str(tmp_path / "t.gif"), rows, boxes)
    composed = tviz.side_by_side_rows(rows, boxes)
    assert len(captured) == len(composed) == 5
    for a, b in zip(composed, captured):
        np.testing.assert_array_equal(a, b)
    jim, _ = _decode(jpath)
    tim, decoded = _decode(tpath)
    assert tim.size == jim.size and tim.n_frames == jim.n_frames == 5
    assert tim.info["duration"] == jim.info["duration"]
    assert tim.info["loop"] == jim.info["loop"] == 0
    info = tviz.read_gif_info(tpath)
    assert (info["width"], info["height"], info["frames"], info["loop"]) == (
        tim.size[0], tim.size[1], 5, 0)
    assert info["delays_cs"] == [jim.info["duration"] // 10] * 5
    colour = np.zeros(composed[0].shape[:2], bool)
    for c in tviz._COLORS:
        colour |= (composed[0] == c).all(-1)
    assert colour.any()
    for got, want in zip(decoded, composed):
        d = np.abs(got.astype(int) - want.astype(int)).max(-1)
        assert d.max() <= tviz.GREY_ERROR
    d0 = np.abs(decoded[0].astype(int) - composed[0].astype(int)).max(-1)
    assert (d0[colour] == 0).all()


def test_frames_to_gif_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    frames, boxes = _frames(rng, T=3), _boxes(rng, T=3, O=2)
    jim, _ = _decode(jviz.frames_to_gif(str(tmp_path / "j.gif"), frames,
                                        boxes, fps=5))
    tim, decoded = _decode(tviz.frames_to_gif(str(tmp_path / "t.gif"),
                                              frames, boxes, fps=5))
    assert (tim.size, tim.n_frames, tim.info["duration"]) == (
        jim.size, jim.n_frames, jim.info["duration"])
    for t, got in enumerate(decoded):
        want = tviz._to_rgb(frames[t])
        for o in range(2):
            tviz._draw_box(want, boxes[t, o], tviz._COLORS[o])
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_grid_png_matches_jax(tmp_path, captured):
    rng = np.random.default_rng(3)
    frames, boxes = _frames(rng, T=11), _boxes(rng, T=11, O=3)
    jpath = jviz.frame_grid(str(tmp_path / "j.png"), frames, boxes, cols=4)
    tpath = tviz.frame_grid(str(tmp_path / "t.png"), frames, boxes, cols=4)
    canvas = tviz.grid_canvas(frames, boxes, cols=4)
    np.testing.assert_array_equal(canvas, captured[0])
    a = np.asarray(Image.open(tpath).convert("RGB"))
    b = np.asarray(Image.open(jpath).convert("RGB"))
    assert Image.open(tpath).mode == "RGB"
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, canvas)


def test_render_states_matches_jax():
    rng = np.random.default_rng(4)
    pos = rng.uniform(-0.9, 0.9, (6, 3, 2)).astype(np.float32)
    radii = rng.uniform(0.8, 1.6, 3).astype(np.float32)
    got = tviz.render_states(TConfig(), pos, radii)
    want = jviz.render_states(JConfig(), pos, radii)
    assert got.shape == (6, 32, 32)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_dump_rollout_gif_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    true = _frames(rng, T=4)
    pos = rng.uniform(-0.8, 0.8, (4, 3, 2)).astype(np.float32)
    sizes = rng.uniform(0.1, 0.2, (4, 3, 2)).astype(np.float32)
    jpath = jviz.dump_rollout_gif(JConfig(), str(tmp_path / "j"), "ep0001",
                                  true, pos, pred_sizes=sizes)
    tpath = tviz.dump_rollout_gif(TConfig(), str(tmp_path / "t"), "ep0001",
                                  true, pos, pred_sizes=sizes)
    assert tpath.endswith("t/rollout_ep0001.gif")
    jim, jframes = _decode(jpath)
    tim, tframes = _decode(tpath)
    assert (tim.size, tim.n_frames) == (jim.size, jim.n_frames)
    # the port's palette is one grey level from the composed frames, and
    # so, at most, is Pillow's adaptive one
    for a, b in zip(tframes, jframes):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= \
            2 * tviz.GREY_ERROR


def test_palette_refuses_other_colours():
    rgb = np.zeros((2, 2, 3), np.uint8)
    rgb[0, 0] = (1, 2, 3)
    with pytest.raises(ValueError, match="palette"):
        tviz.palette_indices(rgb)
    assert len(tviz.PALETTE) <= 256
    greys = np.stack([np.arange(256, dtype=np.uint8)] * 3, -1)[None]
    idx = tviz.palette_indices(greys)
    assert np.abs(tviz.PALETTE[idx[0], 0].astype(int)
                  - np.arange(256)).max() == tviz.GREY_ERROR
