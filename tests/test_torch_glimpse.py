"""Glimpses, box coverage and background visibility of the port against
`stove_tpu/ops/glimpse.py` on the same boxes and images (numpy, fixed
seeds).  Tolerances: the hat weights are the same float32 formula on
pixel coordinates up to 31, where one float32 ulp is 1.9e-6 and XLA may
fuse t + s·g into one FMA; the coverage masks go through two libraries'
sigmoids, a few ulps apart (atol 4e-6 for both); the patches are two
small matmuls whose sums run in another order (atol 1e-5 on pixels in
[0, 1]).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stove_tpu.ops import glimpse as jg
from stove_tpu_torch.ops import glimpse as tg


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, B, O):
    s = rng.uniform(0.1, 0.6, (B, O, 2))
    t = rng.uniform(-1.1, 1.1, (B, O, 2))          # some boxes past the edge
    return np.concatenate([s, t], -1).astype(np.float32)


@pytest.mark.parametrize("img,P", [(32, 10), (16, 7)])
def test_extract_glimpses_matches_jax(img, P):
    rng = np.random.default_rng(img + P)
    images = rng.uniform(0, 1, (5, img, img)).astype(np.float32)
    boxes = _boxes(rng, 5, 3)
    wy, wx = tg.glimpse_weights(_t(boxes), img, P)
    jwy, jwx = jg.glimpse_weights(jnp.asarray(boxes), img, P)
    np.testing.assert_allclose(wy, jwy, atol=4e-6)
    np.testing.assert_allclose(wx, jwx, atol=4e-6)
    got = tg.extract_glimpses(_t(images), _t(boxes), P)
    np.testing.assert_allclose(got, jg.extract_glimpses(images, boxes, P),
                               atol=1e-5)
    # and the classic grid-sample semantics (map_coordinates oracle)
    for b in range(2):
        np.testing.assert_allclose(
            got[b], jg.reference_bilinear(images[b], boxes[b], P), atol=1e-5)


def test_coverage_and_visibility_match_jax():
    rng = np.random.default_rng(3)
    boxes = _boxes(rng, 6, 3)
    boxes[0, 0, 0] = 0.0                            # a zero-size box: 1e-3 floor
    np.testing.assert_allclose(tg.box_coverage(_t(boxes), 32),
                               jg.box_coverage(jnp.asarray(boxes), 32),
                               atol=4e-6)
    np.testing.assert_allclose(
        tg.background_visibility(_t(boxes), 32),
        jg.background_visibility(jnp.asarray(boxes), 32), atol=4e-6)


def test_glimpse_gradient_flows_to_boxes_and_images():
    rng = np.random.default_rng(4)
    images = _t(rng.uniform(0, 1, (2, 16, 16)).astype(np.float32))
    boxes = _t(_boxes(rng, 2, 2))
    images.requires_grad_(True)
    boxes.requires_grad_(True)
    tg.extract_glimpses(images, boxes, 5).sum().backward()
    assert torch.isfinite(boxes.grad).all() and boxes.grad.abs().sum() > 0
    assert torch.isfinite(images.grad).all() and images.grad.abs().sum() > 0
