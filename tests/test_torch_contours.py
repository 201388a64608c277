"""The port's contour tracer (``xlstm_yolo_torch/ops/contours.py``, border
following in ``native/contours.cpp``) against OpenCV, point for point.

``find_contours(m)`` against ``cv2.findContours(m, RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE)[0]``: the same contours in the same order, each the
same points from the same start, on seeded blobs, masks with holes, single
pixels, diagonal links, masks that touch or fill the border, and empty
masks; ``contour_area`` against ``cv2.contourArea``; ``masks2segments``
against the JAX ``engine/results.py`` one (the longest contour) and
``mask_to_polygon`` against JAX's ``data/annotator.py`` ``_mask_to_polygon``
(the largest area, thinned), both exactly.
"""
import cv2
import numpy as np
import pytest

from xlstm_yolo_tpu.data.annotator import _mask_to_polygon as jax_mask_to_polygon
from xlstm_yolo_tpu.engine.results import masks2segments as jax_masks2segments
from xlstm_yolo_torch.engine.results import Masks
from xlstm_yolo_torch.ops.contours import (contour_area, find_contours, mask_to_polygon,
                                           masks2segments)


def _mask(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, 48, 2))
    if kind == "noise":
        return (rng.random((h, w)) < rng.uniform(0.1, 0.7)).astype(np.uint8)
    if kind == "blobs":
        m = np.zeros((h, w), np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            cv2.circle(m, (int(rng.integers(0, w)), int(rng.integers(0, h))),
                       int(rng.integers(1, 10)), 1, -1)
        m[rng.random((h, w)) < 0.05] ^= 1
        return m
    if kind == "holes":
        m = np.ones((h, w), np.uint8)
        m[rng.random((h, w)) < 0.2] = 0
        return m
    if kind == "pixels":
        m = np.zeros((h, w), np.uint8)
        m[rng.random((h, w)) < 0.03] = 1
        return m
    raise ValueError(kind)


FIXED = {
    "diagonal": np.eye(9, dtype=np.uint8) + np.eye(9, k=2, dtype=np.uint8),
    "ring": np.pad(np.pad(np.zeros((3, 4), np.uint8), 2, constant_values=1), 3),
    "border": np.ones((6, 7), np.uint8),
    "single": np.pad(np.ones((1, 1), np.uint8), 2),
    "corner_touch": np.array([[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 1, 1], [0, 0, 1, 1]], np.uint8),
    "one_row": np.array([[0, 1, 1, 0, 1]], np.uint8),
    "empty": np.zeros((5, 5), np.uint8),
}


def _assert_same(mask):
    want = cv2.findContours(mask * 255, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
    got = find_contours(mask)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int32 and g.shape == w.shape
        assert contour_area(g) == cv2.contourArea(w)
    return len(got)


@pytest.mark.parametrize("kind", ["noise", "blobs", "holes", "pixels"])
def test_seeded_masks_match_cv2(kind):
    n = sum(_assert_same(_mask(kind, seed)) for seed in range(60))
    assert n > 60


@pytest.mark.parametrize("name", list(FIXED))
def test_fixed_masks_match_cv2(name):
    _assert_same(FIXED[name])


def test_segments_and_polygons_match_jax():
    masks = np.stack([np.pad(_mask("blobs", s), ((0, 20), (0, 20)))[:20, :20]
                      for s in range(12)])
    got, want = masks2segments(masks), jax_masks2segments(masks)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    for m in masks:
        a, b = mask_to_polygon(m.astype(bool)), jax_mask_to_polygon(m.astype(bool))
        np.testing.assert_array_equal(a, b)
    big = np.zeros((300, 300), bool)
    cv2.circle(big.view(np.uint8), (150, 150), 120, 1, -1)
    np.testing.assert_array_equal(mask_to_polygon(big, max_points=50),
                                  jax_mask_to_polygon(big, max_points=50))


def test_masks_xy_trace_the_masks():
    """``Masks.xy`` / ``xyn`` at the image's size: the points lie on the
    masks' borders (no longer NotImplementedError)."""
    m = np.zeros((2, 40, 60), bool)
    m[0, 5:20, 10:30] = True
    cv2.circle(m[1].view(np.uint8), (40, 25), 9, 1, -1)
    masks = Masks(m, (40, 60))
    for seg, segn, mk in zip(masks.xy, masks.xyn, m):
        assert len(seg) >= 4
        np.testing.assert_allclose(segn * [60, 40], seg, rtol=1e-6)
        xs, ys = seg[:, 0].astype(int), seg[:, 1].astype(int)
        assert mk[ys, xs].all()
        inner = np.pad(mk, 1)[1:-1, :-2] & np.pad(mk, 1)[1:-1, 2:] & \
            np.pad(mk, 1)[:-2, 1:-1] & np.pad(mk, 1)[2:, 1:-1]
        assert not inner[ys, xs].any()
