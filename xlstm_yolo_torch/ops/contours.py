"""Contours of binary masks, as OpenCV traces them, without OpenCV.

``find_contours(mask)`` returns what ``cv2.findContours(mask,
cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]`` returns: the outer
contours in the same order, each an (N, 1, 2) int32 array of (x, y) points
from the same start pixel. The border following is ``native/contours.cpp``
(built with g++ on first use). ``contour_area`` is ``cv2.contourArea``
(the shoelace formula in float64, unsigned). ``masks2segments`` and
``mask_to_polygon`` are the two ways the JAX package turns a mask into one
polygon: the longest point list (``engine/results.py``) and the largest
area (``data/annotator.py``); ties keep the first in OpenCV's order.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import native


def find_contours(mask: np.ndarray) -> list:
    """A 2-D mask (nonzero = object) -> its external contours, each (N, 1, 2)
    int32, in OpenCV's order."""
    m = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    if m.ndim != 2:
        raise ValueError(f"find_contours takes a 2-D mask, got {m.shape}")
    h, w = m.shape
    nnz = int(m.sum())
    if nnz == 0:
        return []
    cap_contours, cap_pts = nnz + 1, 8 * nnz + 16
    pts = np.empty(cap_pts, np.int32)
    lens = np.empty(cap_contours, np.int32)
    lib = native.get_lib(native.CONTOURS_SOURCE)
    intp = ctypes.POINTER(ctypes.c_int)
    n = lib.find_external_contours(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                                   pts.ctypes.data_as(intp), cap_pts,
                                   lens.ctypes.data_as(intp), cap_contours)
    if n < 0:
        raise RuntimeError("find_contours: point buffer too small")
    out, k = [], 0
    for ln in lens[:n]:
        out.append(pts[k:k + 2 * ln].reshape(-1, 1, 2).copy())
        k += 2 * ln
    return out


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea(contour)``: the polygon's unsigned area."""
    p = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(p) < 3:
        return 0.0
    q = np.roll(p, 1, axis=0)
    return float(abs(np.sum(q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0]) * 0.5))


def masks2segments(masks: np.ndarray) -> list:
    """Binary (n, h, w) masks -> per mask the (N, 2) float32 points of its
    contour with the most points ((0, 2) for an empty mask)."""
    segments = []
    for m in np.asarray(masks):
        contours = find_contours(m)
        if contours:
            c = max((x.reshape(-1, 2) for x in contours), key=len)
        else:
            c = np.zeros((0, 2), np.float32)
        segments.append(c.astype(np.float32))
    return segments


def mask_to_polygon(mask: np.ndarray, max_points: int = 200) -> np.ndarray:
    """The contour of largest area of a bool mask, thinned to at most about
    ``max_points`` points, normalized to [0, 1] by (w, h): (N, 2) float32."""
    contours = find_contours(mask)
    if not contours:
        return np.zeros((0, 2), np.float32)
    c = max(contours, key=contour_area).reshape(-1, 2).astype(np.float32)
    if len(c) > max_points:
        c = c[:: len(c) // max_points + 1]
    h, w = mask.shape
    return c / np.asarray([w, h], np.float32)
