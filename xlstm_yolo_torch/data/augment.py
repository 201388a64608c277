"""The detect train pipeline on the host: mosaic, random perspective, mixup,
HSV and flip, and the letterbox of the eval path, in numpy on
``data.imgproc``.

Port of ``letterbox``, ``random_hsv``, ``random_flip``,
``random_perspective``, ``_box_candidates``, ``mosaic4`` and ``mixup`` in
``xlstm_yolo_tpu/data/augment.py``. Every random number is drawn from the
``np.random.Generator`` passed in, in the JAX package's order, so that one
seed gives the same geometry and gains on both sides. Images are RGB uint8
(H, W, 3); labels are (n, 5) float32 = (cls, x1, y1, x2, y2) in pixels of
the current canvas.
"""
from __future__ import annotations

import math

import numpy as np

from . import imgproc as ip


def letterbox(img: np.ndarray, new_shape: int | tuple, labels: np.ndarray | None = None,
              scaleup: bool = True, pad_value: int = ip.BORDER):
    """Aspect-preserving resize and centred pad -> (img, labels, (r, left,
    top))."""
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    h, w = img.shape[:2]
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    nh, nw = round(h * r), round(w * r)
    pad_h, pad_w = new_shape[0] - nh, new_shape[1] - nw
    top, left = pad_h // 2, pad_w // 2
    if (nh, nw) != (h, w):
        img = ip.resize(img, (nw, nh))
    out = np.full((*new_shape, img.shape[2] if img.ndim == 3 else 1), pad_value, img.dtype)
    out[top:top + nh, left:left + nw] = img.reshape(nh, nw, -1)
    if labels is not None and len(labels):
        labels = labels.copy()
        labels[:, 1:5] = labels[:, 1:5] * r
        labels[:, [1, 3]] += left
        labels[:, [2, 4]] += top
    return out, labels, (r, left, top)


def random_hsv(img: np.ndarray, hgain: float = 0.015, sgain: float = 0.7, vgain: float = 0.4,
               rng: np.random.Generator | None = None) -> np.ndarray:
    """HSV jitter: one gain per channel, applied through look-up tables on
    cv2's HSV (hue wraps at 180)."""
    rng = rng or np.random.default_rng()
    if hgain == sgain == vgain == 0:
        return img
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hsv = ip.rgb2hsv(img)
    x = np.arange(0, 256, dtype=r.dtype)
    lut_h = ((x * r[0]) % 180).astype(img.dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(img.dtype)
    out = np.stack([ip.lut(hsv[..., 0], lut_h), ip.lut(hsv[..., 1], lut_s),
                    ip.lut(hsv[..., 2], lut_v)], axis=-1)
    return ip.hsv2rgb(out)


def random_flip(img: np.ndarray, labels: np.ndarray, fliplr: float = 0.5, flipud: float = 0.0,
                rng: np.random.Generator | None = None):
    """Horizontal, then vertical flip, each with its probability."""
    rng = rng or np.random.default_rng()
    h, w = img.shape[:2]
    if fliplr and rng.random() < fliplr:
        img = np.ascontiguousarray(img[:, ::-1])
        if len(labels):
            x1 = labels[:, 1].copy()
            labels[:, 1] = w - labels[:, 3]
            labels[:, 3] = w - x1
    if flipud and rng.random() < flipud:
        img = np.ascontiguousarray(img[::-1])
        if len(labels):
            y1 = labels[:, 2].copy()
            labels[:, 2] = h - labels[:, 4]
            labels[:, 4] = h - y1
    return img, labels


def rotation_matrix(angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center=(0, 0), angle, scale)``: (2, 3)."""
    a = angle * math.pi / 180
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, 0.0], [-beta, alpha, 0.0]])


def random_perspective(img: np.ndarray, labels: np.ndarray, degrees: float = 0.0,
                       translate: float = 0.1, scale: float = 0.5, shear: float = 0.0,
                       perspective: float = 0.0, border: tuple = (0, 0),
                       rng: np.random.Generator | None = None):
    """Affine (or perspective) warp with the boxes' transform and the
    candidate filter; ``border`` crops a mosaic canvas back to its size."""
    rng = rng or np.random.default_rng()
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = rotation_matrix(a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = ip.warp_perspective(img, M, (width, height))
        else:
            img = ip.warp_affine(img, M[:2], (width, height))

    if len(labels):
        n = len(labels)
        xy = np.ones((n * 4, 3))
        boxes = labels[:, 1:5]
        xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)  # corners
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = _box_candidates(boxes.T * s, new.T)
        labels = labels[keep]
        labels[:, 1:5] = new[keep]
    return img, labels


def _box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
    """Keep warped boxes wider and taller than ``wh_thr`` pixels, with more
    than ``area_thr`` of their scaled area left and an aspect below
    ``ar_thr``."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def mosaic4(images: list, labels_list: list, imgsz: int, rng: np.random.Generator | None = None):
    """Four images on a 2x2 canvas of side 2 * imgsz around a random centre."""
    rng = rng or np.random.default_rng()
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((s * 2, s * 2, 3), ip.BORDER, np.uint8)
    out_labels = []
    for i, (img, labels) in enumerate(zip(images, labels_list)):
        h, w = img.shape[:2]
        r = min(s / h, s / w)
        nh, nw = int(h * r), int(w * r)
        img = ip.resize(img, (nw, nh))
        if i == 0:
            x1a, y1a, x2a, y2a = max(xc - nw, 0), max(yc - nh, 0), xc, yc
            x1b, y1b = nw - (x2a - x1a), nh - (y2a - y1a)
        elif i == 1:
            x1a, y1a, x2a, y2a = xc, max(yc - nh, 0), min(xc + nw, s * 2), yc
            x1b, y1b = 0, nh - (y2a - y1a)
        elif i == 2:
            x1a, y1a, x2a, y2a = max(xc - nw, 0), yc, xc, min(s * 2, yc + nh)
            x1b, y1b = nw - (x2a - x1a), 0
        else:
            x1a, y1a, x2a, y2a = xc, yc, min(xc + nw, s * 2), min(s * 2, yc + nh)
            x1b, y1b = 0, 0
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a), x1b:x1b + (x2a - x1a)]
        if len(labels):
            lb = labels.copy()
            lb[:, 1:5] = lb[:, 1:5] * r
            lb[:, [1, 3]] += x1a - x1b
            lb[:, [2, 4]] += y1a - y1b
            out_labels.append(lb)
    labels = np.concatenate(out_labels, 0) if out_labels else np.zeros((0, 5), np.float32)
    np.clip(labels[:, 1:5:2], 0, 2 * s, out=labels[:, 1:5:2])
    np.clip(labels[:, 2:5:2], 0, 2 * s, out=labels[:, 2:5:2])
    return canvas, labels


def mixup(img1, labels1, img2, labels2, rng: np.random.Generator | None = None):
    """Beta(32, 32) blend of two images; their labels concatenated."""
    rng = rng or np.random.default_rng()
    r = rng.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * r + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
    return img, np.concatenate([labels1, labels2], 0)
