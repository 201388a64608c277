"""The train pipeline on the host: mosaic, random perspective, mixup,
copy-paste, HSV and flip, and the letterbox of the eval path, in numpy on
``data.imgproc``.

Port of ``letterbox``, ``random_hsv``, ``random_flip``,
``random_perspective``, ``_box_candidates``, ``mosaic4``, ``mixup``,
``mosaic4_points`` / ``mosaic3_points`` / ``mosaic9_points`` (``mosaic4``,
``mosaic3``, ``mosaic9`` given ``extras``), ``_shift_points``,
``_cat_extras``, ``copy_paste_flip`` and ``copy_paste_mix`` in
``xlstm_yolo_tpu/data/augment.py``. The point tasks' annotations ride in
an ``extra`` dict beside the labels: ``segments`` (a list of (k, 2)
polygons), ``keypoints`` (n, K, 3) or ``corners`` (n, 4, 2), in pixels. Every random number is drawn from the
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


def shift_points(extra: dict, scale: float, dx: float, dy: float) -> dict:
    """Every point set of ``extra`` scaled by ``scale`` and moved by (dx, dy)."""
    out = {}
    d = np.asarray([dx, dy], np.float32)
    if "segments" in extra:
        out["segments"] = [p * scale + d for p in extra["segments"]]
    if "keypoints" in extra:
        k = extra["keypoints"].copy()
        k[..., 0] = k[..., 0] * scale + dx
        k[..., 1] = k[..., 1] * scale + dy
        out["keypoints"] = k
    if "corners" in extra:
        out["corners"] = extra["corners"] * scale + d
    return out


def cat_extras(extras: list) -> dict:
    """Point sets of several images' labels, concatenated in order."""
    keys = set().union(*[e.keys() for e in extras]) if extras else set()
    out = {}
    if "segments" in keys:
        out["segments"] = [p for e in extras for p in e.get("segments", [])]
    for key, empty in (("keypoints", (0, 1, 3)), ("corners", (0, 4, 2))):
        if key in keys:
            parts = [e[key] for e in extras if key in e and len(e[key])]
            out[key] = np.concatenate(parts, 0) if parts else np.zeros(empty, np.float32)
    return out


def mosaic4(images: list, labels_list: list, imgsz: int, rng: np.random.Generator | None = None,
            extras: list | None = None):
    """Four images on a 2x2 canvas of side 2 * imgsz around a random centre
    -> (canvas, labels), or with ``extras`` (one point dict an image) ->
    (canvas, labels, extra)."""
    rng = rng or np.random.default_rng()
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((s * 2, s * 2, 3), ip.BORDER, np.uint8)
    out_labels, out_extras = [], []
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
            if extras is not None:
                out_extras.append(shift_points(extras[i], r, x1a - x1b, y1a - y1b))
    labels = np.concatenate(out_labels, 0) if out_labels else np.zeros((0, 5), np.float32)
    np.clip(labels[:, 1:5:2], 0, 2 * s, out=labels[:, 1:5:2])
    np.clip(labels[:, 2:5:2], 0, 2 * s, out=labels[:, 2:5:2])
    if extras is not None:
        return canvas, labels, cat_extras(out_extras)
    return canvas, labels


def _mosaic_grid(images: list, labels_list: list, imgsz: int, corner, extras=None) -> tuple:
    """Images placed on a 3s x 3s canvas at ``corner(i, nw, nh)`` -> (x1,
    y1) of tile i (each image resized to fit s x s first), then the centre
    2s x 2s cropped (the reference's border -s // 2 on the 3s canvas);
    ``extras`` as for ``mosaic4``."""
    s = imgsz
    canvas = np.full((s * 3, s * 3, 3), ip.BORDER, np.uint8)
    out_labels, out_extras = [], []
    for i, (img, labels) in enumerate(zip(images, labels_list)):
        h, w = img.shape[:2]
        r = min(s / h, s / w)
        nh, nw = int(h * r), int(w * r)
        img = ip.resize(img, (nw, nh))
        padw, padh = corner(i, nw, nh)
        x1, y1 = max(padw, 0), max(padh, 0)
        x2, y2 = min(max(padw + nw, 0), 3 * s), min(max(padh + nh, 0), 3 * s)
        canvas[y1:y2, x1:x2] = img[y1 - padh:y2 - padh, x1 - padw:x2 - padw]
        if len(labels):
            lb = labels.copy()
            lb[:, 1:5] *= r
            lb[:, [1, 3]] += padw
            lb[:, [2, 4]] += padh
            out_labels.append(lb)
            if extras is not None:
                out_extras.append(shift_points(extras[i], r, padw, padh))
    off = s // 2
    canvas = canvas[off:off + 2 * s, off:off + 2 * s]
    labels = np.concatenate(out_labels, 0) if out_labels else np.zeros((0, 5), np.float32)
    labels[:, 1:5] -= off
    np.clip(labels[:, 1:5:2], 0, 2 * s, out=labels[:, 1:5:2])
    np.clip(labels[:, 2:5:2], 0, 2 * s, out=labels[:, 2:5:2])
    if extras is not None:
        return canvas, labels, cat_extras([shift_points(e, 1.0, -off, -off) for e in out_extras])
    return canvas, labels


def mosaic3(images: list, labels_list: list, imgsz: int, extras: list | None = None):
    """Three images in a row (the first in the centre, the second right of
    it, the third left) -> a 2s x 2s canvas and its labels. Draws nothing."""
    s = imgsz
    st = {}

    def corner(i, nw, nh):
        if i == 0:
            st["h0"], st["w0"] = nh, nw
        return [(s, s), (s + st["w0"], s), (s - nw, s + st["h0"] - nh)][i]

    return _mosaic_grid(images, labels_list, imgsz, corner, extras)


def mosaic9(images: list, labels_list: list, imgsz: int, extras: list | None = None):
    """Nine images: the first in the centre, eight around it clockwise from
    the top, each aligned to the tile placed before it -> a 2s x 2s canvas
    and its labels. Draws nothing."""
    s = imgsz
    st = {}

    def corner(i, nw, nh):
        if i == 0:
            st["h0"], st["w0"] = nh, nw
        h0, w0, hp, wp = st["h0"], st["w0"], st.get("hp", 0), st.get("wp", 0)
        st["hp"], st["wp"] = nh, nw
        return [(s, s), (s, s - nh), (s + wp, s - nh), (s + w0, s), (s + w0, s + hp),
                (s + w0 - nw, s + h0), (s + w0 - wp - nw, s + h0), (s - nw, s + h0 - nh),
                (s - nw, s + h0 - hp - nh)][i]

    return _mosaic_grid(images, labels_list, imgsz, corner, extras)


def mixup(img1, labels1, img2, labels2, rng: np.random.Generator | None = None):
    """Beta(32, 32) blend of two images; their labels concatenated."""
    rng = rng or np.random.default_rng()
    r = rng.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * r + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
    return img, np.concatenate([labels1, labels2], 0)


def _ioa_rows(boxes: np.ndarray, others: np.ndarray) -> np.ndarray:
    """Intersection of each box (n, 4) xyxy with each of ``others`` (m, 4)
    over the box's own area -> (n, m)."""
    x1 = np.maximum(boxes[:, 0:1], others[None, :, 0])
    y1 = np.maximum(boxes[:, 1:2], others[None, :, 1])
    x2 = np.minimum(boxes[:, 2:3], others[None, :, 2])
    y2 = np.minimum(boxes[:, 3:4], others[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = np.clip((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), 1e-6, None)
    return inter / area[:, None]


def copy_paste_mix(img: np.ndarray, labels: np.ndarray, segments: list, img2: np.ndarray,
                   labels2: np.ndarray, segments2: list, p: float = 0.5):
    """Copy-paste, "mixup" mode: instances of a second image (resized to
    this one's shape) pasted onto it, their pixels masked by their
    polygons (``imgproc.fill_poly_cv``): those whose boxes cover under 0.3
    of their area with every existing box, the least overlapping
    ``round(p * n)`` of them. Draws nothing."""
    if not len(labels2) or not segments2 or p <= 0:
        return img, labels, segments
    h, w = img.shape[:2]
    h2, w2 = img2.shape[:2]
    if (h2, w2) != (h, w):
        sx, sy = w / w2, h / h2
        img2 = ip.resize(img2, (w, h))
        labels2 = labels2.copy()
        labels2[:, [1, 3]] *= sx
        labels2[:, [2, 4]] *= sy
        segments2 = [np.stack([pg[:, 0] * sx, pg[:, 1] * sy], -1) for pg in segments2]
    if len(labels):
        ioa = _ioa_rows(labels2[:, 1:5], labels[:, 1:5])
        eligible = np.nonzero((ioa < 0.30).all(1))[0]
        eligible = eligible[np.argsort(ioa.max(1)[eligible])]
    else:
        eligible = np.arange(len(labels2))
    take = eligible[:round(p * len(eligible))]
    if not len(take):
        return img, labels, segments
    mask = np.zeros((h, w), np.uint8)
    for j in take:
        ip.fill_poly_cv(mask, segments2[j].astype(np.int32), 1)
    img = np.where(mask[..., None] > 0, img2, img)
    labels = np.concatenate([labels, labels2[take]], 0) if len(labels) else labels2[take]
    return img, labels, list(segments) + [segments2[j] for j in take]


def copy_paste_flip(img: np.ndarray, labels: np.ndarray, segments: list, p: float = 0.5,
                    rng: np.random.Generator | None = None):
    """Copy-paste, "flip" mode: ``max(1, round(p * n))`` instances, drawn by
    a permutation, pasted left-right mirrored where the mirrored box covers
    at most 0.3 of its area with every existing box."""
    rng = rng or np.random.default_rng()
    if not len(labels) or p <= 0:
        return img, labels, segments
    h, w = img.shape[:2]
    n = max(1, round(len(labels) * p))
    new_labels, new_segments = [], []
    mirrored = img[:, ::-1]
    for i in rng.permutation(len(labels))[:n]:
        box = labels[i, 1:5]
        fbox = np.asarray([w - box[2], box[1], w - box[0], box[3]], np.float32)
        if _ioa_rows(fbox[None], labels[:, 1:5]).max() > 0.3:
            continue
        fpoly = np.stack([w - segments[i][:, 0], segments[i][:, 1]], -1)
        mask = np.zeros((h, w), np.uint8)
        ip.fill_poly_cv(mask, fpoly.astype(np.int32), 1)
        img = np.where(mask[..., None] > 0, mirrored, img)
        new_labels.append(np.concatenate([[labels[i, 0]], fbox]))
        new_segments.append(fpoly)
    if new_labels:
        labels = np.concatenate([labels, np.stack(new_labels)], 0)
        segments = list(segments) + new_segments
    return img, labels, segments
