"""The train pipeline on the host: mosaic, random perspective, mixup,
copy-paste, HSV and flip, and the letterbox of the eval path, in numpy on
``data.imgproc``; and the classify transforms.

Port of ``letterbox``, ``random_hsv``, ``random_flip``,
``random_perspective``, ``_box_candidates``, ``mosaic4``, ``mixup``,
``mosaic4_points`` / ``mosaic3_points`` / ``mosaic9_points`` (``mosaic4``,
``mosaic3``, ``mosaic9`` given ``extras``), ``_shift_points``,
``_cat_extras``, ``copy_paste_flip`` and ``copy_paste_mix`` in
``xlstm_yolo_tpu/data/augment.py``, and of its classify transforms:
``classify_eval_transform``, ``random_resized_crop``, the RandAugment op
space (``_rand_augment_op`` over ``RA_OPS``), ``rand_augment``,
``augmix``, ``autoaugment_imagenet``, ``random_erasing``,
``color_jitter`` and ``classify_train_transform``, equal to the JAX ones
(on cv2) to the level. The point tasks' annotations ride in
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


# ---------------------------------------------------------------------------
# the classify transforms: uint8 RGB (H, W, 3) in and out, normalized later
# ---------------------------------------------------------------------------

def classify_eval_transform(img: np.ndarray, size: int, crop_fraction: float = 1.0) -> np.ndarray:
    """Resize the short edge to ``size / crop_fraction`` (aspect kept),
    then centre-crop ``size`` x ``size``."""
    h, w = img.shape[:2]
    scale_size = math.floor(size / crop_fraction)
    r = scale_size / min(h, w)
    nh, nw = max(scale_size, int(round(h * r))), max(scale_size, int(round(w * r)))
    img = ip.resize(img, (nw, nh))
    y0, x0 = (nh - size) // 2, (nw - size) // 2
    return np.ascontiguousarray(img[y0: y0 + size, x0: x0 + size])


def random_resized_crop(img: np.ndarray, size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                        rng: np.random.Generator | None = None) -> np.ndarray:
    """torchvision's ``RandomResizedCrop``: 10 attempts at an area drawn in
    ``scale`` times the image's and a log-uniform aspect in ``ratio``, else
    the largest centre crop whose aspect ``ratio`` allows; resized to
    ``size`` x ``size``."""
    rng = rng or np.random.default_rng()
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return ip.resize(np.ascontiguousarray(img[y0: y0 + ch, x0: x0 + cw]), (size, size))
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return ip.resize(np.ascontiguousarray(img[y0: y0 + ch, x0: x0 + cw]), (size, size))


def _blend(img1: np.ndarray, img2: np.ndarray, factor: float) -> np.ndarray:
    """PIL's enhance blend, img2 + factor (img1 - img2) in fp32, clipped and
    truncated to uint8."""
    out = img2.astype(np.float32) + factor * (img1.astype(np.float32) - img2.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


def _autocontrast(img: np.ndarray) -> np.ndarray:
    """Each channel stretched from its own min and max to 0-255."""
    out = img.copy()
    for c in range(img.shape[2]):
        ch = img[..., c]
        lo, hi = int(ch.min()), int(ch.max())
        if hi > lo:
            lut = np.clip((np.arange(256, dtype=np.float32) - lo) * (255.0 / (hi - lo)), 0, 255)
            out[..., c] = lut.astype(np.uint8)[ch]
    return out


def _equalize(img: np.ndarray) -> np.ndarray:
    return np.stack([ip.equalize_hist(img[..., c]) for c in range(img.shape[2])], -1)


def _rand_augment_op(img: np.ndarray, op: str, mag: float, rng) -> np.ndarray:
    """One RandAugment op at magnitude ``mag`` in [0, 1] of its maximum,
    its sign drawn first (even for the ops that ignore it, so that every
    later draw stays in step)."""
    h, w = img.shape[:2]
    sign = -1.0 if rng.random() < 0.5 else 1.0
    if op == "Identity":
        return img
    if op in ("ShearX", "ShearY"):
        s = sign * mag * 0.3
        M = np.float32([[1, s if op == "ShearX" else 0, 0], [s if op == "ShearY" else 0, 1, 0]])
        return ip.warp_affine(img, M, (w, h))
    if op in ("TranslateX", "TranslateY"):
        t = sign * mag * 150.0 / 331.0 * (w if op == "TranslateX" else h)
        M = np.float32([[1, 0, t if op == "TranslateX" else 0],
                        [0, 1, t if op == "TranslateY" else 0]])
        return ip.warp_affine(img, M, (w, h))
    if op == "Rotate":
        return ip.warp_affine(img, ip.rotation_matrix_2d((w / 2, h / 2), sign * mag * 30.0), (w, h))
    if op == "Brightness":
        return _blend(img, np.zeros_like(img), 1.0 + sign * mag * 0.9)
    if op == "Color":
        return _blend(img, ip.rgb2gray(img)[..., None].repeat(3, -1), 1.0 + sign * mag * 0.9)
    if op == "Contrast":
        mean = np.full_like(img, int(ip.rgb2gray(img).mean()))
        return _blend(img, mean, 1.0 + sign * mag * 0.9)
    if op == "Sharpness":
        return _blend(img, ip.gaussian_blur3(img), 1.0 + sign * mag * 0.9)
    if op == "Posterize":
        bits = 8 - int(round(mag * 4))
        lut = (np.arange(256, dtype=np.uint8) >> (8 - bits)) << (8 - bits)
        return lut[img]
    if op == "Solarize":
        thr = 255.0 - mag * 255.0
        return np.where(img >= thr, 255 - img, img)
    if op == "AutoContrast":
        return _autocontrast(img)
    if op == "Equalize":
        return _equalize(img)
    return img


RA_OPS = ("Identity", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate", "Brightness",
          "Color", "Contrast", "Sharpness", "Posterize", "Solarize", "AutoContrast", "Equalize")


def rand_augment(img: np.ndarray, rng: np.random.Generator | None = None, num_ops: int = 2,
                 magnitude: int = 9) -> np.ndarray:
    """RandAugment: ``num_ops`` ops drawn from RA_OPS at ``magnitude`` of
    30 (torchvision's defaults, 2 and 9)."""
    rng = rng or np.random.default_rng()
    mag = magnitude / 30.0
    for _ in range(num_ops):
        img = _rand_augment_op(img, RA_OPS[int(rng.integers(len(RA_OPS)))], mag, rng)
    return img


def augmix(img: np.ndarray, rng: np.random.Generator | None = None, severity: int = 3,
           mixture_width: int = 3, alpha: float = 1.0) -> np.ndarray:
    """AugMix: ``mixture_width`` chains of 1-3 ops (RA_OPS but Identity)
    mixed with Dirichlet weights, then blended with the image by a Beta
    weight."""
    rng = rng or np.random.default_rng()
    ws = rng.dirichlet([alpha] * mixture_width).astype(np.float32)
    m = float(rng.beta(alpha, alpha))
    mag = severity / 10.0
    mix = np.zeros(img.shape, np.float32)
    ops = [o for o in RA_OPS if o != "Identity"]
    for i in range(mixture_width):
        aug = img.copy()
        for _ in range(int(rng.integers(1, 4))):
            aug = _rand_augment_op(aug, ops[int(rng.integers(len(ops)))], mag, rng)
        mix += ws[i] * aug.astype(np.float32)
    out = (1 - m) * img.astype(np.float32) + m * mix
    return np.clip(out, 0, 255).astype(np.uint8)


# (op, probability, magnitude) pairs of the AutoAugment ImageNet policy, the
# JAX package's subset
_AA_POLICY = [
    (("Posterize", 0.4, 8 / 10), ("Rotate", 0.6, 9 / 10)),
    (("Solarize", 0.6, 5 / 10), ("AutoContrast", 0.6, 0)),
    (("Equalize", 0.8, 0), ("Equalize", 0.6, 0)),
    (("Posterize", 0.6, 7 / 10), ("Posterize", 0.6, 6 / 10)),
    (("Equalize", 0.4, 0), ("Solarize", 0.2, 4 / 10)),
    (("Equalize", 0.4, 0), ("Rotate", 0.8, 8 / 10)),
    (("Solarize", 0.6, 3 / 10), ("Equalize", 0.6, 0)),
    (("Posterize", 0.8, 5 / 10), ("Equalize", 1.0, 0)),
    (("Rotate", 0.2, 3 / 10), ("Solarize", 0.6, 8 / 10)),
    (("Equalize", 0.6, 0), ("Posterize", 0.4, 6 / 10)),
    (("Rotate", 0.8, 8 / 10), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9 / 10), ("Equalize", 0.6, 0)),
    (("Equalize", 0.0, 0), ("Equalize", 0.8, 0)),
    (("Color", 0.6, 4 / 10), ("Contrast", 1.0, 8 / 10)),
    (("Color", 0.8, 8 / 10), ("Solarize", 0.8, 7 / 10)),
    (("Sharpness", 0.4, 7 / 10), ("Invert", 0.6, 0)),
    (("ShearX", 0.6, 5 / 10), ("Equalize", 1.0, 0)),
    (("Color", 0.4, 0), ("Equalize", 0.6, 0)),
]


def autoaugment_imagenet(img: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
    """AutoAugment's ImageNet policy: one drawn sub-policy, each of its two
    ops applied with its probability."""
    rng = rng or np.random.default_rng()
    for op, p, mag in _AA_POLICY[int(rng.integers(len(_AA_POLICY)))]:
        if rng.random() < p:
            img = 255 - img if op == "Invert" else _rand_augment_op(img, op, mag, rng)
    return img


def random_erasing(img: np.ndarray, p: float = 0.4, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """RandomErasing with probability ``p``: a drawn rectangle filled with
    the ImageNet mean (124, 116, 104), on uint8 before normalization."""
    rng = rng or np.random.default_rng()
    if rng.random() >= p:
        return img
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        eh = int(round(math.sqrt(target / ar)))
        ew = int(round(math.sqrt(target * ar)))
        if eh < h and ew < w:
            y0 = int(rng.integers(0, h - eh + 1))
            x0 = int(rng.integers(0, w - ew + 1))
            img = img.copy()
            img[y0: y0 + eh, x0: x0 + ew] = (124, 116, 104)
            return img
    return img


def color_jitter(img: np.ndarray, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, hue: float = 0.015,
                 rng: np.random.Generator | None = None) -> np.ndarray:
    """torchvision's ``ColorJitter``: brightness, contrast and saturation
    blends and a hue shift (on cv2's HSV), in a drawn order."""
    rng = rng or np.random.default_rng()
    for t in rng.permutation(4):
        if t == 0 and brightness > 0:
            img = _blend(img, np.zeros_like(img),
                         rng.uniform(max(0, 1 - brightness), 1 + brightness))
        elif t == 1 and contrast > 0:
            mean = np.full_like(img, int(ip.rgb2gray(img).mean()))
            img = _blend(img, mean, rng.uniform(max(0, 1 - contrast), 1 + contrast))
        elif t == 2 and saturation > 0:
            gray = ip.rgb2gray(img)[..., None].repeat(3, -1)
            img = _blend(img, gray, rng.uniform(max(0, 1 - saturation), 1 + saturation))
        elif t == 3 and hue > 0:
            hsv = ip.rgb2hsv(img)
            shift = rng.uniform(-hue, hue) * 180
            hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(shift)) % 180
            img = ip.hsv2rgb(hsv)
    return img


def classify_train_transform(img: np.ndarray, size: int, rng: np.random.Generator,
                             scale=(0.08, 1.0), hflip: float = 0.5, vflip: float = 0.0,
                             auto_augment: str | None = "randaugment", hsv_h: float = 0.015,
                             hsv_s: float = 0.4, hsv_v: float = 0.4, erasing: float = 0.0,
                             force_color_jitter: bool = False) -> np.ndarray:
    """RandomResizedCrop, the flips, the ``auto_augment`` policy
    (randaugment, augmix, autoaugment; color jitter from the HSV gains when
    there is none), then RandomErasing."""
    img = random_resized_crop(img, size, scale=scale, rng=rng)
    if hflip > 0 and rng.random() < hflip:
        img = np.ascontiguousarray(img[:, ::-1])
    if vflip > 0 and rng.random() < vflip:
        img = np.ascontiguousarray(img[::-1])
    if auto_augment == "randaugment":
        img = rand_augment(img, rng)
    elif auto_augment == "augmix":
        img = augmix(img, rng)
    elif auto_augment == "autoaugment":
        img = autoaugment_imagenet(img, rng)
    if force_color_jitter or not auto_augment:
        img = color_jitter(img, brightness=hsv_v, contrast=hsv_v, saturation=hsv_s, hue=hsv_h,
                           rng=rng)
    if erasing > 0:
        img = random_erasing(img, p=erasing, rng=rng)
    return img
