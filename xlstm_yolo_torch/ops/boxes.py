"""Box geometry: format conversion, pairwise IoU and letterbox un-mapping.

Port of ``xywh2xyxy``, ``xyxy2xywh``, ``xywhn2xyxy``, ``xyxy2xywhn``,
``ltwh2xyxy``, ``xyxy2ltwh``, ``clip_boxes``, ``scale_boxes``, ``box_iou``
and ``bbox_iou`` in ``xlstm_yolo_tpu/ops/boxes.py``. The format conversions
take torch tensors and numpy arrays alike and return the same kind.
"""
from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-7


def _cols(x):
    return [x[..., i] for i in range(4)]


def _stack(cols, like):
    return torch.stack(cols, dim=-1) if isinstance(like, torch.Tensor) else np.stack(cols, axis=-1)


def xywh2xyxy(x):
    """(cx, cy, w, h) -> (x1, y1, x2, y2) on the last axis."""
    cx, cy, w, h = _cols(x)
    hw, hh = w * 0.5, h * 0.5
    return _stack([cx - hw, cy - hh, cx + hw, cy + hh], x)


def xyxy2xywh(x):
    """(x1, y1, x2, y2) -> (cx, cy, w, h) on the last axis."""
    x1, y1, x2, y2 = _cols(x)
    return _stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], x)


def xywhn2xyxy(x, w: float, h: float, padw: float = 0.0, padh: float = 0.0):
    """Normalized (cx, cy, w, h) -> pixel (x1, y1, x2, y2) plus the padding."""
    cx, cy, bw, bh = _cols(x)
    return xywh2xyxy(_stack([cx * w, cy * h, bw * w, bh * h], x)) + _pad(x, padw, padh)


def xyxy2xywhn(x, w: float, h: float):
    """Pixel (x1, y1, x2, y2) -> normalized (cx, cy, w, h)."""
    cx, cy, bw, bh = _cols(xyxy2xywh(x))
    return _stack([cx / w, cy / h, bw / w, bh / h], x)


def ltwh2xyxy(x):
    """(left, top, w, h) -> (x1, y1, x2, y2)."""
    l, t, w, h = _cols(x)
    return _stack([l, t, l + w, t + h], x)


def xyxy2ltwh(x):
    """(x1, y1, x2, y2) -> (left, top, w, h)."""
    x1, y1, x2, y2 = _cols(x)
    return _stack([x1, y1, x2 - x1, y2 - y1], x)


def _pad(x, padw: float, padh: float):
    vals = [padw, padh, padw, padh]
    if isinstance(x, torch.Tensor):
        return torch.tensor(vals, dtype=x.dtype, device=x.device)
    return np.asarray(vals, dtype=x.dtype)


def clip_boxes(boxes: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Clip xyxy boxes to an image of shape (h, w)."""
    h, w = shape
    hi = torch.tensor([w, h, w, h], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(boxes.clamp(min=0), hi)


def scale_boxes(boxes: torch.Tensor, from_shape: tuple[int, int], to_shape: tuple[int, int],
                padded: bool = True, ratio_pad: tuple | None = None) -> torch.Tensor:
    """Rescale xyxy boxes from a letterboxed ``from_shape`` back to
    ``to_shape``: remove the centered padding, divide by the gain, clip.
    ``ratio_pad`` = (gain, (pad_w, pad_h)) gives the letterbox's own gain and
    padding (the reference's argument of that name) instead of the ones
    derived from the shapes, whose padding can round a pixel the other way."""
    gain = min(from_shape[0] / to_shape[0], from_shape[1] / to_shape[1])
    pad_w = round((from_shape[1] - to_shape[1] * gain) / 2 - 0.1)
    pad_h = round((from_shape[0] - to_shape[0] * gain) / 2 - 0.1)
    if ratio_pad is not None:
        gain, (pad_w, pad_h) = ratio_pad
    if padded:
        boxes = boxes - torch.tensor([pad_w, pad_h, pad_w, pad_h], dtype=boxes.dtype,
                                     device=boxes.device)
    return clip_boxes(boxes / gain, to_shape)


def box_iou(a: torch.Tensor, b: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Pairwise IoU of (..., M, 4) and (..., N, 4) xyxy boxes -> (..., M, N)."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + eps)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Elementwise CIoU of broadcastable (..., 4) xyxy boxes -> (...): the
    JAX ``bbox_iou(..., xywh=False, CIoU=True)``, the form the loss and the
    assigner use. The IoU minus the center-distance and aspect-ratio
    penalties; the trade-off weight alpha carries no gradient, as in the
    reference."""
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
    w1, h1 = b1x2 - b1x1, (b1y2 - b1y1) + eps
    w2, h2 = b2x2 - b2x1, (b2y2 - b2y1) + eps
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)
