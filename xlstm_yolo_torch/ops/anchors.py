"""Anchor grid and distribution-focal decode.

Port of ``make_anchors``, ``dist2bbox``, ``bbox2dist``, ``dist2rbox`` and
``dfl_decode`` in
``xlstm_yolo_tpu/ops/anchors.py``.
"""
from __future__ import annotations

import torch

from ..utils import at_least_fp32


def make_anchors(feat_shapes, strides, grid_cell_offset: float = 0.5,
                 dtype=torch.float32, device=None):
    """Anchor centers (N, 2) in grid units (x, y) and strides (N, 1) for
    per-scale (h, w) shapes, row-major within each scale."""
    points, stride_t = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=dtype, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        stride_t.append(torch.full((h * w, 1), float(s), dtype=dtype, device=device))
    return torch.cat(points), torch.cat(stride_t)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True,
              dim: int = -1) -> torch.Tensor:
    """(l, t, r, b) distances + anchor centers -> xywh or xyxy boxes."""
    lt, rb = distance.chunk(2, dim=dim)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=dim)
    return torch.cat([x1y1, x2y2], dim=dim)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: float) -> torch.Tensor:
    """xyxy boxes -> (l, t, r, b) distances from the anchor centers, clipped
    to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1).clamp(0, reg_max - 0.01)


def dist2rbox(pred_dist: torch.Tensor, pred_angle: torch.Tensor, anchor_points: torch.Tensor,
              dim: int = -1) -> torch.Tensor:
    """(l, t, r, b) distances, the angle and the anchor centers -> rotated
    boxes (cx, cy, w, h): the centre offset (r - l, b - t) / 2 turned by the
    angle."""
    lt, rb = pred_dist.chunk(2, dim=dim)
    cos, sin = torch.cos(pred_angle), torch.sin(pred_angle)
    xf, yf = ((rb - lt) / 2).chunk(2, dim=dim)
    xy = torch.cat([xf * cos - yf * sin, xf * sin + yf * cos], dim=dim) + anchor_points
    return torch.cat([xy, lt + rb], dim=dim)


def dfl_decode(pred_dist: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """(..., 4*reg_max) logits -> (..., 4) fp32 (fp64 for fp64 logits)
    expected distances: a softmax
    over each side's reg_max bins, dotted with the bin indices. bf16 logits
    take the JAX bf16 path: exp(x - the row's max over all 4*reg_max
    logits) rounded to bf16, then the numerator and denominator sums in
    fp32 (the bf16-operand dots with fp32 accumulation of
    ``ops/anchors.py:dfl_decode``)."""
    if pred_dist.dtype == torch.bfloat16:
        x = pred_dist.float()
        e = torch.exp(x - x.amax(-1, keepdim=True)).bfloat16().float().unflatten(-1, (4, reg_max))
        bins = torch.arange(reg_max, dtype=e.dtype, device=e.device)
        return (e * bins).sum(-1) / e.sum(-1)
    x = at_least_fp32(pred_dist).unflatten(-1, (4, reg_max)).softmax(-1)
    bins = torch.arange(reg_max, dtype=x.dtype, device=x.device)
    return (x * bins).sum(-1)
