"""Anchor-free detect head and its decode.

Port of ``Detect``, ``split_maps`` and ``decode_detections`` in
``xlstm_yolo_tpu/nn/heads.py``. The head emits, per scale, separate box
(B, 4*reg_max, H, W) and class (B, nc, H, W) maps; decoding to
(B, N, 4 + nc) pixel xywh boxes plus sigmoid scores is a standalone
function, with anchors in row-major (H, W) order per scale. In train mode
the head's output is the same list of raw maps; ``split_maps`` flattens it
for the loss (``utils.loss.detection_loss``) as for the decode.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from ..ops.anchors import dfl_decode, dist2bbox, make_anchors
from .modules import ConvBN, conv_in_dtype, lecun_normal_


class Detect(nn.Module):
    """Decoupled detect head (legacy v8 form: two 3x3 ConvBNs then a 1x1
    conv in each of the box and class branches). Returns a list of
    (box_map, cls_map) pairs, in the input's dtype."""

    def __init__(self, nc: int = 80, ch: tuple = (), reg_max: int = 16,
                 strides: tuple = (8, 16, 32)):
        super().__init__()
        self.nc, self.reg_max, self.nl = nc, reg_max, len(ch)
        self.strides = strides  # used only for the class-bias init
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        for i, c in enumerate(ch):
            setattr(self, f"cv2_{i}_0", ConvBN(c, c2, 3))
            setattr(self, f"cv2_{i}_1", ConvBN(c2, c2, 3))
            setattr(self, f"cv2_{i}_2", nn.Conv2d(c2, 4 * reg_max, 1))
            setattr(self, f"cv3_{i}_0", ConvBN(c, c3, 3))
            setattr(self, f"cv3_{i}_1", ConvBN(c3, c3, 3))
            setattr(self, f"cv3_{i}_2", nn.Conv2d(c3, nc, 1))

    def init_params(self, g: torch.Generator) -> None:
        for i in range(self.nl):
            s = self.strides[i] if i < len(self.strides) else 8 * 2**i
            box, cls = getattr(self, f"cv2_{i}_2"), getattr(self, f"cv3_{i}_2")
            lecun_normal_(box.weight, g)
            lecun_normal_(cls.weight, g)
            nn.init.ones_(box.bias)
            nn.init.constant_(cls.bias, math.log(5 / self.nc / (640 / s) ** 2))

    def forward(self, feats: Sequence[torch.Tensor]):
        outs = []
        for i, x in enumerate(feats):
            b = x
            c = x
            for j in range(2):
                b = getattr(self, f"cv2_{i}_{j}")(b)
                c = getattr(self, f"cv3_{i}_{j}")(c)
            outs.append((conv_in_dtype(getattr(self, f"cv2_{i}_2"), b),
                         conv_in_dtype(getattr(self, f"cv3_{i}_2"), c)))
        return outs


def _flat(m: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), row-major tokens."""
    return m.flatten(2).transpose(1, 2)


def split_maps(raw_maps: Sequence, reg_max: int = 16):
    """Per-scale (box_map, cls_map) pairs -> (dist (B, N, 4*reg_max),
    cls (B, N, nc))."""
    dist = torch.cat([_flat(bm) for bm, _ in raw_maps], dim=1)
    cls = torch.cat([_flat(cm) for _, cm in raw_maps], dim=1)
    return dist, cls


def decode_detections(raw_maps: Sequence, strides: Sequence[float], nc: int,
                      reg_max: int = 16) -> torch.Tensor:
    """Raw per-scale maps -> (B, N, 4 + nc): xywh pixel boxes + sigmoid
    scores (DFL integral decode around the anchor grid, times stride),
    fp32 whatever the maps' dtype (the class sigmoid in fp32, as JAX)."""
    feat_shapes = [tuple(bm.shape[2:4]) for bm, _ in raw_maps]
    ref = raw_maps[0][0]
    anchors, stride_t = make_anchors(feat_shapes, strides, device=ref.device)
    box_logits, cls_logits = split_maps(raw_maps, reg_max)
    boxes = dist2bbox(dfl_decode(box_logits, reg_max), anchors, xywh=True) * stride_t
    return torch.cat([boxes, torch.sigmoid(cls_logits.float())], dim=-1)
