"""Anchor-free detect heads and their decode.

Port of ``Detect``, ``v10Detect``, ``split_maps``, ``decode_detections``
and ``v10_postprocess`` in ``xlstm_yolo_tpu/nn/heads.py``. A head emits,
per scale (any number of taps), separate box (B, 4*reg_max, H, W) and
class (B, nc, H, W) maps; decoding to (B, N, 4 + nc) pixel xywh boxes
plus sigmoid scores is a standalone function, with anchors in row-major
(H, W) order per scale. In train mode the head's output is the same list
of raw maps; ``split_maps`` flattens it for the loss
(``utils.loss.detection_loss``) as for the decode. ``v10Detect`` returns a
dict of two such lists (``one2one``, and in train mode ``one2many``);
``det_maps`` picks the list that inference decodes.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from ..ops.anchors import dfl_decode, dist2bbox, make_anchors
from ..ops.boxes import xywh2xyxy
from .modules import ConvBN, conv_in_dtype, lecun_normal_


class Detect(nn.Module):
    """Decoupled detect head. Box branch: two 3x3 ConvBNs, then a 1x1 conv.
    Class branch, ``legacy`` (the v8 form): two 3x3 ConvBNs, then a 1x1
    conv; ``legacy=False`` (YOLO11 and 12): a depthwise 3x3 ConvBN and a
    1x1 ConvBN, twice (``cv3_{i}_{j}_0``, ``cv3_{i}_{j}_1``), then the 1x1
    conv. Returns a list of (box_map, cls_map) pairs, in the input's
    dtype."""

    def __init__(self, nc: int = 80, ch: tuple = (), reg_max: int = 16,
                 strides: tuple = (8, 16, 32), legacy: bool = True):
        super().__init__()
        self.nc, self.reg_max, self.nl, self.legacy = nc, reg_max, len(ch), legacy
        self.strides = strides  # used only for the class-bias init
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        for i, c in enumerate(ch):
            setattr(self, f"cv2_{i}_0", ConvBN(c, c2, 3))
            setattr(self, f"cv2_{i}_1", ConvBN(c2, c2, 3))
            setattr(self, f"cv2_{i}_2", nn.Conv2d(c2, 4 * reg_max, 1))
            if legacy:
                setattr(self, f"cv3_{i}_0", ConvBN(c, c3, 3))
                setattr(self, f"cv3_{i}_1", ConvBN(c3, c3, 3))
            else:
                for j, cin in enumerate((c, c3)):
                    setattr(self, f"cv3_{i}_{j}_0", ConvBN(cin, cin, 3, g=cin))
                    setattr(self, f"cv3_{i}_{j}_1", ConvBN(cin, c3, 1))
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
                if self.legacy:
                    c = getattr(self, f"cv3_{i}_{j}")(c)
                else:
                    c = getattr(self, f"cv3_{i}_{j}_1")(getattr(self, f"cv3_{i}_{j}_0")(c))
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


class v10Detect(nn.Module):
    """YOLOv10's end-to-end head: two branches of the same shape, ``one2one``
    (top-1 assignment) and ``one2many`` (the usual top-10), each per scale
    two 3x3 ConvBNs and a 1x1 conv for the box, and a depthwise 3x3 + 1x1
    ConvBN pair twice and a 1x1 conv for the class. Both branches'
    parameters always exist; eval computes ``one2one`` only, train both,
    each from the same (undetached) features, as the JAX head does."""

    def __init__(self, nc: int = 80, ch: tuple = (), reg_max: int = 16,
                 strides: tuple = (8, 16, 32)):
        super().__init__()
        self.nc, self.reg_max, self.nl = nc, reg_max, len(ch)
        self.strides = strides  # used only for the class-bias init
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        for tag in ("one2one", "one2many"):
            for i, c in enumerate(ch):
                b, k = f"{tag}_cv2_{i}", f"{tag}_cv3_{i}"
                setattr(self, f"{b}_0", ConvBN(c, c2, 3))
                setattr(self, f"{b}_1", ConvBN(c2, c2, 3))
                setattr(self, f"{b}_2", nn.Conv2d(c2, 4 * reg_max, 1))
                setattr(self, f"{k}_0dw", ConvBN(c, c, 3, g=c))
                setattr(self, f"{k}_0pw", ConvBN(c, c3, 1))
                setattr(self, f"{k}_1dw", ConvBN(c3, c3, 3, g=c3))
                setattr(self, f"{k}_1pw", ConvBN(c3, c3, 1))
                setattr(self, f"{k}_2", nn.Conv2d(c3, nc, 1))

    def init_params(self, g: torch.Generator) -> None:
        for tag in ("one2one", "one2many"):
            for i in range(self.nl):
                s = self.strides[i] if i < len(self.strides) else 8 * 2**i
                box, cls = getattr(self, f"{tag}_cv2_{i}_2"), getattr(self, f"{tag}_cv3_{i}_2")
                lecun_normal_(box.weight, g)
                lecun_normal_(cls.weight, g)
                nn.init.ones_(box.bias)
                nn.init.constant_(cls.bias, math.log(5 / self.nc / (640 / s) ** 2))

    def branch(self, feats: Sequence[torch.Tensor], tag: str):
        outs = []
        for i, x in enumerate(feats):
            b, k = f"{tag}_cv2_{i}", f"{tag}_cv3_{i}"
            bm = getattr(self, f"{b}_1")(getattr(self, f"{b}_0")(x))
            c = x
            for part in ("0dw", "0pw", "1dw", "1pw"):
                c = getattr(self, f"{k}_{part}")(c)
            outs.append((conv_in_dtype(getattr(self, f"{b}_2"), bm),
                         conv_in_dtype(getattr(self, f"{k}_2"), c)))
        return outs

    def forward(self, feats: Sequence[torch.Tensor]):
        out = {"one2one": self.branch(feats, "one2one")}
        if self.training:
            out["one2many"] = self.branch(feats, "one2many")
        return out


def det_maps(out):
    """A head's output -> the per-scale (box, cls) maps that inference
    decodes: ``one2one`` of an end-to-end head's dict, else the list."""
    return out["one2one"] if isinstance(out, dict) else out


def v10_postprocess(cands: torch.Tensor, max_det: int = 300) -> torch.Tensor:
    """NMS-free top-k over (anchor, class) pairs: (B, N, 4 + nc) xywh +
    scores -> (B, min(max_det, N * nc), 6) xyxy, score, class, best
    first."""
    b, n, no = cands.shape
    nc = no - 4
    topv, topi = torch.topk(cands[..., 4:].reshape(b, n * nc), min(max_det, n * nc), dim=-1)
    anchor = topi // nc
    boxes = cands[..., :4].gather(1, anchor[..., None].expand(-1, -1, 4))
    return torch.cat([xywh2xyxy(boxes), topv[..., None], (topi % nc).to(cands.dtype)[..., None]],
                     dim=-1)
