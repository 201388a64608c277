"""Anchor-free detect heads, the segment, pose and OBB heads, and their
decode.

Port of ``Detect``, ``Segment``, ``Pose``, ``OBB``, ``v10Detect``,
``split_maps``, ``decode_detections``, ``decode_obb``, ``decode_keypoints``
and ``v10_postprocess`` in ``xlstm_yolo_tpu/nn/heads.py``. A head emits,
per scale (any number of taps), separate box (B, 4*reg_max, H, W) and
class (B, nc, H, W) maps; decoding to (B, N, 4 + nc) pixel xywh boxes
plus sigmoid scores is a standalone function, with anchors in row-major
(H, W) order per scale. In train mode the head's output is the same list
of raw maps; ``split_maps`` flattens it for the loss
(``utils.loss.detection_loss``) as for the decode. ``v10Detect`` returns a
dict of two such lists (``one2one``, and in train mode ``one2many``);
``det_maps`` picks the list that inference decodes. ``Segment``, ``Pose``
and ``OBB`` hold a ``Detect`` named ``detect`` and return a dict: ``det``
(its maps) and per scale ``coefs`` (mask coefficients, with the prototype
map ``proto``), ``kpts`` (keypoint maps) or ``angle`` (angle logits).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.anchors import dfl_decode, dist2bbox, dist2rbox, make_anchors
from ..ops.boxes import xywh2xyxy
from ..utils import at_least_fp32
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


def _add_cv4(head: nn.Module, ch: tuple, c4: int, nout: int) -> None:
    """The task heads' extra branch, per scale: two 3x3 ConvBNs of ``c4``
    channels and a 1x1 conv with a bias to ``nout``, ``cv4_{i}_{0,1,2}`` as
    in the JAX heads."""
    for i, c in enumerate(ch):
        setattr(head, f"cv4_{i}_0", ConvBN(c, c4, 3))
        setattr(head, f"cv4_{i}_1", ConvBN(c4, c4, 3))
        setattr(head, f"cv4_{i}_2", nn.Conv2d(c4, nout, 1))


def _init_cv4(head: nn.Module, g: torch.Generator) -> None:
    for i in range(head.nl):
        conv = getattr(head, f"cv4_{i}_2")
        lecun_normal_(conv.weight, g)
        nn.init.zeros_(conv.bias)


def _run_cv4(head: nn.Module, feats: Sequence[torch.Tensor]) -> list:
    return [conv_in_dtype(getattr(head, f"cv4_{i}_2"),
                          getattr(head, f"cv4_{i}_1")(getattr(head, f"cv4_{i}_0")(x)))
            for i, x in enumerate(feats)]


class Segment(nn.Module):
    """Detect + per-scale mask coefficients (``nm``) + the prototype net on
    the first tap: a 3x3 ConvBN of ``npr`` channels, a learned 2x
    upsample (``proto_up``: a 2x2 transposed conv of stride 2 with a bias,
    flax's ``ConvTranspose``, no BatchNorm), a 3x3 ConvBN and a 1x1 ConvBN
    to ``nm``. Returns {"det", "coefs", "proto"}."""

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256, ch: tuple = (),
                 reg_max: int = 16, strides: tuple = (8, 16, 32), legacy: bool = True):
        super().__init__()
        self.nc, self.nm, self.npr, self.nl = nc, nm, npr, len(ch)
        self.detect = Detect(nc, ch, reg_max, strides, legacy=legacy)
        self.proto_cv1 = ConvBN(ch[0], npr, 3)
        self.proto_up = nn.ConvTranspose2d(npr, npr, 2, 2, bias=True)
        self.proto_cv2 = ConvBN(npr, npr, 3)
        self.proto_cv3 = ConvBN(npr, nm, 1)
        _add_cv4(self, ch, max(ch[0] // 4, nm), nm)

    def init_params(self, g: torch.Generator) -> None:
        w = self.proto_up.weight  # (in, out, kh, kw): flax's fan-in is in * kh * kw
        std = math.sqrt(1.0 / (w.shape[0] * w[0, 0].numel())) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
        nn.init.zeros_(self.proto_up.bias)
        _init_cv4(self, g)

    def forward(self, feats: Sequence[torch.Tensor]):
        det = self.detect(feats)
        p = self.proto_cv1(feats[0])
        up = self.proto_up
        p = F.conv_transpose2d(p, up.weight.to(p.dtype), up.bias.to(p.dtype), up.stride)
        proto = self.proto_cv3(self.proto_cv2(p))
        return {"det": det, "coefs": _run_cv4(self, feats), "proto": proto}


class Pose(nn.Module):
    """Detect + per-scale keypoint maps of ``kpt_shape[0] * kpt_shape[1]``
    channels. Returns {"det", "kpts"}."""

    def __init__(self, nc: int = 1, kpt_shape: tuple = (17, 3), ch: tuple = (),
                 reg_max: int = 16, strides: tuple = (8, 16, 32), legacy: bool = True):
        super().__init__()
        self.nc, self.kpt_shape, self.nl = nc, tuple(kpt_shape), len(ch)
        self.detect = Detect(nc, ch, reg_max, strides, legacy=legacy)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        _add_cv4(self, ch, max(ch[0] // 4, nk), nk)

    def init_params(self, g: torch.Generator) -> None:
        _init_cv4(self, g)

    def forward(self, feats: Sequence[torch.Tensor]):
        return {"det": self.detect(feats), "kpts": _run_cv4(self, feats)}


class OBB(nn.Module):
    """Detect + per-scale angle logits (``ne`` channels). Returns {"det",
    "angle"}."""

    def __init__(self, nc: int = 15, ne: int = 1, ch: tuple = (), reg_max: int = 16,
                 strides: tuple = (8, 16, 32), legacy: bool = True):
        super().__init__()
        self.nc, self.ne, self.nl = nc, ne, len(ch)
        self.detect = Detect(nc, ch, reg_max, strides, legacy=legacy)
        _add_cv4(self, ch, max(ch[0] // 4, ne), ne)

    def init_params(self, g: torch.Generator) -> None:
        _init_cv4(self, g)

    def forward(self, feats: Sequence[torch.Tensor]):
        return {"det": self.detect(feats), "angle": _run_cv4(self, feats)}


def _flat(m: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), row-major tokens."""
    return m.flatten(2).transpose(1, 2)


def flatten_maps(maps: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-scale (B, C, H, W) maps -> (B, sum(H*W), C)."""
    return torch.cat([_flat(m) for m in maps], dim=1)


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


def decode_obb(raw_maps: Sequence, angle_maps: Sequence[torch.Tensor],
               strides: Sequence[float], nc: int, reg_max: int = 16) -> torch.Tensor:
    """OBB decode -> (B, N, 4 + nc + 1): rotated (cx, cy, w, h) in pixels,
    sigmoid scores, and the angle (sigmoid - 0.25) * pi last; fp32."""
    feat_shapes = [tuple(bm.shape[2:4]) for bm, _ in raw_maps]
    anchors, stride_t = make_anchors(feat_shapes, strides, device=raw_maps[0][0].device)
    angle = (torch.sigmoid(at_least_fp32(flatten_maps(angle_maps))) - 0.25) * math.pi
    box_logits, cls_logits = split_maps(raw_maps, reg_max)
    rbox = dist2rbox(dfl_decode(box_logits, reg_max), angle, anchors) * stride_t
    return torch.cat([rbox, torch.sigmoid(cls_logits.float()), angle], dim=-1)


def decode_keypoints(kpt_maps: Sequence[torch.Tensor], strides: Sequence[float],
                     kpt_shape: tuple = (17, 3)) -> torch.Tensor:
    """Keypoint maps -> (B, N, nk * nd) pixel coordinates: (y * 2 + anchor -
    0.5) * stride, and the visibility through a sigmoid when nd is 3."""
    feat_shapes = [tuple(m.shape[2:4]) for m in kpt_maps]
    anchors, stride_t = make_anchors(feat_shapes, strides, device=kpt_maps[0].device)
    y = at_least_fp32(flatten_maps(kpt_maps))
    b, n, _ = y.shape
    nk, nd = kpt_shape
    y = y.reshape(b, n, nk, nd)
    xy = (y[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * stride_t[None, :, None, :]
    if nd == 3:
        xy = torch.cat([xy, torch.sigmoid(y[..., 2:3])], dim=-1)
    return xy.reshape(b, n, nk * nd)


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
    decodes: ``det`` of a task head's dict, ``one2one`` of an end-to-end
    head's, else the list."""
    if isinstance(out, dict):
        return out["det"] if "det" in out else out["one2one"]
    return out


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
