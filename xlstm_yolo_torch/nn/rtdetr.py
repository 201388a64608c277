"""RT-DETR, NCHW: the HGNetv2 backbone blocks, the AIFI encoder layer, the
deformable decoder with contrastive denoising, the Hungarian-matched loss
and the NMS-free postprocess.

Port of ``xlstm_yolo_tpu/nn/rtdetr.py``, plain torch (the JAX module is
plain XLA: no kernel of its own). flax's defaults are kept where torch's
differ: LayerNorm eps 1e-6, the tanh GELU, attention projecting q, k and v
to the input width, a boolean mask that means "attend", ``jnp.clip``'s
gradient of one half at either bound (``_clip``, in ``deform_sample``'s
bilinear weights too), and a flax ``Dense``'s
arithmetic: in the input's dtype where the JAX layer names ``dtype``, else
in the promoted dtype of input and parameters (``_dense``). So, as in JAX,
an AMP forward leaves bf16 at AIFI's first LayerNorm, whose output is
fp32, and at the decoder's encoder head.

Discrete choices go through three module functions, so that a caller can
record them or replay another run's (``chip_smoke.SharedChoices``):
``ranked`` (the indices of the k largest entries of each row, the lower
index first among equal values, as ``jax.lax.top_k`` orders them: the
query selection and the postprocess), ``cell`` (the floor of a sampling
coordinate: which four pixels the bilinear sample reads, where its
gradient with respect to the location jumps) and ``hungarian`` (the match
of each ground-truth slot, ``scipy.optimize.linear_sum_assignment`` on the
host, as the JAX loss calls it through ``jax.pure_callback``).

The denoising groups are drawn from a ``torch.Generator`` (``get_cdn_group``);
JAX draws them with ``jax.random``, so the parity tests hand the JAX draws
to the port (``TaskModel.loss``'s ``dn_queries``).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.boxes import bbox_iou_xywh
from ..parallel.distributed import dp_total
from ..utils import at_least_fp32
from .modules import ConvBN, lecun_normal_, linear_in_dtype


def _clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip``: a maximum and a minimum, whose gradient at a tie is one
    half (torch's ``clamp`` passes all of it)."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A flax ``Dense``: with ``dtype`` (the JAX layer's ``dtype=x.dtype``)
    computed in it, else in the promoted dtype of ``x`` and the weight."""
    dt = dtype or torch.promote_types(x.dtype, lin.weight.dtype)
    return linear_in_dtype(x.to(dt), lin.weight, lin.bias)


def _init_dense(g: torch.Generator, *layers: nn.Linear) -> None:
    """flax's default Dense init: lecun-normal kernel, zero bias."""
    for lin in layers:
        lecun_normal_(lin.weight, g)
        nn.init.zeros_(lin.bias)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm``: eps 1e-6, ``scale`` and ``bias``; statistics
    in at least fp32, the output in the promoted dtype of the input and the
    parameters (fp32 for a bf16 input on fp32 parameters)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def init_params(self, g: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.scale.dtype)
        xf = at_least_fp32(x)
        y = F.layer_norm(xf, self.scale.shape, self.scale.to(xf.dtype), self.bias.to(xf.dtype),
                         self.eps)
        return y.to(dt)


class MultiHeadAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (q, k and v projected to the
    query's width, biases): ``query``, ``key``, ``value`` and ``out`` as
    ``nn.Linear`` layers (the loader reshapes the ``DenseGeneral``
    kernels); the projections in the query's dtype, the scores and softmax
    in at least fp32; ``mask`` (broadcastable to (B, NH, Sq, Sk), True =
    attend)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key, self.value, self.out = (nn.Linear(dim, dim) for _ in range(4))

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, self.query, self.key, self.value, self.out)

    def forward(self, q, k, v, mask=None):
        dt = q.dtype
        b, sq, d = q.shape
        heads = lambda x, lin: (_dense(x, lin, dt).reshape(b, x.shape[1], self.num_heads, -1)
                                .transpose(1, 2))
        qh, kh, vh = heads(q, self.query), heads(k, self.key), heads(v, self.value)
        qh = qh / math.sqrt(qh.shape[-1])
        s = at_least_fp32(qh) @ at_least_fp32(kh).transpose(-2, -1)
        if mask is not None:
            s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
        y = s.softmax(-1).to(dt) @ vh
        return _dense(y.transpose(1, 2).reshape(b, sq, d), self.out, dt)


# --- backbone blocks ---


class HGStem(nn.Module):
    """PPHGNetV2 stem, YAML args [cm, c2] (not width-scaled): ``stem1`` 3x3
    stride 2; beside a 2x2 stride-1 max pool (its bottom and right padded
    with -inf), ``stem2a`` and ``stem2b`` (2x2, each after a zero pad of
    the bottom and right); the two concatenated into ``stem3`` (3x3 stride
    2), then ``stem4`` (1x1); ReLU throughout."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = ConvBN(c1, cm, 3, 2, act="relu")
        self.stem2a = ConvBN(cm, cm // 2, 2, 1, p=0, act="relu")
        self.stem2b = ConvBN(cm // 2, cm, 2, 1, p=0, act="relu")
        self.stem3 = ConvBN(2 * cm, cm, 3, 2, act="relu")
        self.stem4 = ConvBN(cm, c2, 1, 1, act="relu")

    @classmethod
    def parse(cls, args, ch_in, **kw):
        return int(args[1]), [ch_in[0], int(args[0]), int(args[1])], {}

    def forward(self, x):
        x = self.stem1(x)
        x2 = self.stem2b(F.pad(self.stem2a(F.pad(x, (0, 1, 0, 1))), (0, 1, 0, 1)))
        x1 = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 2, 1)
        return self.stem4(self.stem3(torch.cat([x1, x2], 1)))


class HGBlock(nn.Module):
    """PPHGNetV2 block, YAML args [cm, c2, k, lightconv, shortcut] (not
    width-scaled); the row's repeat count is the chain's length ``n`` (6
    where the row says 1, as in JAX). ``n`` chained convs (ReLU k x k
    ``m{i}``, or with ``lightconv`` a 1x1 ``m{i}_cv1`` without activation
    and a depthwise ReLU k x k ``m{i}_cv2``), the input and all their
    outputs concatenated into the squeeze ``sc`` (c2 / 2) and the excite
    ``ec`` (c2); plus the input with ``shortcut`` where c1 == c2."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6,
                 lightconv: bool = False, shortcut: bool = False):
        super().__init__()
        self.n, self.lightconv = n, lightconv
        for i in range(n):
            cin = c1 if i == 0 else cm
            if lightconv:
                setattr(self, f"m{i}_cv1", ConvBN(cin, cm, 1, act=False))
                setattr(self, f"m{i}_cv2", ConvBN(cm, cm, k, g=cm, act="relu"))
            else:
                setattr(self, f"m{i}", ConvBN(cin, cm, k, act="relu"))
        self.sc = ConvBN(c1 + n * cm, c2 // 2, 1, act="relu")
        self.ec = ConvBN(c2 // 2, c2, 1, act="relu")
        self.add = shortcut and c1 == c2

    @classmethod
    def parse(cls, args, ch_in, n: int = 1, **kw):
        kwargs = {}
        for i, key in ((2, "k"), (3, "lightconv"), (4, "shortcut")):
            if len(args) > i:
                kwargs[key] = int(args[i]) if key == "k" else bool(args[i])
        if n > 1:
            kwargs["n"] = n
        return int(args[1]), [ch_in[0], int(args[0]), int(args[1])], kwargs

    def forward(self, x):
        ys = [x]
        for i in range(self.n):
            if self.lightconv:
                ys.append(getattr(self, f"m{i}_cv2")(getattr(self, f"m{i}_cv1")(ys[-1])))
            else:
                ys.append(getattr(self, f"m{i}")(ys[-1]))
        y = self.ec(self.sc(torch.cat(ys, 1)))
        return y + x if self.add else y


# --- AIFI encoder layer ---


def sincos_2d(h: int, w: int, dim: int, temperature: float = 10000.0, device=None,
              dtype=torch.float32) -> torch.Tensor:
    """(h * w, dim) 2-D sin-cos position embedding in ``dtype`` (JAX's fp32;
    an fp64 step asks for fp64, so that its devices agree): sin and cos of
    the column, then of the row, each at dim / 4 frequencies."""
    gw, gh = torch.meshgrid(torch.arange(w, dtype=dtype, device=device),
                            torch.arange(h, dtype=dtype, device=device), indexing="xy")
    pos_dim = dim // 4
    omega = 1.0 / (temperature ** (torch.arange(pos_dim, dtype=dtype, device=device)
                                   / pos_dim))
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], 1)


class AIFI(nn.Module):
    """One transformer encoder layer over the flattened map (row-major H,
    W), YAML args [cm, num_heads] (cm width-scaled): the sin-cos embedding
    added to queries and keys of ``mha``, residual, ``norm1``; ``fc1``,
    tanh GELU, ``fc2``, residual, ``norm2``."""

    def __init__(self, c: int, num_heads: int = 8, cm: int = 1024):
        super().__init__()
        self.mha = MultiHeadAttention(c, num_heads)
        self.norm1, self.norm2 = LayerNorm(c), LayerNorm(c)
        self.fc1, self.fc2 = nn.Linear(c, cm), nn.Linear(cm, c)

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, self.fc1, self.fc2)

    @classmethod
    def parse(cls, args, ch_in, width: float = 1.0, max_ch=float("inf"), **kw):
        from .graph import make_divisible

        kwargs = {}
        if args:
            kwargs["cm"] = make_divisible(min(args[0], max_ch) * width, 8)
        if len(args) > 1:
            kwargs["num_heads"] = int(args[1])
        return ch_in[0], [ch_in[0]], kwargs

    def forward(self, x):
        b, c, h, w = x.shape
        seq = x.flatten(2).transpose(1, 2)
        pos = sincos_2d(h, w, c, device=x.device, dtype=at_least_fp32(seq).dtype).to(seq.dtype)
        q = seq + pos[None]
        seq = self.norm1(seq + self.mha(q, q, seq))
        ff = _dense(F.gelu(_dense(seq, self.fc1, seq.dtype), approximate="tanh"), self.fc2,
                    seq.dtype)
        seq = self.norm2(seq + ff)
        return seq.transpose(1, 2).reshape(b, c, h, w)


# --- deformable attention ---


def cell(f: torch.Tensor) -> torch.Tensor:
    """The grid cell of each sampling coordinate: ``floor(f)``."""
    return torch.floor(f)


def _corner(f: torch.Tensor, size: int):
    """The first corner of a sample at pixel coordinate ``f`` on a side of
    ``size`` (its ``cell`` clamped into the map) and the weight of the
    second, ``f`` less the corner clipped into [0, 1], as JAX clips it."""
    c = _clip(cell(f), 0, size - 1)
    return c, _clip(f - c, 0.0, 1.0)[..., None]


def deform_sample(value: torch.Tensor, shapes: Sequence, locs: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable sampling, the JAX gather: value (B, L_total,
    NH, DH), the levels' (h, w) in ``shapes``, locs (B, Q, NH, levels,
    points, 2) normalized xy, weights (B, Q, NH, levels * points) -> (B, Q,
    NH * DH). Bilinear at (x w - 1/2, y h - 1/2), the corners clamped into
    the map (so beyond the border the border's value, and no gradient to
    the location)."""
    b, _, nh, dh = value.shape
    q, n_points = locs.shape[1], locs.shape[4]
    out, start = [], 0
    for li, (h, w) in enumerate(shapes):
        flat = value[:, start:start + h * w].permute(0, 2, 1, 3).reshape(b * nh, h * w, dh)
        start += h * w
        xy = locs[:, :, :, li]  # (B, Q, NH, P, 2)
        fx = xy[..., 0] * w - 0.5
        fy = xy[..., 1] * h - 0.5
        x0, ax = _corner(fx, w)
        y0, ay = _corner(fy, h)
        x1 = _clip(x0 + 1, 0, w - 1)
        y1 = _clip(y0 + 1, 0, h - 1)

        def gather(yy, xx):  # the index in integers: a bf16 y w + x is not exact
            idx = (yy.long() * w + xx.long()).permute(0, 2, 1, 3).reshape(b * nh, q * n_points, 1)
            g = flat.gather(1, idx.expand(-1, -1, dh))  # (B*NH, Q*P, DH)
            return g.reshape(b, nh, q, n_points, dh).permute(0, 2, 1, 3, 4)

        p00, p01 = gather(y0, x0), gather(y0, x1)
        p10, p11 = gather(y1, x0), gather(y1, x1)
        top = p00 + ax * (p01 - p00)
        bot = p10 + ax * (p11 - p10)
        out.append(top + ay * (bot - top))  # (B, Q, NH, P, DH)
    samples = torch.cat(out, 3)  # (B, Q, NH, L*P, DH)
    return (samples * weights.reshape(b, q, nh, -1, 1)).sum(3).reshape(b, q, nh * dh)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention: ``value_proj`` of the flattened
    maps, per head ``n_levels`` x ``n_points`` sampling offsets
    (``sampling_offsets``, its kernel zero at init) around each reference
    box's centre, scaled by its size, and their softmax weights
    (``attention_weights``, zero kernel at init); ``output_proj``."""

    def __init__(self, c: int, num_heads: int = 8, n_levels: int = 3, n_points: int = 4):
        super().__init__()
        self.nh, self.nl, self.npnt = num_heads, n_levels, n_points
        self.value_proj = nn.Linear(c, c)
        self.sampling_offsets = nn.Linear(c, num_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(c, num_heads * n_levels * n_points)
        self.output_proj = nn.Linear(c, c)

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, self.value_proj, self.output_proj)
        for lin in (self.sampling_offsets, self.attention_weights):
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)

    def forward(self, query, ref_points, value, shapes):
        """query (B, Q, C); ref_points (B, Q, 4) normalized cxcywh; value
        (B, L_total, C); shapes the levels' (h, w)."""
        b, q, c = query.shape
        nh, nl, npnt = self.nh, self.nl, self.npnt
        v = _dense(value, self.value_proj, value.dtype).reshape(b, -1, nh, c // nh)
        offsets = _dense(query, self.sampling_offsets).reshape(b, q, nh, nl, npnt, 2)
        weights = _dense(query, self.attention_weights).reshape(b, q, nh, nl * npnt)
        weights = weights.to(at_least_fp32(weights).dtype).softmax(-1).to(query.dtype)
        centers = ref_points[:, :, None, None, None, :2]
        wh = ref_points[:, :, None, None, None, 2:]
        locs = centers + offsets / npnt * wh * 0.5
        return _dense(deform_sample(v, shapes, locs, weights), self.output_proj, query.dtype)


class DeformableDecoderLayer(nn.Module):
    """``self_attn`` (queries and keys plus the query position, ``mask``),
    residual, ``norm1``; ``cross_attn`` (deformable, on the maps), residual,
    ``norm2``; ``fc1``, ReLU, ``fc2``, residual, ``norm3``."""

    def __init__(self, c: int, num_heads: int = 8, n_levels: int = 3, n_points: int = 4,
                 cm: int = 1024):
        super().__init__()
        self.self_attn = MultiHeadAttention(c, num_heads)
        self.cross_attn = MSDeformAttn(c, num_heads, n_levels, n_points)
        self.norm1, self.norm2, self.norm3 = LayerNorm(c), LayerNorm(c), LayerNorm(c)
        self.fc1, self.fc2 = nn.Linear(c, cm), nn.Linear(cm, c)

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, self.fc1, self.fc2)

    def forward(self, x, ref_points, value, shapes, query_pos, attn_mask=None):
        q = x + query_pos
        x = self.norm1(x + self.self_attn(q, q, x, attn_mask))
        x = self.norm2(x + self.cross_attn(x + query_pos, ref_points, value, shapes))
        ff = _dense(F.relu(_dense(x, self.fc1, x.dtype)), self.fc2, x.dtype)
        return self.norm3(x + ff)


class MLPHead(nn.Module):
    """``layers`` Dense layers ``l{i}`` with ReLU between; the hidden ones
    in the input's dtype, the last in the promoted one."""

    def __init__(self, c1: int, hidden: int, out: int, layers: int = 3):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            setattr(self, f"l{i}", nn.Linear(c1 if i == 0 else hidden,
                                             out if i == layers - 1 else hidden))

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, *(getattr(self, f"l{i}") for i in range(self.layers)))

    def forward(self, x):
        for i in range(self.layers - 1):
            x = F.relu(_dense(x, getattr(self, f"l{i}"), x.dtype))
        return _dense(x, getattr(self, f"l{self.layers - 1}"))


# --- denoising groups ---


def get_cdn_group(gt_cls, gt_cxcywh, mask, nc: int, generator: torch.Generator,
                  num_group: int = 3, cls_noise_ratio: float = 0.5,
                  box_noise_scale: float = 1.0):
    """Contrastive-denoising queries: ``num_group`` groups of 2 M slots (M
    ground-truth slots of the batch), the first M positive (the box jittered
    within ±1/2 of its size), the next M negative (pushed out by (1/2,
    3/2] of it); a random share ``cls_noise_ratio / 2`` of the classes
    replaced by random ones. gt_cls (B, M) int, gt_cxcywh (B, M, 4)
    normalized, mask (B, M). Drawn from ``generator`` (on its device) ->
    dn_cls (B, D) int64, dn_box (B, D, 4), dn_pos (B, D) 1 on the positive
    slots of real boxes, dn_valid (B, D), dn_gt_idx (B, D); D = 2 M
    num_group."""
    b, m = gt_cls.shape
    d = 2 * m * num_group
    dev = generator.device
    flip = torch.rand(b, d, generator=generator, device=dev) < (cls_noise_ratio * 0.5)
    rand_cls = torch.randint(0, nc, (b, d), generator=generator, device=dev)
    sign = torch.randint(0, 2, (b, d, 4), generator=generator, device=dev) * 2.0 - 1.0
    u = torch.rand(b, d, 4, generator=generator, device=dev)
    return cdn_from_draws(gt_cls, gt_cxcywh, mask, num_group, flip, rand_cls, sign, u,
                          box_noise_scale)


def cdn_meta(mask, num_group: int):
    """The denoising slots' roles, from the (B, M) validity of the ground
    truth: dn_pos (B, D) 1 on the positive slots of real boxes, dn_valid
    (B, D), dn_gt_idx (B, D) each slot's ground-truth slot, and neg (1, D)
    1 on the negative half of each group."""
    b, m = mask.shape
    dev = mask.device
    valid = mask.float().repeat(1, 2 * num_group)
    gt_idx = torch.arange(m, device=dev).repeat(2 * num_group)[None].expand(b, -1)
    neg = torch.cat([torch.zeros(m, device=dev), torch.ones(m, device=dev)]).repeat(num_group)[None]
    return valid * (1.0 - neg), valid, gt_idx, neg


def cdn_from_draws(gt_cls, gt_cxcywh, mask, num_group, flip, rand_cls, sign, u,
                   box_noise_scale: float = 1.0):
    """``get_cdn_group``'s result from its draws: ``flip`` (B, D) bool,
    ``rand_cls`` (B, D), ``sign`` (B, D, 4) of ±1 and ``u`` (B, D, 4) in
    [0, 1)."""
    dev = flip.device
    gt_cls, gt_cxcywh = gt_cls.to(dev), gt_cxcywh.to(dev)
    dn_pos, valid, gt_idx, neg = cdn_meta(mask.to(dev), num_group)
    cls, box = gt_cls.long().repeat(1, 2 * num_group), gt_cxcywh.float().repeat(1, 2 * num_group, 1)
    dn_cls = torch.where(flip, rand_cls.long(), cls)
    wh = torch.cat([box[..., 2:], box[..., 2:]], -1)
    scale = torch.where(neg[..., None] > 0, u + 1.0, u)
    xyxy = torch.cat([box[..., :2] - box[..., 2:] / 2, box[..., :2] + box[..., 2:] / 2], -1)
    xyxy = _clip(xyxy + sign * scale * (wh / 2) * box_noise_scale, 0.0, 1.0)
    dn_box = torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2, (xyxy[..., 2:] - xyxy[..., :2]).abs()],
                       -1)
    return dn_cls, dn_box, dn_pos, valid, gt_idx


def cdn_attn_mask(num_dn: int, num_group: int, nq: int, device=None) -> torch.Tensor:
    """(1, 1, D + nq, D + nq) bool self-attention mask (True = attend): the
    matching queries never see the denoising slots; each group sees itself
    and the matching queries."""
    total = num_dn + nq
    gsz = num_dn // num_group
    allow = torch.zeros(total, total, dtype=torch.bool, device=device)
    allow[:, num_dn:] = True
    for g in range(num_group):
        allow[g * gsz:(g + 1) * gsz, g * gsz:(g + 1) * gsz] = True
    return allow[None, None]


# --- the decoder ---


def ranked(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k) indices of the k largest entries of each row of ``x`` in
    descending order, the lower index first among equal values (the order
    of ``jax.lax.top_k``; ``torch.topk`` promises none among ties)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def _inv_sigmoid(x, eps: float = 1e-5):
    x = _clip(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


def _build_anchors(shapes, grid_size: float = 0.05, dtype=torch.float32, device=None):
    """(1, L, 4) cxcywh anchor priors at every cell of every level (size
    ``grid_size`` 2^level) and (1, L, 1) their validity: every coordinate
    inside (0.01, 0.99); computed in at least fp32 (JAX's fp32), returned
    in ``dtype``."""
    anchors = []
    ct = torch.promote_types(dtype, torch.float32)
    for i, (h, w) in enumerate(shapes):
        sy = (torch.arange(h, dtype=ct, device=device) + 0.5) / h
        sx = (torch.arange(w, dtype=ct, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        wh = torch.full((h * w, 2), grid_size * (2.0 ** i), dtype=ct, device=device)
        anchors.append(torch.cat([torch.stack([gx, gy], -1).reshape(-1, 2), wh], -1))
    anchors = torch.cat(anchors)[None]
    valid = ((anchors > 0.01) & (anchors < 0.99)).all(-1, keepdim=True)
    return anchors.to(dtype), valid.to(dtype)


class RTDETRDecoder(nn.Module):
    """The RT-DETR head, YAML args [nc]: each map projected to ``hd``
    channels (``input_proj{i}``, 1x1 ConvBN) and flattened; the encoder
    head (``enc_output`` + ``enc_output_norm`` on the maps, the invalid
    anchors' values zeroed; ``enc_score_head``, ``enc_bbox_head`` on the
    anchor priors); the ``nq`` anchors of the highest class score
    (``ranked``) give the queries and their reference boxes (detached in
    train mode); ``ndl`` decoder layers, each refining the boxes
    (``bbox_head{i}``, then detached) and scoring them
    (``score_head{i}``), with one ``query_pos_head`` shared by all. ``dn``
    = (dn_cls, dn_box, num_group) prepends the denoising queries
    (``denoising_class_embed`` of their classes, their boxes) under the
    group mask. Returns {"boxes" (B, nq, 4) normalized cxcywh, "scores"
    (B, nq, nc) logits, "aux_boxes", "aux_scores" (ndl - 1, B, nq, ...),
    "enc_boxes", "enc_scores"}, with ``dn`` also "dn_boxes" and
    "dn_scores" of the last layer."""

    def __init__(self, nc: int = 80, ch: tuple = (), hd: int = 256, nq: int = 300,
                 ndl: int = 6, nh: int = 8, ndp: int = 4):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl = nc, hd, nq, ndl
        self.n_levels = len(ch)
        for i, c in enumerate(ch):
            setattr(self, f"input_proj{i}", ConvBN(c, hd, 1, act=False))
        self.enc_output = nn.Linear(hd, hd)
        self.enc_output_norm = LayerNorm(hd)
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = MLPHead(hd, hd, 4)
        self.denoising_class_embed = nn.Embedding(nc, hd)
        self.query_pos_head = MLPHead(4, 2 * hd, hd, 2)
        for i in range(ndl):
            setattr(self, f"layer{i}", DeformableDecoderLayer(hd, nh, len(ch), ndp))
            setattr(self, f"bbox_head{i}", MLPHead(hd, hd, 4))
            setattr(self, f"score_head{i}", nn.Linear(hd, nc))

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, self.enc_output, self.enc_score_head,
                    *(getattr(self, f"score_head{i}") for i in range(self.ndl)))
        # flax's Embed: a normal of variance 1 / hd, truncated at 2 sigma
        lecun_normal_(self.denoising_class_embed.weight, g)

    def forward(self, feats, dn=None):
        b = feats[0].shape[0]
        shapes = [tuple(f.shape[2:]) for f in feats]
        value = torch.cat([getattr(self, f"input_proj{i}")(f).flatten(2).transpose(1, 2)
                           for i, f in enumerate(feats)], 1)  # (B, L, hd)
        anchors, valid = _build_anchors(shapes, dtype=value.dtype, device=value.device)
        features = self.enc_output_norm(_dense(value * valid, self.enc_output))
        enc_scores = _dense(features, self.enc_score_head)
        enc_boxes = torch.sigmoid(self.enc_bbox_head(features) + _inv_sigmoid(anchors))

        nq = min(self.nq, enc_scores.shape[1])
        topi = ranked(enc_scores.max(-1)[0], nq)  # (B, nq)
        ref = enc_boxes.gather(1, topi[..., None].expand(-1, -1, 4))
        tgt = features.gather(1, topi[..., None].expand(-1, -1, features.shape[-1]))
        if self.training:
            ref, tgt = ref.detach(), tgt.detach()

        num_dn, attn_mask = 0, None
        if dn is not None:
            dn_cls, dn_box, num_group = dn
            num_dn = dn_cls.shape[1]
            dn_tgt = self.denoising_class_embed.weight[dn_cls.long()]
            tgt = torch.cat([dn_tgt.to(tgt.dtype), tgt], 1)
            ref = torch.cat([dn_box.to(ref.dtype), ref], 1)
            attn_mask = cdn_attn_mask(num_dn, num_group, nq, device=tgt.device)

        dec_b, dec_s = [], []
        x = tgt
        for li in range(self.ndl):
            query_pos = self.query_pos_head(ref)
            x = getattr(self, f"layer{li}")(x, ref, value, shapes, query_pos, attn_mask)
            ref = torch.sigmoid(getattr(self, f"bbox_head{li}")(x) + _inv_sigmoid(ref))
            dec_b.append(ref)
            dec_s.append(_dense(x, getattr(self, f"score_head{li}")))
            ref = ref.detach()
        aux = self.ndl > 1
        out = {"boxes": dec_b[-1][:, num_dn:], "scores": dec_s[-1][:, num_dn:],
               "aux_boxes": torch.stack(dec_b[:-1])[:, :, num_dn:] if aux else None,
               "aux_scores": torch.stack(dec_s[:-1])[:, :, num_dn:] if aux else None,
               "enc_boxes": enc_boxes, "enc_scores": enc_scores}
        if num_dn:
            out["dn_boxes"] = dec_b[-1][:, :num_dn]
            out["dn_scores"] = dec_s[-1][:, :num_dn]
        return out


# --- the loss ---


def _host_hungarian(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Per image, the Hungarian assignment of the first ``n_valid`` ground
    truths (columns) of ``cost`` (B, nq, n_max) -> (B, n_max) int32: each
    slot's query, -1 for padding."""
    from scipy.optimize import linear_sum_assignment

    b, _, n_max = cost.shape
    out = -np.ones((b, n_max), np.int32)
    for bi in range(b):
        n = int(n_valid[bi])
        if n == 0:
            continue
        rows, cols = linear_sum_assignment(cost[bi, :, :n])
        out[bi, cols] = rows.astype(np.int32)
    return out


def hungarian(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """``_host_hungarian`` of a (B, nq, n_max) cost on any device -> (B,
    n_max) int64 on its device (the device waits for the host here)."""
    match = _host_hungarian(cost.detach().cpu().numpy(), n_valid.cpu().numpy())
    return torch.from_numpy(match).long().to(cost.device)


def _gt_targets(batch: dict, imgsz: float, dt: torch.dtype):
    """The batch's classes (B, M) int64 and normalized cxcywh boxes (B, M,
    4) in ``dt``, from ``cls_boxes`` (B, M, 5) = cls and pixel xyxy."""
    gt = batch["cls_boxes"].to(dt)
    xyxy = gt[..., 1:5] / imgsz
    return gt[..., 0].long(), torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2,
                                         xyxy[..., 2:] - xyxy[..., :2]], -1)


def _varifocal(logits, one_hot, gt_score, weight_mask=None):
    """The per-entry varifocal loss of the classification branch: BCE
    against the IoU-scaled one-hot targets, weighted by 0.75 p^2 off the
    target class and by the target's score on it."""
    ps = torch.sigmoid(logits)
    w = 0.75 * ps * ps * (1.0 - one_hot) + gt_score * one_hot
    if weight_mask is not None:
        w = w * weight_mask
    bce = _clip(logits, 0.0) - logits * gt_score + torch.log1p(torch.exp(-logits.abs()))
    return bce * w


def rtdetr_loss(out: dict, batch: dict, nc: int, imgsz: float, cls_gain: float = 1.0,
                l1_gain: float = 5.0, giou_gain: float = 2.0):
    """The DETR loss of the last decoder layer and each auxiliary one: a
    Hungarian match per image on cost cls_gain (-p of the GT class) +
    l1_gain L1 + giou_gain (1 - GIoU), padded slots at 1e6; then L1 and GIoU
    of the matched boxes, and the varifocal classification loss over all
    queries with IoU-scaled targets (mean over queries, summed, scaled by
    nq / number of GT). The encoder's outputs are not scored. Computed in at
    least fp32. Returns (total, {"box", "cls", "aux"})."""
    dt = at_least_fp32(out["scores"]).dtype
    mask = batch["mask"].to(dt)
    n_valid = mask.sum(1).long()
    gt_cls, gt_box = _gt_targets(batch, imgsz, dt)
    n_total = dp_total(mask.sum()).clamp(min=1.0)  # the global batch's under dp

    def one_level(boxes, scores):
        b, nq, _ = scores.shape
        m = gt_cls.shape[1]
        boxes, logits = boxes.to(dt), scores.to(dt)
        prob = torch.sigmoid(logits)
        cost_cls = -prob.gather(-1, gt_cls[:, None, :].expand(b, nq, m))
        l1 = (boxes[:, :, None, :] - gt_box[:, None, :, :]).abs().sum(-1)
        giou = bbox_iou_xywh(boxes[:, :, None, :], gt_box[:, None, :, :], giou=True)
        cost = cls_gain * cost_cls + l1_gain * l1 + giou_gain * (1 - giou)
        cost = torch.where(mask[:, None, :] > 0, cost, torch.full_like(cost, 1e6))
        match = _clip(hungarian(cost.detach(), n_valid), 0, nq - 1)
        matched = boxes.gather(1, match[..., None].expand(-1, -1, 4))
        l1_loss = (matched - gt_box).abs().sum(-1)
        giou_loss = 1 - bbox_iou_xywh(matched, gt_box, giou=True)
        box_loss = ((l1_gain * l1_loss + giou_gain * giou_loss) * mask).sum() / n_total

        # targets scattered into a dummy slot nq for the padded GT rows
        idx = torch.where(mask > 0, match, torch.full_like(match, nq))
        tq = torch.full((b, nq + 1), nc, dtype=torch.long, device=idx.device)
        tq.scatter_(1, idx, gt_cls)
        iou_m = _clip(bbox_iou_xywh(matched.detach(), gt_box), 0.0)
        gt_q = torch.zeros(b, nq + 1, dtype=dt, device=idx.device).scatter_(1, idx, iou_m)
        one_hot = F.one_hot(tq[:, :nq], nc + 1)[..., :nc].to(dt)
        vfl = _varifocal(logits, one_hot, gt_q[:, :nq, None] * one_hot)
        return box_loss, cls_gain * vfl.mean(1).sum() * nq / n_total

    box_l, cls_l = one_level(out["boxes"], out["scores"])
    aux = box_l.new_zeros(())
    if out.get("aux_boxes") is not None:
        for i in range(out["aux_boxes"].shape[0]):
            bl, cl = one_level(out["aux_boxes"][i], out["aux_scores"][i])
            aux = aux + bl + cl
    return box_l + cls_l + aux, {"box": box_l, "cls": cls_l, "aux": aux}


def cdn_loss(out: dict, dn_meta: tuple, batch: dict, nc: int, imgsz: float,
             cls_gain: float = 1.0, l1_gain: float = 5.0, giou_gain: float = 2.0):
    """The denoising loss: each slot's ground truth is known (``dn_gt_idx``),
    so no match; the positives' L1 and GIoU to their box, and the varifocal
    loss with the positives on their class at IoU score and the negatives
    (and padding, weighted out by ``dn_valid``) as background. ``dn_meta`` =
    (dn_pos, dn_valid, dn_gt_idx). Returns (total, {"dn_box", "dn_cls"}),
    or (0, {}) without denoising outputs."""
    if "dn_boxes" not in out:
        return 0.0, {}
    dt = at_least_fp32(out["dn_scores"]).dtype
    dn_pos, dn_valid, dn_gt_idx = (t.to(out["dn_boxes"].device) for t in dn_meta)
    dn_pos, dn_valid, dn_gt_idx = dn_pos.to(dt), dn_valid.to(dt), dn_gt_idx.long()
    gt_cls, gt_box = _gt_targets(batch, imgsz, dt)
    boxes, scores = out["dn_boxes"].to(dt), out["dn_scores"].to(dt)
    tgt_box = gt_box.gather(1, dn_gt_idx[..., None].expand(-1, -1, 4))
    tgt_cls = gt_cls.gather(1, dn_gt_idx)

    l1 = (boxes - tgt_box).abs().sum(-1)
    giou = 1 - bbox_iou_xywh(boxes, tgt_box, giou=True)
    n_pos = dp_total(dn_pos.sum()).clamp(min=1.0)
    box_loss = ((l1_gain * l1 + giou_gain * giou) * dn_pos).sum() / n_pos

    nq_dn = scores.shape[1]
    tq = torch.where(dn_pos > 0, tgt_cls, torch.full_like(tgt_cls, nc))
    one_hot = F.one_hot(tq, nc + 1)[..., :nc].to(dt)
    iou_dn = _clip(bbox_iou_xywh(boxes.detach(), tgt_box), 0.0)
    vfl = _varifocal(scores, one_hot, (iou_dn * dn_pos)[..., None] * one_hot, dn_valid[..., None])
    cls_loss = cls_gain * vfl.mean(1).sum() * nq_dn / n_pos
    return box_loss + cls_loss, {"dn_box": box_loss, "dn_cls": cls_loss}


def rtdetr_postprocess(out: dict, imgsz: float, max_det: int = 300) -> torch.Tensor:
    """NMS-free decode: per-class sigmoid scores, the top ``max_det`` (query,
    class) pairs (``ranked``) -> (B, k, 6) = pixel xyxy, score, class."""
    boxes = out["boxes"] * imgsz
    scores = torch.sigmoid(at_least_fp32(out["scores"]))
    b, nq, nc = scores.shape
    flat = scores.reshape(b, nq * nc)
    topi = ranked(flat, min(max_det, nq * nc))
    topv = flat.gather(1, topi)
    sel = boxes.gather(1, (topi // nc)[..., None].expand(-1, -1, 4))
    x1y1 = sel[..., :2] - sel[..., 2:] / 2
    x2y2 = sel[..., :2] + sel[..., 2:] / 2
    return torch.cat([x1y1, x2y2, topv[..., None], (topi % nc).to(topv.dtype)[..., None]], -1)
