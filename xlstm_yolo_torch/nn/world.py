"""YOLO-World blocks, NCHW: open-vocabulary detection, whose class logits
are similarities between image features and text embeddings.

Port of ``xlstm_yolo_tpu/nn/world.py``, plain torch (the JAX module is
plain XLA: no kernel of its own). The text embeddings (the guide, (B | 1,
nt, C)) come from outside: ``TaskModel.txt_feats``, ``set_classes`` or a
batch's ``txt_feats``; ``GraphModel.forward`` hands the running guide to
every module whose class sets ``needs_guide``, and the output of one that
sets ``updates_guide`` (``ImagePoolingAttn``) replaces it for every later
row. A guide of batch 1 broadcasts to the images' batch.

flax's arithmetic is kept where the JAX layer names no ``dtype``: its
plain ``Conv``, ``Dense``, ``LayerNorm`` and ``BatchNorm`` and the scalar
parameters compute in the promoted dtype of their input and parameters
(``_promote``), so an fp32 guide lifts what it touches to fp32, in bf16
serving (bf16 parameters) as under AMP; the ``ConvBN`` blocks compute in
their input's dtype, as everywhere in the port. Every max whose gradient
matters is ``tied_max`` (``torch.amax``), which splits the gradient
evenly among tied entries as ``jax.grad`` of ``jnp.max`` does: the padded
text slots of a ``MultiModalDataset`` batch share one embedding, so the max
over texts ties on them. It is a module function, so that a caller can
record which entries are maximal or replay another run's
(``chip_smoke.SharedChoices``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.distributed import dp_group, dp_sum
from ..utils import at_least_fp32
from .modules import (BN_EPS, BN_MOMENTUM, Bottleneck, ConvBN, batch_norm_global, conv_in_dtype,
                      lecun_normal_)
from .rtdetr import LayerNorm, _dense, _init_dense


def _promote(*ts: torch.Tensor) -> torch.dtype:
    """The dtype JAX gives an op of these arrays (0-d ones included, which
    torch would not let promote a dimensioned operand)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A flax ``nn.Conv`` without ``dtype``: in the promoted dtype of the
    input and the kernel."""
    return conv_in_dtype(conv, x.to(_promote(x, conv.weight)))


def l2_normalize(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``t`` over its L2 norm along ``dim``, the norm clipped below at 1e-6
    (``F.normalize``'s floor is 1e-12)."""
    return t / torch.linalg.vector_norm(t, dim=dim, keepdim=True).clamp_min(1e-6)


def tied_max(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """The max of ``x`` over ``dims``, the gradient split evenly among tied
    maxima (``torch.amax``; ``max(dim)`` would send it to one)."""
    return torch.amax(x, dim=dims)


def _batch_guide(txt: torch.Tensor, b: int) -> torch.Tensor:
    return txt.expand(b, *txt.shape[1:]) if txt.shape[0] == 1 and b > 1 else txt


def _init_scalar(p: nn.Parameter, value: float) -> None:
    with torch.no_grad():
        p.fill_(value)


class ContrastiveHead(nn.Module):
    """Region-text logits: the cosine of each pixel's feature (B, C, H, W)
    and each text (B | 1, nt, C), times ``logit_scale`` (1 / 0.07 at init),
    plus ``bias`` (-10) -> (B, nt, H, W)."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.tensor(-10.0))
        self.logit_scale = nn.Parameter(torch.tensor(1.0 / 0.07))

    def init_params(self, g: torch.Generator) -> None:
        _init_scalar(self.bias, -10.0)
        _init_scalar(self.logit_scale, 1.0 / 0.07)

    def forward(self, x: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
        txt = _batch_guide(txt, x.shape[0])
        xn, tn = l2_normalize(x, 1), l2_normalize(txt)
        dt = _promote(xn, tn)
        sim = torch.einsum("bchw,btc->bthw", xn.to(dt), tn.to(dt))
        dt = _promote(sim, self.logit_scale, self.bias)
        return sim.to(dt) * self.logit_scale.to(dt) + self.bias.to(dt)


class ScaleBatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` without ``dtype`` (YOLO-Worldv2's head,
    momentum 0.97, eps 1e-3) under the flax names ``scale`` and ``bias``:
    statistics and normalization in at least fp32, the output in the
    promoted dtype of the input and the parameters; in train mode the batch
    statistics (biased variance) normalize and update the running ones."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def init_params(self, g: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, xf = _promote(x, self.scale, self.bias), at_least_fp32(x)
        w, b = self.scale.to(xf.dtype), self.bias.to(xf.dtype)
        if not self.training:
            return F.batch_norm(xf, self.running_mean.to(xf.dtype), self.running_var.to(xf.dtype),
                                w, b, False, 0.0, BN_EPS).to(dt)
        if dp_group() is not None:  # the global batch's statistics (modules.batch_norm_train)
            return batch_norm_global(xf, w, b, BN_EPS, BN_MOMENTUM, self.running_mean,
                                     self.running_var, dp_sum).to(dt)
        y = F.batch_norm(xf, None, None, w, b, True, 0.0, BN_EPS).to(dt)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), BN_MOMENTUM)
            self.running_var.lerp_(var.to(self.running_var.dtype), BN_MOMENTUM)
        return y


class BNContrastiveHead(nn.Module):
    """YOLO-Worldv2's contrastive head: the image features batch-normalized
    (``norm``), the texts L2-normalized and cast to the features' dtype,
    their product times exp(``logit_scale``) (-1 at init) plus ``bias``
    (-10)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.norm = ScaleBatchNorm(embed_dim)
        self.bias = nn.Parameter(torch.tensor(-10.0))
        self.logit_scale = nn.Parameter(torch.tensor(-1.0))

    def init_params(self, g: torch.Generator) -> None:
        _init_scalar(self.bias, -10.0)
        _init_scalar(self.logit_scale, -1.0)

    def forward(self, x: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
        x = self.norm(x)
        tn = l2_normalize(_batch_guide(txt, x.shape[0])).to(x.dtype)
        sim = torch.einsum("bchw,btc->bthw", x, tn)
        dt = _promote(sim, self.logit_scale, self.bias)
        return sim.to(dt) * torch.exp(self.logit_scale.to(dt)) + self.bias.to(dt)


def adaptive_max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """torch's ``AdaptiveMaxPool2d((k, k))`` bins on an NCHW map, each bin's
    max by ``tied_max`` (ties split the gradient evenly, as in JAX) ->
    (B, k * k, C), bins in row-major order."""
    h, w = x.shape[2:]
    cells = []
    for i in range(k):
        r0, r1 = (i * h) // k, -((-(i + 1) * h) // k)
        for j in range(k):
            c0, c1 = (j * w) // k, -((-(j + 1) * w) // k)
            cells.append(tied_max(x[:, :, r0:r1, c0:c1], (2, 3)))
    return torch.stack(cells, 1)


class ImagePoolingAttn(nn.Module):
    """Image-aware text enhancement: each tap (``ch`` its channels) through
    a 1x1 conv to ``ec`` (``proj{i}``, with a bias), max-pooled to k x k
    bins; the texts (``gc`` wide) cross-attend to the pooled patches over
    ``nh`` heads (LayerNorms ``q_ln``, ``k_ln``, ``v_ln`` at flax's eps
    1e-6, Dense ``query``, ``key``, ``value``), the result projected to
    ``ct`` (``proj``), times ``scale`` (a learned scalar, zero at init, with
    ``use_scale``; else 1) and added to the texts. Its output is the new
    guide."""

    needs_guide = True
    updates_guide = True

    def __init__(self, ch: tuple, ec: int = 256, ct: int = 512, nh: int = 8, k: int = 3,
                 use_scale: bool = False, gc: int = 512):
        super().__init__()
        self.ec, self.nh, self.k, self.nf = ec, nh, k, len(ch)
        for i, c in enumerate(ch):
            setattr(self, f"proj{i}", nn.Conv2d(c, ec, 1))
        self.q_ln, self.k_ln, self.v_ln = LayerNorm(gc), LayerNorm(ec), LayerNorm(ec)
        self.query, self.key, self.value = nn.Linear(gc, ec), nn.Linear(ec, ec), nn.Linear(ec, ec)
        self.proj = nn.Linear(ec, ct)
        self.scale = nn.Parameter(torch.zeros(())) if use_scale else None

    def init_params(self, g: torch.Generator) -> None:
        for i in range(self.nf):
            conv = getattr(self, f"proj{i}")
            lecun_normal_(conv.weight, g)
            nn.init.zeros_(conv.bias)
        _init_dense(g, self.query, self.key, self.value, self.proj)
        if self.scale is not None:
            nn.init.zeros_(self.scale)

    def forward(self, feats: Sequence[torch.Tensor], text: torch.Tensor) -> torch.Tensor:
        bs = feats[0].shape[0]
        text = _batch_guide(text, bs)
        xp = torch.cat([adaptive_max_pool(_conv(getattr(self, f"proj{i}"), f), self.k)
                        for i, f in enumerate(feats)], 1)  # (B, nf * k * k, ec)
        q = _dense(self.q_ln(text), self.query)
        kk = _dense(self.k_ln(xp), self.key)
        vv = _dense(self.v_ln(xp), self.value)
        hc = self.ec // self.nh
        dt = _promote(q, kk, vv)
        qh, kh, vh = (t.to(dt).reshape(bs, -1, self.nh, hc) for t in (q, kk, vv))
        aw = torch.einsum("bnmc,bkmc->bmnk", qh, kh) / (hc ** 0.5)
        aw = aw.softmax(-1)
        out = torch.einsum("bmnk,bkmc->bnmc", aw, vh).reshape(bs, -1, self.ec)
        out = _dense(out, self.proj)
        if self.scale is not None:
            dt = _promote(out, self.scale)
            out = out.to(dt) * self.scale.to(dt)
        return text + out


class MaxSigmoidAttnBlock(nn.Module):
    """Text-guided spatial attention: per head, the largest dot product of
    each pixel's embedding (``ec``, a 1x1 ConvBN without activation when
    c1 != ec) with the texts projected to ``ec`` (Dense ``gl`` of the ``gc``
    wide guide), over sqrt(ec / nh), plus a per-head ``bias``, through a
    sigmoid times 2, scales that head's channels of a 3x3 ConvBN
    (``proj_conv``, no activation) of the input."""

    def __init__(self, c1: int, c2: int, nh: int = 1, ec: int = 128, gc: int = 512):
        super().__init__()
        self.c2, self.nh, self.ec_dim = c2, nh, ec
        self.ec = ConvBN(c1, ec, 1, act=False) if c1 != ec else None
        self.gl = nn.Linear(gc, ec)
        self.bias = nn.Parameter(torch.zeros(nh))
        self.proj_conv = ConvBN(c1, c2, 3, act=False)

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, self.gl)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        hc = self.ec_dim // self.nh
        embed = self.ec(x) if self.ec is not None else x
        gl = _batch_guide(_dense(guide, self.gl), b)
        dt = _promote(embed, gl)
        e = embed.to(dt).reshape(b, self.nh, hc, h, w)
        gm = gl.to(dt).reshape(b, -1, self.nh, hc)
        aw = tied_max(torch.einsum("bmchw,btmc->bmhwt", e, gm), (-1,)) / (hc ** 0.5)
        dt = _promote(aw, self.bias)
        aw = torch.sigmoid(aw.to(dt) + self.bias.to(dt).reshape(1, -1, 1, 1)) * 2.0
        pf = self.proj_conv(x).reshape(b, self.nh, self.c2 // self.nh, h, w)
        dt = _promote(pf, aw)
        return (pf.to(dt) * aw[:, :, None]).reshape(b, self.c2, h, w)


class C2fAttn(nn.Module):
    """C2f with a text-guided attention branch: ``cv1`` to 2c (c = c2 / 2),
    ``n`` Bottlenecks (3x3, 3x3, shortcut) chained on the second half, then
    ``attn`` (``MaxSigmoidAttnBlock``) on the last, all concatenated into
    ``cv2``. YAML row ``[c2, ec, nh]`` (c2 and ec width-scaled; the row's
    repeat count is ``n``)."""

    needs_guide = True

    def __init__(self, c1: int, c2: int, n: int = 1, ec: int = 128, nh: int = 1,
                 gc: int = 512):
        super().__init__()
        self.c, self.n = int(c2 * 0.5), n
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(self.c, self.c, True, 1, k=(3, 3), e=1.0))
        self.attn = MaxSigmoidAttnBlock(self.c, self.c, nh, ec, gc)
        self.cv2 = ConvBN((3 + n) * self.c, c2, 1, 1)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).chunk(2, dim=1))
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        ys.append(self.attn(ys[-1], guide))
        return self.cv2(torch.cat(ys, dim=1))  # torch.cat promotes, as jnp.concatenate


class WorldDetect(nn.Module):
    """The open-vocabulary detect head: per tap the Detect box branch (two
    3x3 ConvBNs to c2, a 1x1 conv with a bias to 4 * reg_max) and a text
    branch (a 3x3 ConvBN to c3 = max(ch[0], embed_dim), a 1x1 ConvBN
    without activation to ``embed_dim``, then ``ContrastiveHead``, or
    ``BNContrastiveHead`` with ``with_bn``, ``cv4_{i}_attn``). Returns a list
    of (box_map, cls_map) pairs, the class map (B, nt, H, W) for the guide's
    nt texts, both in the dtype their JAX concatenation takes."""

    needs_guide = True

    def __init__(self, embed_dim: int = 512, ch: tuple = (), reg_max: int = 16,
                 with_bn: bool = False):
        super().__init__()
        self.nl, self.reg_max, self.embed_dim = len(ch), reg_max, embed_dim
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], embed_dim)
        for i, c in enumerate(ch):
            setattr(self, f"cv2_{i}_0", ConvBN(c, c2, 3))
            setattr(self, f"cv2_{i}_1", ConvBN(c2, c2, 3))
            setattr(self, f"cv2_{i}_2", nn.Conv2d(c2, 4 * reg_max, 1))
            setattr(self, f"cv4_{i}_0", ConvBN(c, c3, 3))
            setattr(self, f"cv4_{i}_1", ConvBN(c3, embed_dim, 1, act=False))
            setattr(self, f"cv4_{i}_attn",
                    BNContrastiveHead(embed_dim) if with_bn else ContrastiveHead())

    def init_params(self, g: torch.Generator) -> None:
        for i in range(self.nl):
            conv = getattr(self, f"cv2_{i}_2")
            lecun_normal_(conv.weight, g)
            nn.init.zeros_(conv.bias)

    def forward(self, feats: Sequence[torch.Tensor], txt: torch.Tensor):
        outs = []
        for i, x in enumerate(feats):
            b = getattr(self, f"cv2_{i}_1")(getattr(self, f"cv2_{i}_0")(x))
            b = _conv(getattr(self, f"cv2_{i}_2"), b)
            e = getattr(self, f"cv4_{i}_1")(getattr(self, f"cv4_{i}_0")(x))
            cls = getattr(self, f"cv4_{i}_attn")(e, txt)
            dt = _promote(b, cls)
            outs.append((b.to(dt), cls.to(dt)))
        return outs
