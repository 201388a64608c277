"""Vision-LSTM (ViL) layers in torch.

Port of the layer-fused path of ``xlstm_yolo_tpu/nn/vil.py``: RMSNorm,
LayerNorm, MultiHeadLayerNorm, LinearHeadwiseExpand, SequenceConv2d,
MatrixLSTMCell, ViLLayer, ViLBlock and ViLBlockPair.
Sequences are (B, S, D) with tokens in row-major (H, W) order, as the JAX
NHWC reshape gives them. Submodule and parameter names follow the JAX tree
(``norm/scale``, ``proj_up``, ``conv/conv``, ``q_proj/weight``,
``mlstm_cell/igate``, ``mlstm_cell/outnorm``, ``learnable_skip``,
``proj_down``).

ViLLayer follows the JAX layer-fused branch: RMSNorm and the x_mlstm half of
proj_up run as torch ops to feed the depthwise conv, then
``kernels.vil_layer.vil_layer_fwd`` computes the rest of the layer from
(x, conv_act) — on the GPU in one hand-written kernel call, on the CPU
through its plain version. Under autograd, x's gradient sums the two paths,
as in JAX: the conv branch's (autograd through the torch ops) and the
layer function's own (its hand-written backward). Fork quirks kept:
forward-only traversal in the pair, no FFN, i-gate bias -10 and f-gate bias
linspace(3, 6) at init. ViLLayer's own non-fused cell path (drop_path) is
not ported. The xLSTM language model (``nn/xlstm.py``) uses the pieces on
their own: ``LinearHeadwiseExpand.forward``, ``LayerNorm`` and
``MatrixLSTMCell.forward`` on natural-layout q/k/v, which runs the chunkwise
mLSTM forward ``kernels.mlstm_fwd.mlstm_chunkwise_fwd``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.mlstm_fwd import mlstm_chunkwise_fwd
from ..kernels.vil_layer import vil_layer_fwd
from .modules import lecun_normal_


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps) * self.scale
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim without bias, under the residual
    convention: the stored ``scale`` starts at zero and the applied weight
    is ``1 + scale``."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + self.eps) * (1.0 + self.scale)
        return y.to(x.dtype)


class MultiHeadLayerNorm(nn.Module):
    """Per-head LayerNorm over DH of a (B, NH, S, DH) tensor with one
    (NH*DH,) affine, under the residual convention: the stored ``scale``
    starts at zero and the applied weight is ``1 + scale``.
    ``with_bias=False`` leaves the bias parameter out."""

    def __init__(self, num_heads: int, dim: int, eps: float = 1e-3, with_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if with_bias else None

    def affine(self):
        """(effective weight, bias), each (NH*DH,)."""
        weight = 1.0 + self.scale
        return weight, torch.zeros_like(weight) if self.bias is None else self.bias

    def forward(self, x):
        nh, dh = self.num_heads, x.shape[-1]
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        w, b = self.affine()
        return (y * w.reshape(1, nh, 1, dh) + b.reshape(1, nh, 1, dh)).to(x.dtype)


class LinearHeadwiseExpand(nn.Module):
    """Block-diagonal per-head projection: ``weight`` (NH, DH_out, DH_in) and,
    with ``use_bias``, ``bias`` (NH*DH,). The ViL layer function applies the
    projection itself from these parameters; ``forward`` applies it to a
    (..., dim) tensor for callers outside that function."""

    def __init__(self, dim: int, num_heads: int, use_bias: bool = True):
        super().__init__()
        dh = dim // num_heads
        self.weight = nn.Parameter(torch.empty(num_heads, dh, dh))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def forward(self, x):
        nh, dh = self.weight.shape[:2]
        y = torch.einsum("...nd,nod->...no", x.reshape(*x.shape[:-1], nh, dh), self.weight)
        y = y.reshape(x.shape)
        return y if self.bias is None else y + self.bias

    def init_params(self, g: torch.Generator) -> None:
        dh = self.weight.shape[-1]
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / 5.0 / dh), generator=g)


class SequenceConv2d(nn.Module):
    """Depthwise conv over the token grid of a (B, S, D) sequence."""

    def __init__(self, channels: int, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, kernel_size, padding=kernel_size // 2,
                              groups=channels, bias=True)

    def init_params(self, g: torch.Generator) -> None:
        lecun_normal_(self.conv.weight, g)
        nn.init.zeros_(self.conv.bias)

    def forward(self, x, seqlens):
        b, s, d = x.shape
        h, w = seqlens if seqlens is not None else (int(round(math.sqrt(s))),) * 2
        img = x.transpose(1, 2).reshape(b, d, h, w)  # token h*w + w -> (h, w)
        return self.conv(img).reshape(b, d, s).transpose(1, 2)


class MatrixLSTMCell(nn.Module):
    """The mLSTM cell: i/f gate projections over cat(q, k, v), the chunkwise
    mLSTM and the per-head outnorm. The ViL layer function runs the cell
    math itself from these parameters; ``forward`` runs it on natural-layout
    q/k/v for callers outside that function. ``igate_init``: ``"vil"``
    starts the input-gate bias at -10, ``"xlstm"`` draws it from N(0, 0.1).
    ``chunk_size`` sets the chunk length of the plain (CPU) path only."""

    def __init__(self, dim: int, num_heads: int, norm_eps: float = 1e-3, chunk_size: int = 64,
                 igate_act: str = "exp", norm_bias: bool = True, igate_init: str = "vil"):
        super().__init__()
        if igate_init not in ("vil", "xlstm"):
            raise ValueError(f"unknown igate_init {igate_init!r}")
        self.num_heads = num_heads
        self.chunk_size = chunk_size
        self.igate_act = igate_act
        self.igate_init = igate_init
        self.igate = nn.Linear(3 * dim, num_heads)
        self.fgate = nn.Linear(3 * dim, num_heads)
        self.outnorm = MultiHeadLayerNorm(num_heads, dim, eps=norm_eps, with_bias=norm_bias)

    def init_params(self, g: torch.Generator) -> None:
        nn.init.zeros_(self.igate.weight)
        nn.init.zeros_(self.fgate.weight)
        with torch.no_grad():
            if self.igate_init == "xlstm":
                self.igate.bias.normal_(0.0, 0.1, generator=g)
            else:
                self.igate.bias.fill_(-10.0)
            self.fgate.bias.copy_(torch.linspace(3.0, 6.0, self.fgate.bias.numel()))

    def forward(self, q, k, v):
        """q/k/v (B, S, D) -> (B, S, D): gate preacts from a Linear over
        cat(q, k, v), the chunkwise mLSTM per head, the per-head outnorm."""
        b, s, d = q.shape
        nh = self.num_heads
        qkv = torch.cat([q, k, v], dim=-1)
        i_pre = self.igate(qkv).transpose(1, 2)  # (B, NH, S)
        f_pre = self.fgate(qkv).transpose(1, 2)
        heads = lambda t: t.reshape(b, s, nh, d // nh).transpose(1, 2)
        h = mlstm_chunkwise_fwd(heads(q), heads(k), heads(v), i_pre, f_pre,
                                chunk_size=self.chunk_size, igate_act=self.igate_act)
        return self.outnorm(h.to(q.dtype)).transpose(1, 2).reshape(b, s, d)


class ViLLayer(nn.Module):
    """The ViL mixing layer on (B, S, D); see the module docstring.
    ``chunk_size`` sets the chunk length of the plain (CPU) path only; the
    CUDA kernel walks chunks of its own fixed length."""

    def __init__(self, dim: int, direction: str = "forward", expansion: int = 2,
                 qkv_block_size: int = 4, conv_kernel_size: int = 3, seqlens=None,
                 chunk_size: int = 64, igate_act: str = "exp"):
        super().__init__()
        inner = expansion * dim
        self.dim, self.inner = dim, inner
        self.num_heads = inner // qkv_block_size
        self.direction = direction
        self.seqlens = seqlens
        self.chunk_size = chunk_size
        self.igate_act = igate_act
        self.norm = RMSNorm(dim)
        self.proj_up = nn.Linear(dim, 2 * inner)
        self.conv = SequenceConv2d(inner, conv_kernel_size)
        self.q_proj = LinearHeadwiseExpand(inner, self.num_heads)
        self.k_proj = LinearHeadwiseExpand(inner, self.num_heads)
        self.v_proj = LinearHeadwiseExpand(inner, self.num_heads)
        self.mlstm_cell = MatrixLSTMCell(inner, self.num_heads)
        self.learnable_skip = nn.Parameter(torch.ones(inner))
        self.proj_down = nn.Linear(inner, dim)

    def init_params(self, g: torch.Generator) -> None:
        for lin in (self.proj_up, self.proj_down):
            nn.init.xavier_uniform_(lin.weight, generator=g)
            nn.init.zeros_(lin.bias)

    def forward(self, x, seqlens=None):
        seqlens = seqlens if seqlens is not None else self.seqlens
        backward = self.direction == "backward"
        xs = x.flip(1) if backward else x
        inner = self.inner
        xm = F.linear(self.norm(xs), self.proj_up.weight[:inner], self.proj_up.bias[:inner])
        conv_act = F.silu(self.conv(xm, seqlens))
        cell = self.mlstm_cell
        nscale, nbias = cell.outnorm.affine()
        out = vil_layer_fwd(
            xs, conv_act, self.norm.scale, self.proj_up.weight.t(), self.proj_up.bias,
            self.q_proj.weight, self.q_proj.bias, self.k_proj.weight, self.k_proj.bias,
            self.v_proj.weight, self.v_proj.bias, cell.igate.weight.t(), cell.igate.bias,
            cell.fgate.weight.t(), cell.fgate.bias, nscale, nbias, self.learnable_skip,
            self.proj_down.weight.t(), self.proj_down.bias, self.num_heads,
            chunk_size=self.chunk_size, igate_act=self.igate_act,
            eps=1e-6, norm_eps=cell.outnorm.eps, rms_eps=self.norm.eps)
        return out.flip(1) if backward else out


class ViLBlock(nn.Module):
    """One traversal direction; the layer carries its own norm and residual."""

    def __init__(self, dim: int, direction: str = "forward", **kw):
        super().__init__()
        self.layer = ViLLayer(dim, direction=direction, **kw)

    def forward(self, x, seqlens=None):
        return self.layer(x, seqlens)


class ViLBlockPair(nn.Module):
    """Forward (+ backward when ``bidirectional``) traversal pair. The fork
    runs only the forward direction, which is the default."""

    def __init__(self, dim: int, qkv_block_size: int = 16, seqlens=None, chunk_size: int = 64,
                 conv_kernel_size: int = 3, igate_act: str = "exp", bidirectional: bool = False):
        super().__init__()
        kw = dict(qkv_block_size=qkv_block_size, seqlens=seqlens, chunk_size=chunk_size,
                  conv_kernel_size=conv_kernel_size, igate_act=igate_act)
        self.fwd = ViLBlock(dim, "forward", **kw)
        self.bwd = ViLBlock(dim, "backward", **kw) if bidirectional else None

    def forward(self, x, seqlens=None):  # (B, S, D) or (B, ..., D)
        shp = x.shape
        x = x.reshape(shp[0], -1, shp[-1])
        y = self.fwd(x, seqlens)
        if self.bwd is not None:
            y = self.bwd(y, seqlens)
        return y.reshape(shp)
