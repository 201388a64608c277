"""Vision-LSTM (ViL) layers in torch.

Port of ``xlstm_yolo_tpu/nn/vil.py``: RMSNorm, LayerNorm, AffineLayerNorm,
MultiHeadLayerNorm, LinearHeadwiseExpand, SequenceConv2d, DropPath,
MatrixLSTMCell, ViLLayer, ViLBlock, ViLBlockPair, VitPatchEmbed,
VitPosEmbed2d and VisionLSTMBackbone.
Sequences are (B, S, D) with tokens in row-major (H, W) order, as the JAX
NHWC reshape gives them. Submodule and parameter names follow the JAX tree
(``norm/scale``, ``proj_up``, ``conv/conv``, ``q_proj/weight``,
``mlstm_cell/igate``, ``mlstm_cell/outnorm``, ``learnable_skip``,
``proj_down``).

ViLLayer has the JAX layer's two branches. The layer-fused one: RMSNorm and
the x_mlstm half of proj_up run as torch ops to feed the depthwise conv,
then ``kernels.vil_layer.vil_layer_fwd`` computes the rest of the layer
from (x, conv_act) — on the GPU in one hand-written kernel call, on the CPU
through its plain version. Under autograd, x's gradient sums the two paths,
as in JAX: the conv branch's (autograd through the torch ops) and the
layer function's own (its hand-written backward). That function adds the
residual itself, so a layer under stochastic depth (train mode and
``drop_path`` > 0) takes the other branch: full proj_up, conv, the cell
function ``kernels.vil_cell.vil_cell_fwd`` (its own kernel on the GPU),
then outnorm, skip, SiLU(z) gate, proj_down, ``DropPath`` and the residual
as torch ops. Randomness is explicit: such a forward takes a
``torch.Generator`` and never reads the global random state.
``ViLLayer.forward_conv_fused`` is a third entry, which no model calls (as
in the JAX package): the conv-fused function
``kernels.vil_conv.vil_layer_conv_fwd`` computes the whole layer, the conv
branch included, from x alone. Fork quirks
kept: forward-only traversal in the pair, no FFN, i-gate bias -10 and
f-gate bias linspace(3, 6) at init. The xLSTM language model
(``nn/xlstm.py``) uses the pieces on their own:
``LinearHeadwiseExpand.forward``, ``LayerNorm`` and
``MatrixLSTMCell.forward`` on natural-layout q/k/v, which runs the chunkwise
mLSTM forward ``kernels.mlstm_fwd.mlstm_chunkwise_fwd``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.mlstm_fwd import mlstm_chunkwise_fwd
from ..kernels.vil_block import vil_block_fwd
from ..kernels.vil_cell import vil_cell_fwd
from ..kernels.vil_conv import vil_layer_conv_fwd
from ..kernels.vil_layer import vil_layer_fwd
from ..utils import resolve_device
from .modules import conv_in_dtype, init_tree, lecun_normal_, linear_in_dtype


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def init_params(self, g: torch.Generator) -> None:
        nn.init.ones_(self.scale)

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

    def init_params(self, g: torch.Generator) -> None:
        nn.init.zeros_(self.scale)

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + self.eps) * (1.0 + self.scale)
        return y.to(x.dtype)


class AffineLayerNorm(nn.Module):
    """flax's ``nn.LayerNorm``: eps 1e-6, a plain ``scale`` (one at init,
    applied as it is) and a ``bias``. Not ``LayerNorm`` above, which is the
    language model's (``1 + scale``, eps 1e-5, no bias)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def init_params(self, g: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        y = F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias, self.eps)
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

    def init_params(self, g: torch.Generator) -> None:
        nn.init.zeros_(self.scale)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

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
        y = torch.einsum("...nd,nod->...no", x.reshape(*x.shape[:-1], nh, dh),
                         self.weight.to(x.dtype))
        y = y.reshape(x.shape)
        return y if self.bias is None else y + self.bias.to(x.dtype)

    def init_params(self, g: torch.Generator) -> None:
        dh = self.weight.shape[-1]
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / 5.0 / dh), generator=g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


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
        return conv_in_dtype(self.conv, img).reshape(b, d, s).transpose(1, 2)


class DropPath(nn.Module):
    """Stochastic depth over a residual branch: in train mode each sample's
    whole branch is dropped with probability ``rate`` and the survivors are
    divided by ``1 - rate``; the identity in eval mode or at rate 0. The
    mask is one draw of ``torch.rand(B, generator=generator) < 1 - rate`` on
    the generator's device; without a generator an active DropPath raises
    (nothing reads the global random state)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: torch.Generator | None = None):
        if self.rate <= 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("DropPath in train mode needs a torch.Generator")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape[0], generator=generator, device=generator.device) < keep
        mask = mask.to(x.device).reshape(-1, *([1] * (x.dim() - 1)))
        return torch.where(mask, x / keep, torch.zeros_like(x))


class MatrixLSTMCell(nn.Module):
    """The mLSTM cell: i/f gate projections over cat(q, k, v), the chunkwise
    mLSTM and the per-head outnorm. The ViL layer function runs the cell
    math itself from these parameters; ``forward`` runs it on natural-layout
    q/k/v for callers outside that function, ``forward_cell`` and
    ``forward_block`` through the cell and block functions (the JAX cell's
    ``fused=`` and ``fused_block=`` entries). ``igate_init``: ``"vil"``
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

    def cell_args(self, q_proj, k_proj, v_proj):
        """The ten weights and biases the cell, block and layer functions
        take after their activations, in the JAX entries' layouts."""
        return (q_proj.weight, q_proj.bias, k_proj.weight, k_proj.bias, v_proj.weight,
                v_proj.bias, self.igate.weight.t(), self.igate.bias, self.fgate.weight.t(),
                self.fgate.bias)

    def forward_cell(self, conv_act, x_mlstm, q_proj, k_proj, v_proj):
        """conv_act, x_mlstm (B, S, D) and the three headwise projections
        -> (B, S, D): the cell function (projections, gate dots and mLSTM
        in one kernel call on the GPU), then the per-head outnorm."""
        b, s, d = conv_act.shape
        h = vil_cell_fwd(conv_act, x_mlstm, *self.cell_args(q_proj, k_proj, v_proj),
                         self.num_heads, chunk_size=self.chunk_size, igate_act=self.igate_act)
        h = h.to(conv_act.dtype).reshape(b, s, self.num_heads, -1).transpose(1, 2)
        return self.outnorm(h).transpose(1, 2).reshape(b, s, d)

    def forward_block(self, conv_act, x_mlstm, z, x_res, q_proj, k_proj, v_proj, skip,
                      proj_down):
        """The whole branch through the block function: the cell, the
        outnorm, ``skip`` (D,), the SiLU(z) gate, ``proj_down`` (an
        ``nn.Linear``) and the residual ``x_res`` -> (B, S, DIM)."""
        nscale, nbias = self.outnorm.affine()
        out = vil_block_fwd(conv_act, x_mlstm, z, x_res,
                            *self.cell_args(q_proj, k_proj, v_proj), nscale, nbias, skip,
                            proj_down.weight.t(), proj_down.bias, self.num_heads,
                            chunk_size=self.chunk_size, igate_act=self.igate_act,
                            norm_eps=self.outnorm.eps)
        return out.to(conv_act.dtype)


class ViLLayer(nn.Module):
    """The ViL mixing layer on (B, S, D); see the module docstring.
    ``chunk_size`` sets the chunk length of the plain (CPU) path only; the
    CUDA kernel walks chunks of its own fixed length."""

    def __init__(self, dim: int, direction: str = "forward", expansion: int = 2,
                 qkv_block_size: int = 4, conv_kernel_size: int = 3, seqlens=None,
                 chunk_size: int = 64, igate_act: str = "exp", drop_path: float = 0.0):
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
        self.mlstm_cell = MatrixLSTMCell(inner, self.num_heads, chunk_size=chunk_size,
                                         igate_act=igate_act)
        self.drop_path = DropPath(drop_path)
        self.learnable_skip = nn.Parameter(torch.ones(inner))
        self.proj_down = nn.Linear(inner, dim)

    def init_params(self, g: torch.Generator) -> None:
        for lin in (self.proj_up, self.proj_down):
            nn.init.xavier_uniform_(lin.weight, generator=g)
            nn.init.zeros_(lin.bias)
        nn.init.ones_(self.learnable_skip)

    def forward(self, x, seqlens=None, generator: torch.Generator | None = None):
        seqlens = seqlens if seqlens is not None else self.seqlens
        backward = self.direction == "backward"
        if self.training and self.drop_path.rate > 0.0:
            return self._forward_drop_path(x, seqlens, backward, generator)
        xs = x.flip(1) if backward else x
        inner = self.inner
        xm = linear_in_dtype(self.norm(xs), self.proj_up.weight[:inner],
                             self.proj_up.bias[:inner])
        conv_act = F.silu(self.conv(xm, seqlens))
        cell = self.mlstm_cell
        nscale, nbias = cell.outnorm.affine()
        out = vil_layer_fwd(
            xs, conv_act, self.norm.scale, self.proj_up.weight.t(), self.proj_up.bias,
            *cell.cell_args(self.q_proj, self.k_proj, self.v_proj), nscale, nbias,
            self.learnable_skip, self.proj_down.weight.t(), self.proj_down.bias, self.num_heads,
            chunk_size=self.chunk_size, igate_act=self.igate_act,
            eps=1e-6, norm_eps=cell.outnorm.eps, rms_eps=self.norm.eps)
        return out.flip(1) if backward else out

    def forward_conv_fused(self, x, seqlens=None):
        """The layer through the conv-fused function (the JAX package's v4
        entry, which its layer does not call either): the layer's own
        parameters go to ``kernels.vil_conv.vil_layer_conv_fwd``, which
        computes RMSNorm, proj_up, the depthwise conv and the rest from x
        alone, on the GPU in hand-written kernels. Equals ``forward`` without
        stochastic depth; ``seqlens`` (H, W) is required here or at
        construction."""
        seqlens = seqlens if seqlens is not None else self.seqlens
        if seqlens is None:
            raise ValueError("forward_conv_fused needs the (H, W) token grid")
        backward = self.direction == "backward"
        xs = x.flip(1) if backward else x
        cell = self.mlstm_cell
        nscale, nbias = cell.outnorm.affine()
        out = vil_layer_conv_fwd(
            xs, self.norm.scale, self.proj_up.weight.t(), self.proj_up.bias,
            self.conv.conv.weight, self.conv.conv.bias,
            *cell.cell_args(self.q_proj, self.k_proj, self.v_proj), nscale, nbias,
            self.learnable_skip, self.proj_down.weight.t(), self.proj_down.bias, self.num_heads,
            tuple(seqlens), chunk_size=self.chunk_size, igate_act=self.igate_act,
            eps=1e-6, norm_eps=cell.outnorm.eps, rms_eps=self.norm.eps)
        out = out.to(x.dtype)
        return out.flip(1) if backward else out

    def _forward_drop_path(self, x, seqlens, backward: bool, generator):
        """The branch under stochastic depth: the residual is added after
        ``DropPath``, so the cell function stands where the layer function
        stood and the tail runs as torch ops."""
        y = self.norm(x)
        x_mlstm, z = linear_in_dtype(y.flip(1) if backward else y, self.proj_up.weight,
                                     self.proj_up.bias).split(self.inner, dim=-1)
        conv_act = F.silu(self.conv(x_mlstm, seqlens))
        h = self.mlstm_cell.forward_cell(conv_act, x_mlstm, self.q_proj, self.k_proj,
                                         self.v_proj)
        h = h + self.learnable_skip.to(h.dtype) * conv_act
        out = linear_in_dtype(h * F.silu(z), self.proj_down.weight, self.proj_down.bias)
        return x + self.drop_path(out.flip(1) if backward else out, generator)


class ViLBlock(nn.Module):
    """One traversal direction; the layer carries its own norm and residual."""

    def __init__(self, dim: int, direction: str = "forward", **kw):
        super().__init__()
        self.layer = ViLLayer(dim, direction=direction, **kw)

    def forward(self, x, seqlens=None, generator: torch.Generator | None = None):
        return self.layer(x, seqlens, generator)


class ViLBlockPair(nn.Module):
    """Forward (+ backward when ``bidirectional``) traversal pair. The fork
    runs only the forward direction, which is the default."""

    def __init__(self, dim: int, qkv_block_size: int = 16, seqlens=None, chunk_size: int = 64,
                 conv_kernel_size: int = 3, igate_act: str = "exp", bidirectional: bool = False,
                 drop_path: float = 0.0):
        super().__init__()
        kw = dict(qkv_block_size=qkv_block_size, seqlens=seqlens, chunk_size=chunk_size,
                  conv_kernel_size=conv_kernel_size, igate_act=igate_act, drop_path=drop_path)
        self.fwd = ViLBlock(dim, "forward", **kw)
        self.bwd = ViLBlock(dim, "backward", **kw) if bidirectional else None

    def forward(self, x, seqlens=None, generator: torch.Generator | None = None):
        shp = x.shape  # (B, S, D) or (B, ..., D)
        x = x.reshape(shp[0], -1, shp[-1])
        y = self.fwd(x, seqlens, generator)
        if self.bwd is not None:
            y = self.bwd(y, seqlens, generator)
        return y.reshape(shp)


class VitPatchEmbed(nn.Module):
    """Strided-conv patch embedding of an NHWC image: (B, H, W, C) ->
    (B, H/P, W/P, dim). The 1-D and 3-D (video) ranks of the JAX module are
    not ported."""

    def __init__(self, dim: int, patch_size: int = 16, in_channels: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch_size, stride=patch_size)

    def init_params(self, g: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.proj.weight, generator=g)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x):
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class VitPosEmbed2d(nn.Module):
    """Learnable 2-D position embedding ``embed`` (1, h, w, dim), added to a
    (B, h, w, dim) grid. The JAX module resizes it bicubically (Keys kernel,
    a = -0.5, antialiased when shrinking) for another grid; torch's bicubic
    interpolation differs (a = -0.75), so another grid raises here."""

    def __init__(self, dim: int, seqlens: tuple = (14, 14)):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(1, *seqlens, dim))

    def init_params(self, g: torch.Generator) -> None:
        nn.init.trunc_normal_(self.embed, 0.0, 0.02, -0.04, 0.04, generator=g)

    def forward(self, x):
        if x.shape[1:3] != self.embed.shape[1:3]:
            raise NotImplementedError(
                f"VitPosEmbed2d: grid {tuple(x.shape[1:3])} differs from the embedding's "
                f"{tuple(self.embed.shape[1:3])}; the bicubic resize is not ported")
        return x + self.embed.to(x.dtype)


class VisionLSTMBackbone(nn.Module):
    """ViL backbone emitting multi-scale partials: patch embed -> position
    embed -> ``depth`` ViLBlockPairs, collecting the normed sequence at
    ``output_indices`` as (B, h, w, dim) maps, the final one appended last.
    ``VisionLSTMBackbone(192, device="cuda")``: the model on ``device`` in
    eval mode, weights drawn from ``seed`` with the JAX package's init
    scheme. ``forward`` takes NHWC images at ``resolution``."""

    def __init__(self, dim: int, depth: int = 12, patch_size: int = 16,
                 resolution: tuple = (224, 224), output_indices: tuple = (),
                 qkv_block_size: int = 16, chunk_size: int = 64, igate_act: str = "exp",
                 bidirectional: bool = False, device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.depth, self.output_indices = depth, tuple(output_indices)
        seqlens = (resolution[0] // patch_size, resolution[1] // patch_size)
        self.patch_embed = VitPatchEmbed(dim, patch_size)
        self.pos_embed = VitPosEmbed2d(dim, seqlens)
        for i in range(depth):
            self.add_module(f"block{i}", ViLBlockPair(
                dim, qkv_block_size=qkv_block_size, seqlens=seqlens, chunk_size=chunk_size,
                igate_act=igate_act, bidirectional=bidirectional))
        self.norm = AffineLayerNorm(dim)
        init_tree(self, seed)
        self.eval()
        self.to(dev)

    def forward(self, x):
        x = self.pos_embed(self.patch_embed(x))
        b, h, w, d = x.shape
        x = x.reshape(b, h * w, d)
        outs = []
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, (h, w))
            if i in self.output_indices:
                outs.append(self.norm(x).reshape(b, h, w, d))
        outs.append(self.norm(x).reshape(b, h, w, d))
        return outs
