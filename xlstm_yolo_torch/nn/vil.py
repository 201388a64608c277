"""Vision-LSTM (ViL) layers in torch.

Port of ``xlstm_yolo_tpu/nn/vil.py``: RMSNorm, LayerNorm, AffineLayerNorm,
MultiHeadLayerNorm (both weight conventions), LinearHeadwiseExpand,
SequenceConv2d, SequenceConv3d, DropPath, MatrixLSTMCell, FeedForward,
ViLLayer, ViLBlock, ViLBlockPair, VitPatchEmbed (1-D, 2-D and 3-D inputs),
VitPosEmbed1d, VitPosEmbed2d, VitPosEmbed3d (each with the JAX resize to
another grid: linear, bicubic, trilinear) and VisionLSTMBackbone.
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
``mlstm_backend`` is the JAX layer's key: ``"auto"`` (the default) and
``"pallas"`` take the functions above, which run the hand-written kernels
on the card (``"pallas"`` refuses a CPU tensor, where there is no kernel);
``"native"`` runs their plain torch versions (``vil_layer_ref``,
``vil_cell_plain``, ``vil_layer_conv_plain``) on any device, differentiated
by autograd, because the user asked for them. Head dims 4, 8, 16, 32 and
64 have kernels; another head dim raises on the card unless the user asks
for ``"native"``.
``ViLLayer.forward_conv_fused`` is a third entry, which no model calls (as
in the JAX package): the conv-fused function
``kernels.vil_conv.vil_layer_conv_fwd`` computes the whole layer, the conv
branch included, from x alone. Fork quirks
kept: forward-only traversal in the pair, no FFN, i-gate bias -10 and
f-gate bias linspace(3, 6) at init. The JAX layer's options are taken with
its defaults: ``proj_bias=False`` leaves every bias of proj_up, the three
headwise projections and proj_down out of the tree (the layer functions
read zero vectors, non-persistent buffers of the layer); ``conv_kind`` is
accepted and read nowhere, as in JAX; ``use_outnorm=False`` (also on the
cell, ViLBlock and ViLBlockPair) skips the cell's per-head outnorm and leaves
its parameters out, as the JAX layer's native branch and the fork do, in
every branch: the layer function (its kernels' tail without the norm), the
stochastic-depth branch, ``forward_conv_fused`` and the block entry. The
xLSTM language model
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
from ..kernels.vil_cell import vil_cell_fwd, vil_cell_plain
from ..kernels.vil_conv import vil_layer_conv_fwd, vil_layer_conv_plain
from ..kernels.vil_layer import vil_layer_fwd, vil_layer_ref
from ..ops.letterbox import resize
from ..utils import resolve_device
from .modules import (conv_in_dtype, init_tree, lecun_normal_, linear_in_dtype, small_init_,
                      wang_init_)

BACKENDS = ("auto", "pallas", "native")  # the JAX ViLLayer's mlstm_backend values


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
    applied as it is) and, unless ``use_bias=False``, a ``bias``. Not
    ``LayerNorm`` above, which is the language model's (``1 + scale``, eps
    1e-5, no bias)."""

    def __init__(self, dim: int, eps: float = 1e-6, use_bias: bool = True):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def init_params(self, g: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        y = F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias, self.eps)
        return y.to(x.dtype)


class MultiHeadLayerNorm(nn.Module):
    """Per-head LayerNorm over DH of a (B, NH, S, DH) tensor with one
    (NH*DH,) affine. ``residual`` (the ViL fork's convention): the stored
    ``scale`` starts at zero and the applied weight is ``1 + scale``;
    ``residual=False`` (the xLSTM-7B family's): ``scale`` starts at one and
    is applied as it is. ``with_bias=False`` leaves the bias parameter out."""

    def __init__(self, num_heads: int, dim: int, eps: float = 1e-3, with_bias: bool = True,
                 residual: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.eps = eps
        self.residual = residual
        self.scale = nn.Parameter(torch.zeros(dim) if residual else torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if with_bias else None

    def init_params(self, g: torch.Generator) -> None:
        (nn.init.zeros_ if self.residual else nn.init.ones_)(self.scale)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def affine(self):
        """(effective weight, bias), each (NH*DH,)."""
        weight = 1.0 + self.scale if self.residual else self.scale
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
    """Conv over the token grid of a (B, S, D) sequence -> (B, S', out):
    depthwise and stride 1 by default (the ViL layer's); ``out_channels``,
    ``stride``, ``padding`` and ``groups`` as the JAX module takes them (a
    square grid when ``seqlens`` is None)."""

    def __init__(self, channels: int, kernel_size: int = 3, out_channels: int | None = None,
                 stride: int = 1, padding: int | None = None, groups: int | None = None):
        super().__init__()
        out = channels if out_channels is None else out_channels
        self.conv = nn.Conv2d(channels, out, kernel_size, stride,
                              kernel_size // 2 if padding is None else padding,
                              groups=channels if groups is None else groups, bias=True)

    def init_params(self, g: torch.Generator) -> None:
        lecun_normal_(self.conv.weight, g)
        nn.init.zeros_(self.conv.bias)

    def forward(self, x, seqlens):
        b, s, d = x.shape
        h, w = seqlens if seqlens is not None else (int(round(math.sqrt(s))),) * 2
        img = x.transpose(1, 2).reshape(b, d, h, w)  # token h*w + w -> (h, w)
        y = conv_in_dtype(self.conv, img)
        return y.reshape(b, y.shape[1], -1).transpose(1, 2)


class SequenceConv3d(nn.Module):
    """Conv over the (T, H, W) token grid of a (B, S, D) sequence -> (B, S',
    out), the video-token variant: a full conv (``groups`` 1) with padding
    kernel_size // 2, ``seqlens`` = (T, H, W) required."""

    def __init__(self, channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 groups: int = 1, use_bias: bool = True, seqlens: tuple | None = None):
        super().__init__()
        if seqlens is None or len(seqlens) != 3:
            raise ValueError("SequenceConv3d needs seqlens=(T, H, W)")
        self.seqlens = tuple(seqlens)
        self.conv = nn.Conv3d(channels, out_channels, kernel_size, stride, kernel_size // 2,
                              groups=groups, bias=use_bias)

    def init_params(self, g: torch.Generator) -> None:
        lecun_normal_(self.conv.weight, g)
        if self.conv.bias is not None:
            nn.init.zeros_(self.conv.bias)

    def forward(self, x):
        b, s, d = x.shape
        vid = x.transpose(1, 2).reshape(b, d, *self.seqlens)
        w = self.conv.weight.to(x.dtype)
        y = F.conv3d(vid, w, None, self.conv.stride, self.conv.padding, 1, self.conv.groups)
        if self.conv.bias is not None:
            y = y + self.conv.bias.to(x.dtype).reshape(1, -1, 1, 1, 1)
        return y.reshape(b, y.shape[1], -1).transpose(1, 2)


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
    ``chunk_size`` sets the chunk length of the plain (CPU) path only.
    ``use_outnorm=False``: no outnorm, and no ``outnorm`` parameters."""

    def __init__(self, dim: int, num_heads: int, norm_eps: float = 1e-3, chunk_size: int = 64,
                 igate_act: str = "exp", norm_bias: bool = True, igate_init: str = "vil",
                 use_outnorm: bool = True):
        super().__init__()
        if igate_init not in ("vil", "xlstm"):
            raise ValueError(f"unknown igate_init {igate_init!r}")
        self.num_heads = num_heads
        self.chunk_size = chunk_size
        self.igate_act = igate_act
        self.igate_init = igate_init
        self.norm_eps = norm_eps
        self.igate = nn.Linear(3 * dim, num_heads)
        self.fgate = nn.Linear(3 * dim, num_heads)
        self.outnorm = (MultiHeadLayerNorm(num_heads, dim, eps=norm_eps, with_bias=norm_bias)
                        if use_outnorm else None)

    def init_params(self, g: torch.Generator) -> None:
        nn.init.zeros_(self.igate.weight)
        nn.init.zeros_(self.fgate.weight)
        with torch.no_grad():
            if self.igate_init == "xlstm":
                self.igate.bias.normal_(0.0, 0.1, generator=g)
            else:
                self.igate.bias.fill_(-10.0)
            self.fgate.bias.copy_(torch.linspace(3.0, 6.0, self.fgate.bias.numel()))

    def _outnorm(self, h):  # (B, NH, S, DH)
        return h if self.outnorm is None else self.outnorm(h)

    def affine(self):
        """The outnorm's (effective weight, bias), or (None, None) without it."""
        return (None, None) if self.outnorm is None else self.outnorm.affine()

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
        return self._outnorm(h.to(q.dtype)).transpose(1, 2).reshape(b, s, d)

    def cell_args(self, q_proj, k_proj, v_proj, zeros=None):
        """The ten weights and biases the cell, block and layer functions
        take after their activations, in the JAX entries' layouts; a
        projection without bias gives the first NH*DH of ``zeros`` in its
        place."""
        bias = lambda m: zeros[:m.weight.shape[0] * m.weight.shape[1]] if m.bias is None else m.bias
        return (q_proj.weight, bias(q_proj), k_proj.weight, bias(k_proj), v_proj.weight,
                bias(v_proj), self.igate.weight.t(), self.igate.bias, self.fgate.weight.t(),
                self.fgate.bias)

    def forward_cell(self, conv_act, x_mlstm, q_proj, k_proj, v_proj, cell_fn=vil_cell_fwd,
                     zeros=None):
        """conv_act, x_mlstm (B, S, D) and the three headwise projections
        -> (B, S, D): the cell function ``cell_fn`` (projections, gate dots
        and mLSTM in one kernel call on the GPU; ``vil_cell_plain`` where the
        layer asks for the plain version), then the per-head outnorm.
        ``zeros`` as ``cell_args`` takes it."""
        b, s, d = conv_act.shape
        h = cell_fn(conv_act, x_mlstm, *self.cell_args(q_proj, k_proj, v_proj, zeros),
                    self.num_heads, chunk_size=self.chunk_size, igate_act=self.igate_act)
        h = h.to(conv_act.dtype).reshape(b, s, self.num_heads, -1).transpose(1, 2)
        return self._outnorm(h).transpose(1, 2).reshape(b, s, d)

    def forward_block(self, conv_act, x_mlstm, z, x_res, q_proj, k_proj, v_proj, skip,
                      proj_down, zeros=None):
        """The whole branch through the block function: the cell, the
        outnorm, ``skip`` (D,), the SiLU(z) gate, ``proj_down`` (an
        ``nn.Linear``) and the residual ``x_res`` -> (B, S, DIM). ``zeros``
        (at least D and DIM long) stands for every missing bias."""
        nscale, nbias = self.affine()
        bd = zeros[:proj_down.weight.shape[0]] if proj_down.bias is None else proj_down.bias
        out = vil_block_fwd(conv_act, x_mlstm, z, x_res,
                            *self.cell_args(q_proj, k_proj, v_proj, zeros), nscale, nbias,
                            skip, proj_down.weight.t(), bd, self.num_heads,
                            chunk_size=self.chunk_size, igate_act=self.igate_act,
                            norm_eps=self.norm_eps, use_outnorm=self.outnorm is not None)
        return out.to(conv_act.dtype)


class FeedForward(nn.Module):
    """SwiGLU feed-forward: ``proj_up`` to (gate, up), silu(gate) * up,
    ``proj_down``; the up width ``proj_factor * dim`` rounded up to a
    multiple of ``round_up_to``; small init for proj_up, Wang init over
    ``num_blocks`` for proj_down."""

    def __init__(self, dim: int, proj_factor: float = 2.6667, round_up_to: int = 64,
                 use_bias: bool = True, num_blocks: int = 1):
        super().__init__()
        up = int(proj_factor * dim)
        self.up = (up + round_up_to - 1) // round_up_to * round_up_to
        self.dim, self.num_blocks = dim, num_blocks
        self.proj_up = nn.Linear(dim, 2 * self.up, bias=use_bias)
        self.proj_down = nn.Linear(self.up, dim, bias=use_bias)

    def init_params(self, g: torch.Generator) -> None:
        small_init_(self.proj_up.weight, self.dim, g)
        wang_init_(self.proj_down.weight, self.dim, self.num_blocks, g)
        for lin in (self.proj_up, self.proj_down):
            if lin.bias is not None:
                nn.init.zeros_(lin.bias)

    def forward(self, x):
        gate, up = linear_in_dtype(x, self.proj_up.weight, self.proj_up.bias).split(self.up, -1)
        return linear_in_dtype(F.silu(gate) * up, self.proj_down.weight, self.proj_down.bias)


class ViLLayer(nn.Module):
    """The ViL mixing layer on (B, S, D); see the module docstring.
    ``chunk_size`` sets the chunk length of the plain (CPU) path only; the
    CUDA kernel walks chunks of its own fixed length."""

    def __init__(self, dim: int, direction: str = "forward", expansion: int = 2,
                 qkv_block_size: int = 4, proj_bias: bool = True, conv_kind: str = "2d",
                 conv_kernel_size: int = 3, seqlens=None, chunk_size: int = 64,
                 igate_act: str = "exp", drop_path: float = 0.0, mlstm_backend: str = "auto",
                 use_outnorm: bool = True):
        super().__init__()
        if mlstm_backend not in BACKENDS:
            raise ValueError(f"ViLLayer: mlstm_backend {mlstm_backend!r} is not one of {BACKENDS}")
        self.mlstm_backend = mlstm_backend
        inner = expansion * dim
        self.dim, self.inner = dim, inner
        self.num_heads = inner // qkv_block_size
        self.direction = direction
        self.conv_kind = conv_kind  # read nowhere, as in the JAX layer
        self.seqlens = seqlens
        self.chunk_size = chunk_size
        self.igate_act = igate_act
        self.norm = RMSNorm(dim)
        self.proj_up = nn.Linear(dim, 2 * inner, bias=proj_bias)
        self.conv = SequenceConv2d(inner, conv_kernel_size)
        self.q_proj = LinearHeadwiseExpand(inner, self.num_heads, use_bias=proj_bias)
        self.k_proj = LinearHeadwiseExpand(inner, self.num_heads, use_bias=proj_bias)
        self.v_proj = LinearHeadwiseExpand(inner, self.num_heads, use_bias=proj_bias)
        self.mlstm_cell = MatrixLSTMCell(inner, self.num_heads, chunk_size=chunk_size,
                                         igate_act=igate_act, use_outnorm=use_outnorm)
        self.drop_path = DropPath(drop_path)
        self.learnable_skip = nn.Parameter(torch.ones(inner))
        self.proj_down = nn.Linear(inner, dim, bias=proj_bias)
        # what the layer functions read for the biases proj_bias=False leaves out
        self.register_buffer("zeros", None if proj_bias else torch.zeros(max(2 * inner, dim)),
                             persistent=False)

    def init_params(self, g: torch.Generator) -> None:
        for lin in (self.proj_up, self.proj_down):
            nn.init.xavier_uniform_(lin.weight, generator=g)
            if lin.bias is not None:
                nn.init.zeros_(lin.bias)
        nn.init.ones_(self.learnable_skip)

    def _bias(self, lin: nn.Linear):
        """``lin``'s bias, or zeros of its width without one."""
        return self.zeros[:lin.weight.shape[0]] if lin.bias is None else lin.bias

    def _tail_args(self):
        """The outnorm affine, skip, proj_down's weight (INNER, DIM) and bias:
        the layer functions' arguments after the cell's."""
        nscale, nbias = self.mlstm_cell.affine()
        return (nscale, nbias, self.learnable_skip, self.proj_down.weight.t(),
                self._bias(self.proj_down))

    def _fn_kw(self):
        """The keywords every layer function takes from the layer."""
        cell = self.mlstm_cell
        return dict(chunk_size=self.chunk_size, igate_act=self.igate_act, eps=1e-6,
                    norm_eps=cell.norm_eps, rms_eps=self.norm.eps,
                    use_outnorm=cell.outnorm is not None)

    def _function(self, kernel, plain, x):
        """The layer function ``mlstm_backend`` asks for: ``plain`` for
        "native", else ``kernel`` (which launches the CUDA kernel on the card
        and takes its plain version on the CPU); "pallas" refuses the CPU."""
        if self.mlstm_backend == "native":
            return plain
        if self.mlstm_backend == "pallas" and x.device.type != "cuda":
            raise ValueError(f"ViLLayer: mlstm_backend 'pallas' runs the CUDA kernels, and the "
                             f"input is on {x.device}; use 'auto' or 'native' there")
        return kernel

    def forward(self, x, seqlens=None, generator: torch.Generator | None = None):
        seqlens = seqlens if seqlens is not None else self.seqlens
        backward = self.direction == "backward"
        if self.training and self.drop_path.rate > 0.0:
            return self._forward_drop_path(x, seqlens, backward, generator)
        xs = x.flip(1) if backward else x
        inner = self.inner
        bu = self._bias(self.proj_up)
        xm = linear_in_dtype(self.norm(xs), self.proj_up.weight[:inner],
                             None if self.proj_up.bias is None else bu[:inner])
        conv_act = F.silu(self.conv(xm, seqlens))
        out = self._function(vil_layer_fwd, vil_layer_ref, x)(
            xs, conv_act, self.norm.scale, self.proj_up.weight.t(), bu,
            *self.mlstm_cell.cell_args(self.q_proj, self.k_proj, self.v_proj, self.zeros),
            *self._tail_args(), self.num_heads, **self._fn_kw())
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
        out = self._function(vil_layer_conv_fwd, vil_layer_conv_plain, x)(
            xs, self.norm.scale, self.proj_up.weight.t(), self._bias(self.proj_up),
            self.conv.conv.weight, self.conv.conv.bias,
            *self.mlstm_cell.cell_args(self.q_proj, self.k_proj, self.v_proj, self.zeros),
            *self._tail_args(), self.num_heads, tuple(seqlens), **self._fn_kw())
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
        cell_fn = self._function(vil_cell_fwd, vil_cell_plain, x)
        h = self.mlstm_cell.forward_cell(conv_act, x_mlstm, self.q_proj, self.k_proj,
                                         self.v_proj, cell_fn, self.zeros)
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
    runs only the forward direction, which is the default. ``proj_bias``
    goes to the layers as well (the JAX pair has no such key: its layers
    keep their biases)."""

    def __init__(self, dim: int, qkv_block_size: int = 16, seqlens=None, chunk_size: int = 64,
                 conv_kernel_size: int = 3, igate_act: str = "exp", bidirectional: bool = False,
                 drop_path: float = 0.0, mlstm_backend: str = "auto", use_outnorm: bool = True,
                 proj_bias: bool = True):
        super().__init__()
        kw = dict(qkv_block_size=qkv_block_size, seqlens=seqlens, chunk_size=chunk_size,
                  conv_kernel_size=conv_kernel_size, igate_act=igate_act, drop_path=drop_path,
                  mlstm_backend=mlstm_backend, use_outnorm=use_outnorm, proj_bias=proj_bias)
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
    """Strided-conv patch embedding of a channels-last input of ``ndim``
    spatial axes: (B, L, C) -> (B, L/P, dim), an NHWC image (B, H, W, C) ->
    (B, H/P, W/P, dim), a video (B, T, H, W, C) -> (B, T/P, H/P, W/P, dim).
    The JAX module reads the rank from its input; a torch conv is built for
    one, so the rank is given here. ``patch_size``: an int, or one per
    axis."""

    def __init__(self, dim: int, patch_size=16, in_channels: int = 3, ndim: int = 2):
        super().__init__()
        conv = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}.get(ndim)
        if conv is None:
            raise ValueError(f"VitPatchEmbed: {ndim} spatial axes (1, 2 or 3)")
        self.ndim = ndim
        self.proj = conv(in_channels, dim, patch_size, stride=patch_size)

    def init_params(self, g: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.proj.weight, generator=g)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x):
        if x.dim() != self.ndim + 2:
            raise ValueError(f"VitPatchEmbed: a rank-{x.dim()} input to a {self.ndim}-D embed")
        return self.proj(x.movedim(-1, 1)).movedim(1, -1)


class _VitPosEmbed(nn.Module):
    """Learnable position embedding ``embed`` (1, *seqlens, dim), added to a
    (B, *grid, dim) input. For another grid the embedding is resized as the
    JAX modules resize it (``jax.image.resize`` with ``method``,
    antialiased when shrinking; ``ops.letterbox.resize``: one interpolation
    matrix per axis)."""

    method = "linear"

    def __init__(self, dim: int, seqlens: tuple):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(1, *seqlens, dim))

    def init_params(self, g: torch.Generator) -> None:
        nn.init.trunc_normal_(self.embed, 0.0, 0.02, -0.04, 0.04, generator=g)

    def forward(self, x):
        pe = self.embed
        if x.shape[1:-1] != pe.shape[1:-1]:
            pe = resize(pe.float(), (1, *x.shape[1:-1], pe.shape[-1]), self.method)
        return x + pe.to(x.dtype)


class VitPosEmbed1d(_VitPosEmbed):
    """1-D position embedding (1, L, dim) on (B, L, dim), resized linearly."""

    def __init__(self, dim: int, seqlens: tuple = (196,)):
        super().__init__(dim, seqlens)


class VitPosEmbed2d(_VitPosEmbed):
    """2-D position embedding (1, h, w, dim) on a (B, h, w, dim) grid,
    resized bicubically (Keys a = -0.5)."""

    method = "cubic"

    def __init__(self, dim: int, seqlens: tuple = (14, 14)):
        super().__init__(dim, seqlens)


class VitPosEmbed3d(_VitPosEmbed):
    """3-D (video) position embedding (1, t, h, w, dim) on (B, t, h, w,
    dim), resized trilinearly."""

    def __init__(self, dim: int, seqlens: tuple = (8, 14, 14)):
        super().__init__(dim, seqlens)


class VisionLSTMBackbone(nn.Module):
    """ViL backbone emitting multi-scale partials: patch embed -> position
    embed -> ``depth`` ViLBlockPairs, collecting the normed sequence at
    ``output_indices`` as (B, h, w, dim) maps, the final one appended last.
    ``VisionLSTMBackbone(192, device="cuda")``: the model on ``device`` in
    eval mode, weights drawn from ``seed`` with the JAX package's init
    scheme; ``device=None`` leaves it uninitialized where it was built, for
    a model that holds it (the graph block ``VisionLSTM``) to initialize and
    place. ``forward`` takes NHWC images at ``resolution``."""

    def __init__(self, dim: int, depth: int = 12, patch_size: int = 16,
                 resolution: tuple = (224, 224), output_indices: tuple = (),
                 qkv_block_size: int = 16, chunk_size: int = 64, igate_act: str = "exp",
                 bidirectional: bool = False, mlstm_backend: str = "auto",
                 in_channels: int = 3, device: str | torch.device | None = "cuda",
                 seed: int = 0):
        super().__init__()
        self.depth, self.output_indices = depth, tuple(output_indices)
        seqlens = (resolution[0] // patch_size, resolution[1] // patch_size)
        self.patch_embed = VitPatchEmbed(dim, patch_size, in_channels)
        self.pos_embed = VitPosEmbed2d(dim, seqlens)
        for i in range(depth):
            self.add_module(f"block{i}", ViLBlockPair(
                dim, qkv_block_size=qkv_block_size, seqlens=seqlens, chunk_size=chunk_size,
                igate_act=igate_act, bidirectional=bidirectional, mlstm_backend=mlstm_backend))
        self.norm = AffineLayerNorm(dim)
        if device is not None:
            dev = resolve_device(device)
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
