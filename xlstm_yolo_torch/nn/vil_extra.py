"""The extended ViL model family in torch.

Port of ``xlstm_yolo_tpu/nn/vil_extra.py``:

* ``ViLLayerLarge`` and ``mLSTMVisionBlock``, the xLSTM-7B-structured vision
  layer and its pre-norm block: a full 3x3 conv, SiLU, q and k at half the
  width, v and the output gate from the raw input, soft-capped gates, the
  chunkwise mLSTM from a carried (C, n, m) state, a per-head norm whose
  weight is stored directly, a SwiGLU FFN. There is no TPU kernel on this
  path (the JAX layer calls the native chunkwise form on every backend): it
  is plain torch on every device, the mLSTM a Python loop over chunks
  (``kernels.mlstm_native.mlstm_chunkwise``);
* the nine fusion MLPs of ``MLP_REGISTRY`` and ``FusionViLLayer``, a
  ViLBlockPair (the layer kernel on the card) followed by RMSNorm, one of
  those MLPs and the skip; ``crossattn`` and ``film`` read a second stream
  ``ctx``;
* ``HierarchicalVisionLSTM``: patch and position embeds, per stage
  ``depth`` ViLBlockPairs, a 2 x 2 token merge, Dense and LayerNorm between
  stages; it returns the per-stage maps;
* ``VisionLSTM2``: patch embed, position embed, ``depth`` ViLBlockPairs with
  a stochastic-depth schedule, a final LayerNorm, one of three poolings and,
  as a classifier, a linear head;
* ``VisionTransformer``, the ViT baseline kept for ViL-against-ViT
  comparisons (plain torch; attention through
  ``F.scaled_dot_product_attention``).

Submodule names follow the JAX tree, flax's automatic ones too (``Dense_0``,
``Conv_0``, ``LayerNorm_0`` inside the MLPs; ``query``, ``key``, ``value``,
``out`` inside the ViT's attention), so ``utils.jax_weights.
load_jax_variables`` fills every module. flax's ``nn.gelu`` is the tanh
approximation and its ``nn.LayerNorm`` has eps 1e-6 (``AffineLayerNorm``).
Images are NHWC, as at the JAX boundary; sequences (B, S, D) in row-major
(H, W) order.

``qkv_block_size`` is the head dim of the ViL layers (``num_heads = 2 * dim
// qkv_block_size``), as in the JAX classes: VisionLSTM2 defaults to 4 (96
heads at dim 192), the fusion and hierarchical models to 16. On the CPU any
head dim runs; on the GPU the ViL kernels take head dims 4, 8, 16, 32 and
64 (another raises there).

The JAX package has no trainer for these models: a train step is the model
in train mode (with a generator where stochastic depth draws), a loss,
``backward()`` and ``utils.train_utils.StepUpdate``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.mlstm_native import mlstm_chunkwise, soft_cap
from ..utils import resolve_device
from .modules import conv_in_dtype, init_tree, lecun_normal_, linear_in_dtype
from .vil import (AffineLayerNorm, MultiHeadLayerNorm, RMSNorm, SequenceConv2d, ViLBlockPair,
                  VitPatchEmbed, VitPosEmbed2d)


def _gelu(x):  # flax's nn.gelu: the tanh approximation
    return F.gelu(x, approximate="tanh")


def _dense(x, lin: nn.Linear):
    """flax's ``nn.Dense(dtype=x.dtype)``."""
    return linear_in_dtype(x, lin.weight, lin.bias)


def _init_flax(g: torch.Generator, *layers) -> None:
    """flax's default Dense / Conv init: lecun-normal kernel, zero bias."""
    for m in layers:
        lecun_normal_(m.weight, g)
        if m.bias is not None:
            nn.init.zeros_(m.bias)


def _place(model: nn.Module, device, seed: int) -> nn.Module:
    """Initialize ``model`` from ``seed`` with the JAX scheme, in eval mode
    on ``device``."""
    dev = resolve_device(device)
    init_tree(model, seed)
    return model.eval().to(dev)


class ViLLayerLarge(nn.Module):
    """xLSTM-7B-style vision mixing layer on (B, S, D): a full 3x3 conv of
    x on the token grid (``seqlens``, a square grid when None), SiLU, q and k
    (width ``D * qk_dim_factor``) from it; v and the output gate from x; the
    i and f gate preacts from x, soft-capped at ``gate_soft_cap``; the
    chunkwise mLSTM over chunks of ``min(chunk_size, S)`` (S must be a
    multiple, as the JAX layer asserts: a ValueError here; nothing is
    padded) from ``initial_state`` = (C (B, NH, DQK, DV), n (B, NH, DQK), m
    (B, NH)) or zeros; a per-head norm (weight stored directly, eps 1e-6);
    ``sigmoid(o) * h``; ``out_proj``. ``return_last_state``: also the state
    after the last token. ``seqlens`` given to ``forward`` overrides the
    grid. Plain torch on every device (no kernel: the JAX layer runs the
    native form on every backend too)."""

    def __init__(self, dim: int, num_heads: int = 4, qk_dim_factor: float = 0.5,
                 v_dim_factor: float = 1.0, gate_soft_cap: float = 15.0, chunk_size: int = 64,
                 use_bias: bool = False, seqlens: tuple | None = None):
        super().__init__()
        qk_dim, v_dim = int(dim * qk_dim_factor), int(dim * v_dim_factor)
        self.num_heads, self.v_dim = num_heads, v_dim
        self.gate_soft_cap, self.chunk_size, self.seqlens = gate_soft_cap, chunk_size, seqlens
        self.conv = SequenceConv2d(dim, 3, out_channels=v_dim, groups=1)
        self.q = nn.Linear(v_dim, qk_dim, bias=use_bias)
        self.k = nn.Linear(v_dim, qk_dim, bias=use_bias)
        self.v = nn.Linear(dim, v_dim, bias=use_bias)
        self.ogate_preact = nn.Linear(dim, v_dim, bias=use_bias)
        self.igate_preact = nn.Linear(dim, num_heads)
        self.fgate_preact = nn.Linear(dim, num_heads)
        self.multihead_norm = MultiHeadLayerNorm(num_heads, v_dim, eps=1e-6, with_bias=use_bias,
                                                 residual=False)
        self.out_proj = nn.Linear(v_dim, dim, bias=use_bias)

    def init_params(self, g: torch.Generator) -> None:
        _init_flax(g, self.q, self.k, self.v, self.ogate_preact, self.igate_preact,
                   self.fgate_preact, self.out_proj)

    def forward(self, x, initial_state=None, return_last_state: bool = False, seqlens=None):
        B, S, D = x.shape
        NH = self.num_heads
        conv_act = F.silu(self.conv(x, self.seqlens if seqlens is None else seqlens))
        heads = lambda t: t.reshape(B, S, NH, -1).transpose(1, 2)
        q, k = _dense(conv_act, self.q), _dense(conv_act, self.k)
        v, o_pre = _dense(x, self.v), _dense(x, self.ogate_preact)
        # flax's Dense without a dtype computes in the promoted one: fp32 gates
        i_pre = soft_cap(F.linear(x.float(), self.igate_preact.weight, self.igate_preact.bias),
                         self.gate_soft_cap)
        f_pre = soft_cap(F.linear(x.float(), self.fgate_preact.weight, self.fgate_preact.bias),
                         self.gate_soft_cap)
        h, last = mlstm_chunkwise(heads(q), heads(k), heads(v), i_pre.transpose(1, 2),
                                  f_pre.transpose(1, 2), chunk_size=min(self.chunk_size, S),
                                  initial_state=initial_state, return_last_state=True)
        h = self.multihead_norm(h.to(x.dtype)).transpose(1, 2).reshape(B, S, self.v_dim)
        y = _dense(torch.sigmoid(o_pre) * h, self.out_proj)
        return (y, last) if return_last_state else y


class mLSTMVisionBlock(nn.Module):
    """Pre-norm block: RMSNorm, ``ViLLayerLarge``, residual; RMSNorm, a
    SwiGLU FFN of width ``int(ffn_proj_factor * dim // 64 * 64) or dim`` (the
    JAX expression: the float floor division first), residual."""

    def __init__(self, dim: int, num_heads: int = 4, ffn_proj_factor: float = 2.6667,
                 chunk_size: int = 64, seqlens: tuple | None = None):
        super().__init__()
        self.up = int(ffn_proj_factor * dim // 64 * 64) or dim
        self.norm_mlstm = RMSNorm(dim)
        self.mlstm_layer = ViLLayerLarge(dim, num_heads, chunk_size=chunk_size, seqlens=seqlens)
        self.norm_ffn = RMSNorm(dim)
        self.ffn_up = nn.Linear(dim, 2 * self.up, bias=False)
        self.ffn_down = nn.Linear(self.up, dim, bias=False)

    def init_params(self, g: torch.Generator) -> None:
        _init_flax(g, self.ffn_up, self.ffn_down)

    def forward(self, x, seqlens=None):
        x = x + self.mlstm_layer(self.norm_mlstm(x), seqlens=seqlens)
        a, b = _dense(self.norm_ffn(x), self.ffn_up).split(self.up, dim=-1)
        return x + _dense(F.silu(a) * b, self.ffn_down)


# ---------------------------------------------------------------------------
# the fusion MLPs: (x, ctx=None) -> x's shape; a hidden width of 4 * dim
# unless given
# ---------------------------------------------------------------------------

class _MLP(nn.Module):
    """Dense layers ``Dense_{i}`` with the widths ``dims`` (in, out) pairs,
    initialized as flax initializes them. flax numbers its automatic names
    in the order the modules are constructed, and in ``Dense(a)(f(Dense(b)
    (x)))`` the outer one is constructed first: it is the lower number."""

    def __init__(self, *dims):
        super().__init__()
        for i, (a, b) in enumerate(dims):
            self.add_module(f"Dense_{i}", nn.Linear(a, b))

    def init_params(self, g: torch.Generator) -> None:
        _init_flax(g, *(m for m in self.children() if isinstance(m, nn.Linear)))

    def dense(self, i: int, x):
        return _dense(x, getattr(self, f"Dense_{i}"))


class MLPBaseline(_MLP):
    def __init__(self, dim: int, hidden: int | None = None):
        h = hidden or 4 * dim
        super().__init__((dim, h), (h, dim))

    def forward(self, x, ctx=None):
        return self.dense(1, _gelu(self.dense(0, x)))


class GEGLU(_MLP):
    def __init__(self, dim: int, hidden: int | None = None):
        h = hidden or 4 * dim
        super().__init__((dim, 2 * h), (h, dim))

    def forward(self, x, ctx=None):
        a, b = self.dense(0, x).chunk(2, dim=-1)
        return self.dense(1, _gelu(a) * b)


class SwiGLUMLP(_MLP):
    def __init__(self, dim: int, hidden: int | None = None):
        h = hidden or 4 * dim
        super().__init__((dim, 2 * h), (h, dim))

    def forward(self, x, ctx=None):
        a, b = self.dense(0, x).chunk(2, dim=-1)
        return self.dense(1, F.silu(a) * b)


class _ConvMLP(nn.Module):
    """Three convs ``Conv_0`` (1 x 1, dim -> c0), ``Conv_1`` (3 x 3
    depthwise over ``hid``), ``Conv_2`` (1 x 1, hid -> dim) on the square
    token grid (``isqrt(S)``; S must be a square)."""

    def __init__(self, dim: int, c0: int, hid: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(dim, c0, 1)
        self.Conv_1 = nn.Conv2d(hid, hid, 3, padding=1, groups=hid)
        self.Conv_2 = nn.Conv2d(hid, dim, 1)

    def init_params(self, g: torch.Generator) -> None:
        _init_flax(g, self.Conv_0, self.Conv_1, self.Conv_2)

    def grid(self, x):
        b, s, d = x.shape
        hw = math.isqrt(s)
        return x.reshape(b, hw, hw, d).permute(0, 3, 1, 2)

    @staticmethod
    def tokens(y):
        return y.flatten(2).transpose(1, 2)


class RGBlockMLP(_ConvMLP):
    """Token-grid gated conv MLP: ``Conv_0`` to (a, v), gelu(dwconv(a) + a)
    * v, ``Conv_2``; hidden ``(hidden or 4 dim) * 2 // 3``."""

    def __init__(self, dim: int, hidden: int | None = None):
        h = (hidden or 4 * dim) * 2 // 3
        super().__init__(dim, 2 * h, h)

    def forward(self, x, ctx=None):
        a, v = conv_in_dtype(self.Conv_0, self.grid(x)).chunk(2, dim=1)
        y = _gelu(conv_in_dtype(self.Conv_1, a) + a) * v
        return self.tokens(conv_in_dtype(self.Conv_2, y))


class ConvMLP(_ConvMLP):
    """1 x 1 conv, gelu, 3 x 3 depthwise conv, gelu, 1 x 1 conv on the
    token grid."""

    def __init__(self, dim: int, hidden: int | None = None):
        h = hidden or 4 * dim
        super().__init__(dim, h, h)

    def forward(self, x, ctx=None):
        y = _gelu(conv_in_dtype(self.Conv_0, self.grid(x)))
        y = _gelu(conv_in_dtype(self.Conv_1, y))
        return self.tokens(conv_in_dtype(self.Conv_2, y))


class LoRAMLP(_MLP):
    """A rank-``min(rank, hidden)`` bottleneck (``Dense_1``) with a ReLU,
    then ``Dense_0`` back to dim."""

    def __init__(self, dim: int, hidden: int | None = None, rank: int = 16):
        r = min(rank, hidden or 4 * dim)
        super().__init__((r, dim), (dim, r))

    def forward(self, x, ctx=None):
        return self.dense(0, F.relu(self.dense(1, x)))


class MLPMixer(_MLP):
    """Token mixing (``LayerNorm_0``, ``Dense_0`` across the ``seq_len``
    tokens), then a channel MLP (``LayerNorm_1``, ``Dense_2``, gelu,
    ``Dense_1``). The JAX ``Dense_0`` takes its input width from the
    sequence at init; here the sequence must be ``seq_len`` long, as the
    fusion layer's skip needs it."""

    def __init__(self, dim: int, seq_len: int = 64, hidden: int | None = None):
        h = hidden or 4 * dim
        super().__init__((seq_len, seq_len), (h, dim), (dim, h))
        self.LayerNorm_0 = AffineLayerNorm(dim)
        self.LayerNorm_1 = AffineLayerNorm(dim)

    def forward(self, x, ctx=None):
        y = self.dense(0, self.LayerNorm_0(x).transpose(1, 2)).transpose(1, 2)
        return self.dense(1, _gelu(self.dense(2, self.LayerNorm_1(y))))


class CrossAttentionMLP(_MLP):
    """Single-head attention from x onto ``ctx`` (x itself without one):
    ``Dense_0`` q, ``Dense_1`` k, ``Dense_2`` v (hidden wide), the softmax of
    q k^T / sqrt(dim) in fp32, ``Dense_3`` out."""

    def __init__(self, dim: int, hidden: int | None = None):
        h = hidden or 4 * dim
        super().__init__((dim, dim), (dim, dim), (dim, h), (h, dim))
        self.dim = dim

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        q, k, v = self.dense(0, x), self.dense(1, ctx), self.dense(2, ctx)
        attn = torch.softmax((q @ k.transpose(-2, -1) / self.dim ** 0.5).float(), dim=-1)
        return self.dense(3, attn.to(x.dtype) @ v)


class FiLMMLP(_MLP):
    """An MLP of x (``Dense_3``, gelu, ``Dense_2``) scaled by ``Dense_0``
    (ctx) and shifted by ``Dense_1`` (ctx); ctx is x without one."""

    def __init__(self, dim: int, hidden: int | None = None):
        h = hidden or 4 * dim
        super().__init__((dim, dim), (dim, dim), (h, dim), (dim, h))

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        y = self.dense(2, _gelu(self.dense(3, x)))
        return y * self.dense(0, ctx) + self.dense(1, ctx)


MLP_REGISTRY = {
    "baseline": MLPBaseline,
    "geglu": GEGLU,
    "swiglu": SwiGLUMLP,
    "rgblock": RGBlockMLP,
    "convmlp": ConvMLP,
    "lora": LoRAMLP,
    "mixer": MLPMixer,
    "crossattn": CrossAttentionMLP,
    "film": FiLMMLP,
}


class FusionViLLayer(nn.Module):
    """ViL mixing plus a pluggable MLP: ``vil`` (a ViLBlockPair: the layer
    kernel on the card), then, with ``use_mlp``, RMSNorm ``mlp_norm``, the
    MLP ``mlp_{mlp_type}`` of ``MLP_REGISTRY`` and the skip (without
    ``use_skip`` the MLP's output alone). ``forward(x, ctx=None, seqlens=
    None)``: ``crossattn`` and ``film`` read the second stream ``ctx``;
    ``mixer`` mixes ``seq_len`` tokens."""

    def __init__(self, dim: int, mlp_type: str = "baseline", use_mlp: bool = True,
                 use_skip: bool = True, qkv_block_size: int = 16, chunk_size: int = 64,
                 seqlens: tuple | None = None, seq_len: int = 64):
        super().__init__()
        if mlp_type not in MLP_REGISTRY:
            raise ValueError(f"unknown mlp_type {mlp_type!r} (one of {tuple(MLP_REGISTRY)})")
        self.mlp_type, self.use_mlp, self.use_skip = mlp_type, use_mlp, use_skip
        self.vil = ViLBlockPair(dim, qkv_block_size=qkv_block_size, seqlens=seqlens,
                                chunk_size=chunk_size)
        if use_mlp:
            self.mlp_norm = RMSNorm(dim)
            kw = {"seq_len": seq_len} if mlp_type == "mixer" else {}
            self.add_module(f"mlp_{mlp_type}", MLP_REGISTRY[mlp_type](dim, **kw))

    def forward(self, x, ctx=None, seqlens=None):
        y = self.vil(x, seqlens)
        if not self.use_mlp:
            return y
        m = getattr(self, f"mlp_{self.mlp_type}")(self.mlp_norm(y), ctx)
        return y + m if self.use_skip else m


class HierarchicalVisionLSTM(nn.Module):
    """Swin-style hierarchical ViL on NHWC images at ``resolution``: patch
    embed, position embed, then per stage ``depths[i]`` ViLBlockPairs
    (``s{i}b{j}``) at width ``dims[i]`` and, between stages, a 2 x 2 token
    merge (the window flattened as (row, column, channel)), ``merge{i}`` to
    the next width and LayerNorm ``merge_norm{i}``. Returns the per-stage
    maps (B, h_i, w_i, dims[i]). ``HierarchicalVisionLSTM(device="cuda")``:
    the model on ``device`` in eval mode, weights drawn from ``seed`` with
    the JAX package's init scheme."""

    def __init__(self, dims: tuple = (96, 192, 384), depths: tuple = (2, 2, 4),
                 patch_size: int = 4, qkv_block_size: int = 16, chunk_size: int = 64,
                 resolution: tuple = (224, 224), device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        self.dims, self.depths = tuple(dims), tuple(depths)
        h, w = resolution[0] // patch_size, resolution[1] // patch_size
        self.grids = []
        self.patch_embed = VitPatchEmbed(dims[0], patch_size)
        self.pos_embed = VitPosEmbed2d(dims[0], (h, w))
        for si, (dim, depth) in enumerate(zip(dims, depths)):
            self.grids.append((h, w))
            for bi in range(depth):
                self.add_module(f"s{si}b{bi}", ViLBlockPair(
                    dim, qkv_block_size=qkv_block_size, seqlens=(h, w), chunk_size=chunk_size))
            if si < len(dims) - 1:
                self.add_module(f"merge{si}", nn.Linear(4 * dim, dims[si + 1]))
                self.add_module(f"merge_norm{si}", AffineLayerNorm(dims[si + 1]))
                h, w = h // 2, w // 2
        _place(self, device, seed)

    def init_params(self, g: torch.Generator) -> None:
        _init_flax(g, *(getattr(self, f"merge{i}") for i in range(len(self.dims) - 1)))

    def forward(self, x):
        x = self.patch_embed(x)
        if tuple(x.shape[1:3]) != self.grids[0]:
            raise ValueError(f"HierarchicalVisionLSTM: a {tuple(x.shape[1:3])} token grid on a "
                             f"model built for {self.grids[0]}")
        x = self.pos_embed(x)
        b = x.shape[0]
        seq = x.reshape(b, -1, x.shape[-1])
        outs = []
        for si, ((h, w), dim, depth) in enumerate(zip(self.grids, self.dims, self.depths)):
            for bi in range(depth):
                seq = getattr(self, f"s{si}b{bi}")(seq, (h, w))
            outs.append(seq.reshape(b, h, w, dim))
            if si < len(self.dims) - 1:
                m = seq.reshape(b, h // 2, 2, w // 2, 2, dim).permute(0, 1, 3, 2, 4, 5)
                m = m.reshape(b, (h // 2) * (w // 2), 4 * dim)
                seq = getattr(self, f"merge_norm{si}")(_dense(m, getattr(self, f"merge{si}")))
        return outs

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


POOLINGS = ("to_image", "bilateral_avg", "bilateral_flatten")


def drop_path_rates(rate: float, depth: int, decay: bool) -> list[float]:
    """Per-block stochastic-depth rates: a linear ramp from 0 to ``rate``
    over the depth with ``decay`` (and more than one block), else ``rate``
    everywhere."""
    if decay and depth > 1:
        return [rate * i / (depth - 1) for i in range(depth)]
    return [rate] * depth


class VisionLSTM2(nn.Module):
    """ViL classifier or feature extractor on NHWC images at ``resolution``.
    ``VisionLSTM2(device="cuda")``: the model on
    ``device`` in eval mode, weights drawn from ``seed`` with the JAX
    package's init scheme.

    ``forward(x)`` in eval mode is deterministic. In train mode with
    ``drop_path_rate`` > 0 it needs ``generator``: every block whose rate is
    positive draws one per-sample keep mask from it, in block order (and
    forward before backward direction in a bidirectional pair)."""

    def __init__(self, dim: int = 192, depth: int = 12, patch_size: int = 16,
                 output_shape: tuple = (1000,), mode: str = "classifier",
                 pooling: str = "bilateral_flatten", qkv_block_size: int = 4,
                 chunk_size: int = 64, bidirectional: bool = False,
                 drop_path_rate: float = 0.0, drop_path_decay: bool = True,
                 resolution: tuple = (224, 224), device: str | torch.device = "cuda",
                 seed: int = 0):
        super().__init__()
        if mode not in ("classifier", "features"):
            raise ValueError(f"unknown mode {mode!r}")
        if pooling not in POOLINGS:
            raise ValueError(f"unknown pooling {pooling!r}")
        dev = resolve_device(device)
        self.depth, self.mode, self.pooling = depth, mode, pooling
        seqlens = (resolution[0] // patch_size, resolution[1] // patch_size)
        self.patch_embed = VitPatchEmbed(dim, patch_size)
        self.pos_embed = VitPosEmbed2d(dim, seqlens)
        for i, rate in enumerate(drop_path_rates(drop_path_rate, depth, drop_path_decay)):
            self.add_module(f"block{i}", ViLBlockPair(
                dim, qkv_block_size=qkv_block_size, seqlens=seqlens, chunk_size=chunk_size,
                bidirectional=bidirectional, drop_path=rate))
        self.norm = AffineLayerNorm(dim)
        self.head = None
        if mode == "classifier":
            pooled = 2 * dim if pooling == "bilateral_flatten" else dim
            self.head = nn.Linear(pooled, output_shape[0])
        g = init_tree(self, seed)
        if self.head is not None:
            lecun_normal_(self.head.weight, g)
            nn.init.zeros_(self.head.bias)
        self.eval()
        self.to(dev)

    def forward(self, x, generator: torch.Generator | None = None):
        x = self.patch_embed(x)
        grid = tuple(self.pos_embed.embed.shape[1:3])
        if tuple(x.shape[1:3]) != grid:  # the JAX model shapes its embedding by its input
            raise ValueError(f"VisionLSTM2: a {tuple(x.shape[1:3])} token grid on a model "
                             f"built for {grid} (its position embedding's shape)")
        x = self.pos_embed(x)
        b, h, w, d = x.shape
        seq = x.reshape(b, h * w, d)
        for i in range(self.depth):
            seq = getattr(self, f"block{i}")(seq, (h, w), generator)
        seq = self.norm(seq)
        if self.pooling == "to_image":
            out = seq.reshape(b, h, w, d)
        elif self.pooling == "bilateral_avg":
            out = (seq[:, 0] + seq[:, -1]) / 2
        else:
            out = torch.cat([seq[:, 0], seq[:, -1]], dim=-1)
        return out if self.head is None else self.head(out)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


class _Attention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (self-attention, qkv and out
    features = dim, with biases): ``query``, ``key``, ``value`` (dim ->
    NH*hd) and ``out`` (NH*hd -> dim) as ``nn.Linear`` layers (the loader
    reshapes the ``DenseGeneral`` kernels), softmax(q k^T / sqrt(hd)) v per
    head."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key, self.value = (nn.Linear(dim, dim) for _ in range(3))
        self.out = nn.Linear(dim, dim)

    def init_params(self, g: torch.Generator) -> None:
        _init_flax(g, self.query, self.key, self.value, self.out)

    def forward(self, x):
        b, s, d = x.shape
        heads = lambda lin: _dense(x, lin).reshape(b, s, self.num_heads, -1).transpose(1, 2)
        y = F.scaled_dot_product_attention(heads(self.query), heads(self.key), heads(self.value))
        return _dense(y.transpose(1, 2).reshape(b, s, d), self.out)


class VisionTransformer(nn.Module):
    """The plain ViT baseline on NHWC images at ``resolution``: patch embed,
    position embed, a class token, ``depth`` pre-norm blocks (``norm1_{i}``,
    ``attn_{i}``, residual; ``norm2_{i}``, ``mlp1_{i}``, gelu, ``mlp2_{i}``,
    residual), LayerNorm ``norm``; ``mode="classifier"``: ``head`` on the
    class token -> (B, num_classes); ``"features"``: the patch tokens as a
    (B, h, w, dim) map (no head). ``VisionTransformer(device="cuda")``: the
    model on ``device`` in eval mode, weights drawn from ``seed``."""

    def __init__(self, dim: int = 192, depth: int = 12, num_heads: int = 3,
                 patch_size: int = 16, num_classes: int = 1000, mlp_ratio: float = 4.0,
                 mode: str = "classifier", resolution: tuple = (224, 224),
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        if mode not in ("classifier", "features"):
            raise ValueError(f"unknown mode {mode!r}")
        self.depth, self.mode = depth, mode
        grid = (resolution[0] // patch_size, resolution[1] // patch_size)
        self.patch_embed = VitPatchEmbed(dim, patch_size)
        self.pos_embed = VitPosEmbed2d(dim, grid)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        hidden = int(dim * mlp_ratio)
        for i in range(depth):
            self.add_module(f"norm1_{i}", AffineLayerNorm(dim))
            self.add_module(f"attn_{i}", _Attention(dim, num_heads))
            self.add_module(f"norm2_{i}", AffineLayerNorm(dim))
            self.add_module(f"mlp1_{i}", nn.Linear(dim, hidden))
            self.add_module(f"mlp2_{i}", nn.Linear(hidden, dim))
        self.norm = AffineLayerNorm(dim)
        self.head = nn.Linear(dim, num_classes) if mode == "classifier" else None
        _place(self, device, seed)

    def init_params(self, g: torch.Generator) -> None:
        nn.init.trunc_normal_(self.cls_token, 0.0, 0.02, -0.04, 0.04, generator=g)
        _init_flax(g, *(getattr(self, f"mlp{j}_{i}") for i in range(self.depth) for j in (1, 2)))
        if self.head is not None:
            _init_flax(g, self.head)

    def forward(self, x):
        x = self.pos_embed(self.patch_embed(x))
        b, h, w, d = x.shape
        seq = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, d), x.reshape(b, h * w, d)], 1)
        for i in range(self.depth):
            seq = seq + getattr(self, f"attn_{i}")(getattr(self, f"norm1_{i}")(seq))
            y = _dense(getattr(self, f"norm2_{i}")(seq), getattr(self, f"mlp1_{i}"))
            seq = seq + _dense(_gelu(y), getattr(self, f"mlp2_{i}"))
        seq = self.norm(seq)
        if self.head is None:
            return seq[:, 1:].reshape(b, h, w, d)
        return _dense(seq[:, 0], self.head)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
