"""Conv blocks of the detection graphs, NCHW.

Port of the blocks of ``xlstm_yolo_tpu/nn/modules.py`` that the ViL-YOLO,
YOLOv8 and YOLO11 graphs use: ConvBN, Bottleneck, C2f, C3k, C3k2, SPPF,
Concat, Upsample, and YOLO11's spatial attention (Attention, PSABlock,
C2PSA).
Submodule names follow the JAX parameter tree (``conv``/``bn``, ``cv1``,
``m0``...), so ``utils.jax_weights`` maps one onto the other by path.
Unlike flax, a torch module is built knowing its input channels ``c1``.

Every block computes in its input's dtype, as the JAX blocks do (flax's
``dtype=x.dtype``): fp32 parameters are cast at use (``conv_in_dtype``,
``linear_in_dtype``), so under bf16 AMP the gradients reach them in fp32
through the cast. BatchNorm computes in fp32 and returns the input dtype;
its running statistics stay fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3  # the JAX ConvBN's BatchNorm epsilon
BN_MOMENTUM = 0.03  # torch convention: flax's momentum 0.97 keeps 0.97 of the old value


def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    """Same-padding for odd kernels."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


def lecun_normal_(w: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """flax's default conv/dense kernel init: truncated normal (±2σ) with
    variance 1/fan_in; ``w`` is OIHW or (out, in)."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation correction
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


def small_init_(w: torch.Tensor, dim: int, g: torch.Generator) -> None:
    """The NX-AI small init: normal with std sqrt(2 / (5 dim))."""
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / (5.0 * dim)), generator=g)


def wang_init_(w: torch.Tensor, dim: int, num_blocks: int, g: torch.Generator) -> None:
    """Normal init for residual-out projections, std 2 / num_blocks / sqrt(dim)."""
    with torch.no_grad():
        w.normal_(0.0, 2.0 / max(num_blocks, 1) / math.sqrt(dim), generator=g)


def init_tree(model: nn.Module, seed: int) -> torch.Generator:
    """Initialize every submodule that has ``init_params`` from a generator
    seeded with ``seed``; returns the generator, for what the model itself
    still draws."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "init_params"):
            m.init_params(g)
    return g


def conv_in_dtype(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` applied in x's dtype, as flax's ``nn.Conv(dtype=x.dtype)``:
    the weight cast to it, the bias (where there is one) added after the
    convolution, in that dtype."""
    y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding, conv.dilation,
                 conv.groups)
    return y if conv.bias is None else y + conv.bias.to(x.dtype).reshape(1, -1, 1, 1)


def linear_in_dtype(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """``F.linear`` in x's dtype, as flax's ``nn.Dense(dtype=x.dtype)``: the
    weight (out, in) cast to it, the bias added after the product."""
    y = F.linear(x, weight.to(x.dtype))
    return y if bias is None else y + bias.to(x.dtype)


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval-mode BatchNorm in fp32 on the running statistics, returned in
    x's dtype (the JAX ``ConvBN``'s ``dtype=float32`` BatchNorm)."""
    y = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight.float(),
                     bn.bias.float(), False, 0.0, bn.eps)
    return y.to(x.dtype)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode BatchNorm with flax semantics: normalize with the batch's
    biased variance, and update the running statistics with that same
    biased variance (torch's own update uses the unbiased one) at the
    module's momentum. ``num_batches_tracked`` is not used. Computed in fp32
    and returned in x's dtype; the statistics update in fp32."""
    dt, x = x.dtype, x.float()
    y = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps).to(dt)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
    return y


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm (eps 1e-3) + SiLU: the JAX ``ConvBN``.
    In train mode the BatchNorm follows ``batch_norm_train``."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    def init_params(self, g: torch.Generator) -> None:
        lecun_normal_(self.conv.weight, g)
        if isinstance(self.bn, nn.BatchNorm2d):  # scale 1, bias 0, running mean 0, var 1
            self.bn.reset_parameters()

    def forward(self, x):
        x = conv_in_dtype(self.conv, x)
        if isinstance(self.bn, nn.BatchNorm2d):  # an Identity after fuse_conv_bn
            x = batch_norm_train(x, self.bn) if self.training else batch_norm_eval(x, self.bn)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: tuple = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, k[0], 1)
        self.cv2 = ConvBN(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with 2 convs."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.n = n
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0))
        self.cv2 = ConvBN((2 + n) * self.c, c2, 1, 1)

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, dim=1))
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, dim=1))


class C3k(nn.Module):
    """C3 with a ``k`` x ``k`` kernel in both convs of its bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k: int = 3):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = ConvBN(c1, c_, 1, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(c_, c_, shortcut, g, k=(k, k), e=1.0))
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1, 1)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class C3k2(nn.Module):
    """YOLO11's C2f: its inner blocks are ``C3k(c, c, 2)`` (``c3k``) or a
    Bottleneck with e=0.5 (C2f's has 1.0)."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv1 = ConvBN(c1, 2 * c, 1, 1)
        for i in range(n):
            setattr(self, f"m{i}", C3k(c, c, 2, shortcut, g) if c3k
                    else Bottleneck(c, c, shortcut, g, k=(3, 3), e=0.5))
        self.cv2 = ConvBN((2 + n) * c, c2, 1, 1)

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, dim=1))
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained stride-1 max pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(4 * c_, c2, 1, 1)

    def forward(self, x):
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(outs, dim=1))


class Concat(nn.Module):
    """Concatenate a list of maps along ``dim`` (channels in NCHW)."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, xs):
        return torch.cat(list(xs), dim=self.dim)


class Upsample(nn.Module):
    def __init__(self, scale: int = 2, mode: str = "nearest"):
        super().__init__()
        self.scale = scale
        self.mode = mode

    def forward(self, x):
        if self.mode == "nearest":
            return F.interpolate(x, scale_factor=self.scale, mode="nearest")
        raise ValueError(f"Upsample mode {self.mode!r} is not ported")


class Attention(nn.Module):
    """Multi-head self-attention over the H x W grid plus a depthwise 3x3
    positional conv of v. The ``qkv`` channels are (head, [q key_dim, k
    key_dim, v head_dim]), the JAX package's NHWC reshape and the
    reference's NCHW view alike; y and the ``pe`` input take v's channels
    as head * head_dim + d. Scores and softmax in fp32, as the JAX block
    computes them (plain ops, no kernel)."""

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.qkv = ConvBN(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        kd = self.key_dim
        qkv = self.qkv(x).view(B, self.num_heads, 2 * kd + self.head_dim, H * W)
        q, k, v = qkv.split([kd, kd, self.head_dim], dim=2)
        attn = (q.float().transpose(-2, -1) @ k.float()) / math.sqrt(kd)  # (B, NH, N, N)
        attn = attn.softmax(dim=-1).to(v.dtype)
        y = (v @ attn.transpose(-2, -1)).reshape(B, C, H, W)
        return self.proj(y + self.pe(v.reshape(B, C, H, W)))


class PSABlock(nn.Module):
    """Attention, then a two-conv FFN, each with a residual (``shortcut``)."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4,
                 shortcut: bool = True):
        super().__init__()
        self.attn = Attention(c, num_heads, attn_ratio)
        self.ffn0 = ConvBN(c, 2 * c, 1)
        self.ffn1 = ConvBN(2 * c, c, 1, act=False)
        self.add = shortcut

    def forward(self, x):
        y = self.attn(x)
        x = x + y if self.add else y
        y = self.ffn1(self.ffn0(x))
        return x + y if self.add else y


class C2PSA(nn.Module):
    """YOLO11's CSP wrapper of ``n`` PSABlocks (``c2 * e`` channels, one
    head per 64 of them, at least one) on half of ``cv1``'s output."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv1 = ConvBN(c1, 2 * c, 1, 1)
        for i in range(n):
            setattr(self, f"m{i}", PSABlock(c, attn_ratio=0.5, num_heads=max(1, c // 64)))
        self.cv2 = ConvBN(2 * c, c2, 1)

    def forward(self, x):
        a, b = self.cv1(x).split(self.c, dim=1)
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
        return self.cv2(torch.cat([a, b], dim=1))
