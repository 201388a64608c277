"""Conv blocks of the detection and classification graphs, NCHW.

Port of the blocks of ``xlstm_yolo_tpu/nn/modules.py`` that the detection
graphs use: ConvBN, Bottleneck, C2f, C3k, C3k2, SPPF, Concat, Upsample and
YOLO11's spatial attention (Attention, PSABlock, C2PSA); then the rest of
the zoo: YOLOv3 / v5 / v6 / v8 variants (DWConv, C3, C2, MaxPool, Index,
GhostConv, GhostBottleneck, C3Ghost, ConvTransposeBN, SPP; the graph
builds torch's ``nn.ZeroPad2d`` and ``nn.Identity`` itself), YOLOv9 (ADown, AConv, RepConv, RepBottleneck,
RepCSP, RepNCSPELAN4, SPPELAN, ELAN1, CBLinear, CBFuse), YOLOv10 (SCDown,
RepVGGDW, CIB, C2fCIB, PSA), YOLO12 (AAttn, ABlock, A2C2f) and RT-DETR's
neck (LightConv, RepC3; its other blocks are in ``nn/rtdetr.py``); the
classify task's head (Classify) and backbones (ResNetBlock, ResNetLayer,
BasicResBlock, TorchVision).
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

from ..utils import at_least_fp32

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


def init_tree(model: nn.Module, seed: int, device: torch.device | None = None) -> torch.Generator:
    """Initialize every submodule that has ``init_params`` from a generator
    seeded with ``seed``, on ``device`` where the parameters were built
    there (the CPU's otherwise, and for the meta device, which draws
    nothing); returns the generator, for what the model itself still
    draws. A module that sets ``stacked_init`` initializes the modules
    below it itself (a stacked pair tree)."""
    on = device if device is not None and device.type != "meta" else "cpu"
    g = torch.Generator(on).manual_seed(seed)
    skip = ()
    for name, m in model.named_modules():
        if skip and name.startswith(skip):
            continue
        if hasattr(m, "init_params"):
            m.init_params(g)
        if getattr(m, "stacked_init", False):
            skip += (name + ".",)
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
    (fp64 for fp64 x) and returned in x's dtype; the statistics update in
    that dtype. Under a data-parallel group (``parallel.distributed.
    data_parallel``) the mean and the biased variance are those of the
    global batch, each rank's sums reduced over the group (count-weighted,
    differentiably), for the normalization and the running statistics
    alike, as the JAX step's BatchNorm over a dp-sharded batch computes
    them."""
    from ..parallel.distributed import dp_group, dp_sum

    dt, x = x.dtype, at_least_fp32(x)
    if dp_group() is not None:
        return batch_norm_global(x, bn.weight, bn.bias, bn.eps, bn.momentum, bn.running_mean,
                                 bn.running_var, dp_sum).to(dt)
    y = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps).to(dt)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
    return y


def batch_norm_global(x: torch.Tensor, weight, bias, eps: float, momentum: float,
                      running_mean, running_var, reduce) -> torch.Tensor:
    """Train-mode BatchNorm of NCHW ``x`` on statistics over the ranks that
    ``reduce`` sums across: the mean from the summed per-channel sums and
    counts, then the biased variance from the summed squared deviations; the
    running statistics move toward them at ``momentum``."""
    c = x.shape[1]
    count = torch.tensor([x.numel() / c], dtype=x.dtype, device=x.device)
    sums = reduce(torch.cat([x.sum((0, 2, 3)), count]))
    n = sums[c]
    mean = sums[:c] / n
    xc = x - mean[None, :, None, None]
    var = reduce((xc * xc).sum((0, 2, 3))) / n
    with torch.no_grad():
        running_mean.lerp_(mean.detach().to(running_mean.dtype), momentum)
        running_var.lerp_(var.detach().to(running_var.dtype), momentum)
    inv = torch.rsqrt(var + eps)
    return xc * (inv * weight)[None, :, None, None] + bias[None, :, None, None]


def activation(x: torch.Tensor, act) -> torch.Tensor:
    """The JAX ``_act``: True or "silu" SiLU; False, None or "identity" none;
    "relu", "sigmoid", "gelu" (flax's tanh approximation)."""
    if act is True or act == "silu":
        return F.silu(x)
    if act is False or act is None or act == "identity":
        return x
    if act == "relu":
        return F.relu(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown act {act!r}")


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm (eps 1e-3) + activation (``act``, as
    ``activation`` reads it; SiLU by default): the JAX ``ConvBN``. In train
    mode the BatchNorm follows ``batch_norm_train``."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act: bool | str = True):
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
        return activation(x, self.act)


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


class C3(nn.Module):
    """CSP bottleneck with 3 convs: ``cv1``, then n inner blocks, beside
    ``cv2``, both into ``cv3``. The blocks are Bottlenecks of a 1x1 then a
    3x3 conv, or what ``block(c_)`` builds (C3k, C3Ghost, RepCSP)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, block=None):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = ConvBN(c1, c_, 1, 1)
        block = block or (lambda c: Bottleneck(c, c, shortcut, g, k=(1, 3), e=1.0))
        for i in range(n):
            setattr(self, f"m{i}", block(c_))
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1, 1)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class C3k(C3):
    """C3 with a ``k`` x ``k`` kernel in both convs of its bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k: int = 3):
        super().__init__(c1, c2, n, e=e,
                         block=lambda c: Bottleneck(c, c, shortcut, g, k=(k, k), e=1.0))


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
        attn = (at_least_fp32(q).transpose(-2, -1) @ at_least_fp32(k)) / math.sqrt(kd)  # (B, NH, N, N)
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


# --- the rest of the detect zoo: YOLOv3, v5, v6, the v8 variants, v9, v10, YOLO12 ---


class DWConv(ConvBN):
    """A ConvBN grouped by gcd(c1, c2) (depthwise where c1 == c2); the
    positional arguments are the JAX ``DWConv``'s (c2, k, s, d, act, p)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1, act: bool = True,
                 p: int | None = None):
        super().__init__(c1, c2, k, s, p, g=math.gcd(c1, c2), d=d, act=act)


class C2(nn.Module):
    """CSP bottleneck with 2 convs: the bottlenecks run on one half of
    ``cv1``'s output, the other half passes."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv1 = ConvBN(c1, 2 * c, 1, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(c, c, shortcut, g, k=(3, 3), e=1.0))
        self.cv2 = ConvBN(2 * c, c2, 1)

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, dim=1)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv2(torch.cat([a, b], dim=1))


class MaxPool(nn.Module):
    """Max pool, padded by k // 2 where k is odd (explicit padding is a
    ``ZeroPad2d`` row)."""

    def __init__(self, k: int = 2, s: int = 2):
        super().__init__()
        self.k, self.s = k, s

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.k // 2 if self.k % 2 else 0)


class Index(nn.Module):
    """One element of a list input."""

    def __init__(self, index: int = 0):
        super().__init__()
        self.index = index

    def forward(self, xs):
        return xs[self.index]


class GhostConv(nn.Module):
    """Ghost convolution: a ConvBN to half the channels, and a depthwise
    5x5 ConvBN of that half beside it."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act: bool = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBN(c1, c_, k, s, act=act)
        self.cv2 = ConvBN(c_, c_, 5, 1, g=c_, act=act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=1)


class GhostBottleneck(nn.Module):
    """Two GhostConvs (a depthwise strided conv between them where s is
    2, and a depthwise + 1x1 shortcut), the input added where the shapes
    agree."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.s = s
        self.g1 = GhostConv(c1, c_, 1, 1)
        if s == 2:
            self.dw = DWConv(c_, c_, k, s, act=False)
        self.g2 = GhostConv(c_, c2, 1, 1, act=False)
        if s == 2:
            self.sc1 = DWConv(c1, c1, k, s, act=False)
            self.sc2 = ConvBN(c1, c2, 1, 1, act=False)

    def forward(self, x):
        y = self.g1(x)
        if self.s == 2:
            y = self.dw(y)
            x = self.sc2(self.sc1(x))
        y = self.g2(y)
        return x + y if x.shape == y.shape else y


class C3Ghost(C3):
    """C3 with GhostBottlenecks (``shortcut`` is taken for the YAML row's
    sake and unused, as in the JAX block)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5):
        super().__init__(c1, c2, n, e=e, block=lambda c: GhostBottleneck(c, c))


def conv_transpose_same_pad(k: int, s: int) -> tuple[int, int]:
    """flax ``ConvTranspose``'s default ``"SAME"`` padding (lax's
    ``_conv_transpose_padding``): the (before, after) padding of the
    stride-dilated input, which gives an output of ``s`` times the input."""
    pad_len = k + s - 2
    before = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return before, pad_len - before


class ConvTransposeBN(nn.Module):
    """Transposed conv (no bias) + BatchNorm + SiLU, with flax's
    ``ConvTranspose`` semantics: an output of ``s`` times the input, and
    the kernel not flipped (``utils.jax_weights`` flips the flax kernel
    into torch's (in, out, kh, kw) layout, so torch's transposed conv,
    which flips, computes the same)."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, act: bool = True):
        super().__init__()
        self.k, self.s = k, s
        self.conv = nn.ConvTranspose2d(c1, c2, k, s, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    def init_params(self, g: torch.Generator) -> None:
        w = self.conv.weight  # (in, out, kh, kw): flax's fan-in is in * kh * kw
        std = math.sqrt(1.0 / (w.shape[0] * w[0, 0].numel())) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
        if isinstance(self.bn, nn.BatchNorm2d):
            self.bn.reset_parameters()

    def forward(self, x):
        conv = self.conv
        y = F.conv_transpose2d(x, conv.weight.to(x.dtype), None, self.s)  # pads k - 1 a side
        before, after = conv_transpose_same_pad(self.k, self.s)
        h, w = x.shape[2] * self.s, x.shape[3] * self.s
        start = self.k - 1 - before
        y = y[..., start:start + h, start:start + w]
        y = F.pad(y, (0, w - y.shape[3], 0, h - y.shape[2]))  # after > k - 1: zero rows
        if conv.bias is not None:  # folded by fuse_conv_bn
            y = y + conv.bias.to(x.dtype).reshape(1, -1, 1, 1)
        if isinstance(self.bn, nn.BatchNorm2d):
            y = batch_norm_train(y, self.bn) if self.training else batch_norm_eval(y, self.bn)
        return F.silu(y) if self.act else y


class SPP(nn.Module):
    """Spatial pyramid pooling: parallel stride-1 max pools of kernels ``k``."""

    def __init__(self, c1: int, c2: int, k: tuple = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        outs = [y] + [F.max_pool2d(y, k, 1, k // 2) for k in self.k]
        return self.cv2(torch.cat(outs, dim=1))


def pad_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """v9's 2x2 stride-1 average pool after one zero row and column at the
    bottom and right, the pad counted: the size stays (flax's ``avg_pool``
    with ``padding=((0, 1), (0, 1))``)."""
    return F.avg_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1)


class ADown(nn.Module):
    """v9 downsample: after ``pad_avg_pool``, half the channels through a
    strided 3x3 ConvBN, the other half through a 3x3 stride-2 max pool and
    a 1x1 ConvBN."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        c = c2 // 2
        self.cv1 = ConvBN(c1 // 2, c, 3, 2)
        self.cv2 = ConvBN(c1 // 2, c, 1, 1)

    def forward(self, x):
        x1, x2 = pad_avg_pool(x).chunk(2, dim=1)
        return torch.cat([self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))], dim=1)


class AConv(nn.Module):
    """v9-t/s downsample: ``pad_avg_pool``, then a strided 3x3 ConvBN."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 3, 2)

    def forward(self, x):
        return self.cv1(pad_avg_pool(x))


class RepConv(nn.Module):
    """A k x k and a 1x1 ConvBN (no activation) summed, then SiLU: the
    train form of the re-parameterizable conv, as the JAX package keeps it."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, act: bool = True):
        super().__init__()
        self.conv1 = ConvBN(c1, c2, k, s, act=False)
        self.conv2 = ConvBN(c1, c2, 1, s, act=False)
        self.act = act

    def forward(self, x):
        y = self.conv1(x) + self.conv2(x)
        return F.silu(y) if self.act else y


class RepC3(nn.Module):
    """RT-DETR's neck block: ``cv1`` and ``cv2`` (1x1 to c2), ``n`` RepConvs
    ``m{i}`` chained on ``cv1``'s branch at c2 * e channels, the two
    branches summed, then ``cv3`` (1x1 to c2) where c2 * e != c2. As in
    JAX, the sum adds c2 * e channels to c2 ones: it broadcasts where c2 * e
    rounds to 1 and raises for any other e below 1."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = ConvBN(c1, c2, 1, 1)
        for i in range(n):
            setattr(self, f"m{i}", RepConv(c2 if i == 0 else c_, c_, 3))
        self.cv2 = ConvBN(c1, c2, 1, 1)
        self.cv3 = ConvBN(c2, c2, 1, 1) if c_ != c2 else None

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        y = a + self.cv2(x)
        return y if self.cv3 is None else self.cv3(y)


class LightConv(nn.Module):
    """A 1x1 ConvBN without activation (``conv1``), then a depthwise k x k
    ReLU ConvBN (``conv2``)."""

    def __init__(self, c1: int, c2: int, k: int = 3):
        super().__init__()
        self.conv1 = ConvBN(c1, c2, 1, act=False)
        self.conv2 = DWConv(c2, c2, k, act="relu")

    def forward(self, x):
        return self.conv2(self.conv1(x))


class RepBottleneck(nn.Module):
    """Bottleneck whose first conv is a RepConv."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = RepConv(c1, c_, 3, 1)
        self.cv2 = ConvBN(c_, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepCSP(C3):
    """C3 with RepBottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, e=e, block=lambda c: RepBottleneck(c, c, True, e=1.0))


class RepNCSPELAN4(nn.Module):
    """YOLOv9's ELAN block, YAML args [c2, c3, c4, n]: ``cv1`` to c3
    channels split in two; the second half through RepCSP + 3x3 ConvBN
    twice; all four concatenated into ``cv4``."""

    def __init__(self, c1: int, c2: int, c3: int = 64, c4: int = 32, n: int = 1):
        super().__init__()
        self.cv1 = ConvBN(c1, c3, 1, 1)
        self.csp1 = RepCSP(c3 // 2, c4, n)
        self.cv2 = ConvBN(c4, c4, 3, 1)
        self.csp2 = RepCSP(c4, c4, n)
        self.cv3 = ConvBN(c4, c4, 3, 1)
        self.cv4 = ConvBN(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x):
        y1, y2 = self.cv1(x).chunk(2, dim=1)
        y3 = self.cv2(self.csp1(y2))
        y4 = self.cv3(self.csp2(y3))
        return self.cv4(torch.cat([y1, y2, y3, y4], dim=1))


class SPPELAN(nn.Module):
    """SPP-ELAN: ``cv1`` to c3 channels, three chained stride-1 max pools,
    all four into ``cv5``. YAML args [c2, c3], both width-scaled."""

    def __init__(self, c1: int, c2: int, c3: int = 0, k: int = 5):
        super().__init__()
        c3 = c3 or c2 // 2
        self.k = k
        self.cv1 = ConvBN(c1, c3, 1, 1)
        self.cv5 = ConvBN(4 * c3, c2, 1, 1)

    @classmethod
    def parse(cls, args, ch_in, width=1.0, **kw):
        from .graph import make_divisible

        c2 = make_divisible(args[0] * width, 8)
        c3 = make_divisible(args[1] * width, 8) if len(args) > 1 else 0
        return c2, [ch_in[0], c2, c3, *args[2:]], {}

    def forward(self, x):
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], self.k, 1, self.k // 2))
        return self.cv5(torch.cat(outs, dim=1))


class ELAN1(nn.Module):
    """YOLOv9-t's basic ELAN, YAML args [c2, c3, c4], all width-scaled."""

    def __init__(self, c1: int, c2: int, c3: int = 0, c4: int = 0):
        super().__init__()
        c3 = c3 or c2 // 2
        c4 = c4 or c3 // 2
        self.cv1 = ConvBN(c1, c3, 1, 1)
        self.cv2 = ConvBN(c3 // 2, c4, 3, 1)
        self.cv3 = ConvBN(c4, c4, 3, 1)
        self.cv4 = ConvBN(c3 + 2 * c4, c2, 1, 1)

    @classmethod
    def parse(cls, args, ch_in, width=1.0, **kw):
        from .graph import make_divisible

        scaled = [make_divisible(a * width, 8) for a in args[:3]]
        return scaled[0], [ch_in[0], *scaled], {}

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, dim=1)
        c = self.cv2(b)
        d = self.cv3(c)
        return self.cv4(torch.cat([a, b, c, d], dim=1))


class CBLinear(nn.Module):
    """YOLOv9-e's dual-branch projection: one conv (with bias) to
    sum(c2s) channels, returned as a list of c2s-sized maps. YAML args
    [c2s, k, s], c2s width-scaled; the layer's channels are the tuple."""

    def __init__(self, c1: int, c2s: tuple, k: int = 1, s: int = 1):
        super().__init__()
        self.c2s = tuple(c2s)
        self.conv = nn.Conv2d(c1, sum(self.c2s), k, s, autopad(k))

    @classmethod
    def parse(cls, args, ch_in, width=1.0, **kw):
        from .graph import make_divisible

        c2s = tuple(make_divisible(c * width, 8) for c in args[0])
        return c2s, [ch_in[0], c2s, *args[1:]], {}

    def init_params(self, g: torch.Generator) -> None:
        lecun_normal_(self.conv.weight, g)
        nn.init.zeros_(self.conv.bias)

    def forward(self, x):
        return list(conv_in_dtype(self.conv, x).split(self.c2s, dim=1))


class CBFuse(nn.Module):
    """Sum of the last input (the target) and, from each earlier input (a
    CBLinear's list), its map ``idx[i]`` resized to the target's size:
    nearest with half-pixel centres (``"nearest-exact"``), as
    ``jax.image.resize(..., "nearest")`` samples."""

    def __init__(self, idx: tuple = ()):
        super().__init__()
        self.idx = tuple(idx)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        return ch_in[-1], [], {"idx": tuple(args[0]) if args else ()}

    def forward(self, xs):
        target = xs[-1]
        acc = target
        for i, x in enumerate(xs[:-1]):
            sel = x[self.idx[i]] if isinstance(x, (list, tuple)) else x
            acc = acc + F.interpolate(sel, size=tuple(target.shape[2:]), mode="nearest-exact")
        return acc


class SCDown(nn.Module):
    """v10 separable downsample: 1x1 ConvBN, then a depthwise strided
    ConvBN without activation."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 1, 1)
        self.cv2 = ConvBN(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class RepVGGDW(nn.Module):
    """A 7x7 and a 3x3 DWConv (no activation) summed, then SiLU (the JAX
    package's second ``RepVGGDW``, the one its name binds)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv = DWConv(c1, c2, 7, 1, act=False)
        self.conv1 = DWConv(c1, c2, 3, 1, act=False)

    def forward(self, x):
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """v10's cheap inverted block: depthwise 3x3, 1x1 up, depthwise 3x3
    (or a RepVGGDW where ``lk``), 1x1 down, depthwise 3x3; the input added
    where ``shortcut`` and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, lk: bool = False,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv0 = ConvBN(c1, c1, 3, 1, g=c1)
        self.cv1 = ConvBN(c1, 2 * c_, 1, 1)
        if lk:
            self.cv2lk = RepVGGDW(2 * c_, 2 * c_)
        else:
            self.cv2 = ConvBN(2 * c_, 2 * c_, 3, 1, g=2 * c_)
        self.cv3 = ConvBN(2 * c_, c2, 1, 1)
        self.cv4 = ConvBN(c2, c2, 3, 1, g=c2, act=False)
        self.lk = lk
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(self.cv0(x))
        y = self.cv2lk(y) if self.lk else self.cv2(y)
        y = self.cv4(self.cv3(y))
        return x + y if self.add else y


class C2fCIB(nn.Module):
    """C2f whose inner blocks are CIBs at full expansion."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False,
                 e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.n = n
        self.cv1 = ConvBN(c1, 2 * c, 1, 1)
        for i in range(n):
            setattr(self, f"m{i}", CIB(c, c, shortcut, lk=lk, e=1.0))
        self.cv2 = ConvBN((2 + n) * c, c2, 1, 1)

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, dim=1))
        for i in range(self.n):
            ys.append(getattr(self, f"m{i}")(ys[-1]))
        return self.cv2(torch.cat(ys, dim=1))


class PSA(nn.Module):
    """v10's position-sensitive attention: on half of ``cv1``'s output an
    Attention (one head per 64 channels) and a two-conv FFN, each with a
    residual."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * c, 1, 1)
        self.attn = Attention(c, num_heads=max(1, c // 64), attn_ratio=0.5)
        self.ffn0 = ConvBN(c, 2 * c, 1)
        self.ffn1 = ConvBN(2 * c, c, 1, act=False)
        self.cv2 = ConvBN(2 * c, c2, 1)

    def forward(self, x):
        a, b = self.cv1(x).chunk(2, dim=1)
        b = b + self.attn(b)
        b = b + self.ffn1(self.ffn0(b))
        return self.cv2(torch.cat([a, b], dim=1))


class AAttn(nn.Module):
    """YOLO12's area attention: full attention within ``area`` row-major
    strips of each image's H*W tokens (one area where H*W % area != 0),
    plus a depthwise 7x7 positional conv of v. The ``qkv`` channels are
    (3, head, head_dim), the JAX block's NHWC reshape; scores and softmax
    in fp32."""

    def __init__(self, dim: int, num_heads: int = 8, area: int = 1):
        super().__init__()
        self.dim, self.num_heads, self.area = dim, num_heads, area
        self.head_dim = dim // num_heads
        self.qkv = ConvBN(dim, 3 * dim, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 7, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        n = H * W
        area = self.area if n % self.area == 0 else 1
        qkv = self.qkv(x).flatten(2).transpose(1, 2)  # (B, n, 3 dim): the NHWC order
        qkv = qkv.reshape(B * area, n // area, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)  # (B area, n', NH, hd)
        attn = torch.einsum("bnhd,bmhd->bhnm", at_least_fp32(q),
                            at_least_fp32(k)) / self.head_dim ** 0.5
        attn = attn.softmax(dim=-1).to(v.dtype)
        y = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, H, W, C).permute(0, 3, 1, 2)
        pe = self.pe(v.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return self.proj(y + pe)


class ABlock(nn.Module):
    """Area attention and a two-conv MLP, each with a residual."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 1.2, area: int = 1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        self.mlp0 = ConvBN(dim, int(dim * mlp_ratio), 1)
        self.mlp1 = ConvBN(int(dim * mlp_ratio), dim, 1, act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp1(self.mlp0(x))


class A2C2f(nn.Module):
    """YOLO12's area-attention CSP block, YAML args [c2, a2, area] (the
    repeat count n goes after c2): ``cv1`` to c2 * e channels, then n pairs
    of ABlocks (one head per 32 channels; ``a2``) or n ``C3k(c, c, 2)``,
    every stage's output into ``cv2``. A non-positive ``area`` is one area;
    ``residual`` (with ``a2`` and c1 == c2) adds the input back through a
    per-channel ``gamma`` (init 0.01)."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True, area: int = 1,
                 residual: bool = False, e: float = 0.5, mlp_ratio: float = 2.0):
        super().__init__()
        c = int(c2 * e)
        self.n, self.a2 = n, a2
        area = area if area and area > 0 else 1
        self.cv1 = ConvBN(c1, c, 1, 1)
        for i in range(n):
            if a2:
                for tag in "ab":
                    setattr(self, f"m{i}{tag}", ABlock(c, max(1, c // 32), mlp_ratio, area))
            else:
                setattr(self, f"m{i}", C3k(c, c, 2, True))
        self.cv2 = ConvBN((1 + n) * c, c2, 1)
        if residual and a2 and c1 == c2:
            self.gamma = nn.Parameter(torch.full((c2,), 0.01))
        else:
            self.gamma = None

    def init_params(self, g: torch.Generator) -> None:
        if self.gamma is not None:
            nn.init.constant_(self.gamma, 0.01)

    def forward(self, x):
        ys = [self.cv1(x)]
        for i in range(self.n):
            if self.a2:
                ys.append(getattr(self, f"m{i}b")(getattr(self, f"m{i}a")(ys[-1])))
            else:
                ys.append(getattr(self, f"m{i}")(ys[-1]))
        out = self.cv2(torch.cat(ys, dim=1))
        if self.gamma is not None:
            out = x + self.gamma.to(out.dtype).reshape(1, -1, 1, 1) * out
        return out


class Classify(nn.Module):
    """The classification head: ``conv`` (a 1x1 ConvBN to 1280 channels),
    the mean over H and W, then the ``linear`` Dense to ``nc`` logits. No
    dropout, as in the JAX ``Classify`` (the reference's has one)."""

    def __init__(self, c1: int, nc: int, c_: int = 1280):
        super().__init__()
        self.conv = ConvBN(c1, c_, 1, 1)
        self.linear = nn.Linear(c_, nc)

    def init_params(self, g: torch.Generator) -> None:
        lecun_normal_(self.linear.weight, g)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x):
        # flax's Dense(dtype=None) promotes: bf16 activations meet fp32
        # parameters in fp32 (the logits of an AMP step are fp32)
        x = self.conv(x).mean((2, 3))
        w, b = self.linear.weight, self.linear.bias
        dt = torch.promote_types(x.dtype, w.dtype)
        return F.linear(x.to(dt), w.to(dt), b.to(dt))


class ResNetBlock(nn.Module):
    """The ResNet bottleneck: ``cv1`` 1x1, ``cv2`` 3x3 at stride ``s``
    (both ReLU), ``cv3`` 1x1 to e * c2, and a ``shortcut`` 1x1 ConvBN where
    the stride or the channels change; ReLU of the sum."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: int = 4):
        super().__init__()
        c3 = e * c2
        self.cv1 = ConvBN(c1, c2, 1, 1, act="relu")
        self.cv2 = ConvBN(c2, c2, 3, s, act="relu")
        self.cv3 = ConvBN(c2, c3, 1, act=False)
        self.shortcut = ConvBN(c1, c3, 1, s, act=False) if s != 1 or c1 != c3 else None

    def forward(self, x):
        y = self.cv3(self.cv2(self.cv1(x)))
        return F.relu((x if self.shortcut is None else self.shortcut(x)) + y)


class ResNetLayer(nn.Module):
    """A ResNet stage, YAML args [c2, s, is_first, n] (c2 not width-scaled):
    with ``is_first`` the ``stem`` (a 7x7 stride-2 ConvBN padded by 3, ReLU)
    and a 3x3 stride-2 max pool padded by 1; else n ResNetBlocks ``b0`` ...
    (the first at stride ``s``), out e * c2 channels."""

    def __init__(self, c1: int, c2: int, s: int = 1, is_first: bool = False, n: int = 1,
                 e: int = 4):
        super().__init__()
        self.is_first, self.n = is_first, n
        if is_first:
            self.stem = ConvBN(c1, c2, 7, 2, p=3, act="relu")
        else:
            for i in range(n):
                setattr(self, f"b{i}", ResNetBlock(c1 if i == 0 else e * c2, c2,
                                                   s if i == 0 else 1, e))

    @classmethod
    def parse(cls, args, ch_in, **kw):
        c2 = int(args[0])
        s = int(args[1]) if len(args) > 1 else 1
        is_first = bool(args[2]) if len(args) > 2 else False
        n = int(args[3]) if len(args) > 3 else 1
        return (c2 if is_first else 4 * c2), [ch_in[0], c2, s, is_first, n], {}

    def forward(self, x):
        if self.is_first:
            return F.max_pool2d(self.stem(x), 3, 2, 1)
        for i in range(self.n):
            x = getattr(self, f"b{i}")(x)
        return x


class BasicResBlock(nn.Module):
    """The resnet18 / 34 block: ``conv1`` 3x3 at stride ``s`` (ReLU),
    ``conv2`` 3x3, a ``down`` 1x1 ConvBN where the stride or the channels
    change; ReLU of the sum."""

    def __init__(self, c1: int, c2: int, s: int = 1):
        super().__init__()
        self.conv1 = ConvBN(c1, c2, 3, s, act="relu")
        self.conv2 = ConvBN(c2, c2, 3, 1, act=False)
        self.down = ConvBN(c1, c2, 1, s, act=False) if s != 1 or c1 != c2 else None

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return F.relu((x if self.down is None else self.down(x)) + y)


class TorchVision(nn.Module):
    """The JAX package's stand-in for the reference's ``TorchVision`` row,
    YAML args [c2, model, weights, unwrap, truncate, split]: the named
    torchvision ResNet (resnet18, 34, 50, 101, 152) built here, truncated
    before avgpool and fc (``truncate=2``, ``unwrap=True``), so the P5/32
    map: the ``stem`` and its max pool, then ``s{si}b{bi}`` blocks
    (BasicResBlock, or ResNetBlock for 50 and up). ``weights`` is ignored:
    nothing is downloaded. Another model, ``split``, ``unwrap=False`` or
    another ``truncate`` raises, as in JAX."""

    CFG = {"resnet18": ((2, 2, 2, 2), False), "resnet34": ((3, 4, 6, 3), False),
           "resnet50": ((3, 4, 6, 3), True), "resnet101": ((3, 4, 23, 3), True),
           "resnet152": ((3, 8, 36, 3), True)}

    def __init__(self, c1: int, c2: int, model: str = "resnet18", weights: str | None = "DEFAULT",
                 unwrap: bool = True, truncate: int = 2, split: bool = False):
        super().__init__()
        if model not in self.CFG:
            raise NotImplementedError(
                f"TorchVision stand-in supports {sorted(self.CFG)}, got {model!r}")
        if split or not unwrap or truncate != 2:
            raise NotImplementedError(
                "TorchVision stand-in supports unwrap=True, truncate=2, split=False")
        blocks, bottleneck = self.CFG[model]
        self.stem = ConvBN(c1, 64, 7, 2, p=3, act="relu")
        self.names = []
        c, cin = 64, 64
        for si, n in enumerate(blocks):
            for bi in range(n):
                s = 2 if (si > 0 and bi == 0) else 1
                block = ResNetBlock(cin, c, s, 4) if bottleneck else BasicResBlock(cin, c, s)
                setattr(self, f"s{si}b{bi}", block)
                self.names.append(f"s{si}b{bi}")
                cin = 4 * c if bottleneck else c
            c *= 2

    @classmethod
    def parse(cls, args, ch_in, **kw):
        return int(args[0]), [ch_in[0], *args], {}

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        for name in self.names:
            x = getattr(self, name)(x)
        return x
