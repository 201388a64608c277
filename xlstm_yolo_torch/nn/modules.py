"""Conv blocks of the detection graphs, NCHW.

Port of the blocks of ``xlstm_yolo_tpu/nn/modules.py`` that the ViL-YOLO and
YOLOv8 graphs use: ConvBN, Bottleneck, C2f, SPPF, Concat and Upsample.
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
