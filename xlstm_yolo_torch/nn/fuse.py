"""Conv+BN folding and the parameter cast for inference.

Port of ``xlstm_yolo_tpu/nn/fuse.py:fuse_conv_bn``. The JAX version folds the
BN affine and running statistics into the conv kernel and leaves an identity
BN carrying the bias; here the folded bias moves onto the conv and the BN is
replaced by ``nn.Identity``, so eval runs one op per ConvBN instead of two.
A ``ConvTransposeBN`` folds the same way, along its weight's output
channels, which are dim 1 of torch's (in, out, kh, kw). The task heads'
ConvBNs fold as any other; the Segment head's ``proto_up`` (a transposed
conv with a bias and no BatchNorm) is left as it is, as in JAX.
``cast_params`` is the cast the JAX ``bench.py`` applies after folding for
bf16 serving.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .modules import ConvBN, ConvTransposeBN


@torch.no_grad()
def fuse_conv_bn(model: nn.Module) -> nn.Module:
    """Fold every ConvBN's and ConvTransposeBN's BatchNorm into its conv, in
    place; returns ``model``. Exact at eval (BN in running-statistics
    mode)."""
    for m in model.modules():
        if not (isinstance(m, (ConvBN, ConvTransposeBN)) and isinstance(m.bn, nn.BatchNorm2d)):
            continue
        conv, bn = m.conv, m.bn
        inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        kw = dict(bias=True, device=conv.weight.device, dtype=conv.weight.dtype)
        if isinstance(m, ConvTransposeBN):
            fused = nn.ConvTranspose2d(conv.in_channels, conv.out_channels, conv.kernel_size,
                                       conv.stride, **kw)
            fused.weight.copy_(conv.weight * inv.reshape(1, -1, 1, 1))
        else:
            fused = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size,
                              conv.stride, conv.padding, conv.dilation, conv.groups, **kw)
            fused.weight.copy_(conv.weight * inv.reshape(-1, 1, 1, 1))
        fused.bias.copy_(bn.bias - bn.running_mean * inv)
        m.conv, m.bn = fused, nn.Identity()
    return model


@torch.no_grad()
def cast_params(model: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast every parameter of ``model`` to ``dtype`` in place; returns
    ``model``. Buffers (the BatchNorm running statistics) keep their fp32,
    as the JAX ``bench.py`` casts ``params`` and keeps ``batch_stats``."""
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model
