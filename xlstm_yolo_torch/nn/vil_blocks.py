"""YAML-graph wrapper for the ViL stages.

Port of ``ViLBlockPairBlock`` in ``xlstm_yolo_tpu/nn/vil_blocks.py``: ``n``
ViLBlockPairs over an NCHW map, whose token grid (row-major H, W) is taken
from the map's shape, so one YAML serves every input resolution.
"""
from __future__ import annotations

import torch.nn as nn

from . import vil as V


class ViLBlockPairBlock(nn.Module):
    """YAML: ``[c1, c2, config]`` with config keys qkv_block_size,
    chunk_size, conv_kernel_size, igate_act, bidirectional."""

    def __init__(self, c2: int, config: dict | None = None, n: int = 1):
        super().__init__()
        cfg = dict(config or {})
        self.n = n
        for i in range(n):
            setattr(self, f"pair{i}", V.ViLBlockPair(
                dim=c2,
                qkv_block_size=int(cfg.get("qkv_block_size", 16)),
                chunk_size=int(cfg.get("chunk_size", 256)),
                conv_kernel_size=int(cfg.get("conv_kernel_size", 3)),
                igate_act=str(cfg.get("igate_act", "exp")),
                bidirectional=bool(cfg.get("bidirectional", False)),
            ))

    @classmethod
    def parse(cls, args, c1: int, width: float, max_ch: float, n: int):
        """Channel resolution for the graph compiler: (c2, args, kwargs)."""
        from .graph import make_divisible

        if len(args) >= 2 and isinstance(args[1], int):
            c2, config = args[1], (args[2] if len(args) > 2 else {})
        else:
            c2, config = args[0], (args[1] if len(args) > 1 else {})
        c2 = make_divisible(min(c2, max_ch) * width, 8)
        return c2, [c2], {"config": config, "n": n}

    def forward(self, x):  # (B, C, H, W)
        b, c, h, w = x.shape
        seq = x.flatten(2).transpose(1, 2)  # (B, H*W, C), token index h*W + w
        for i in range(self.n):
            seq = getattr(self, f"pair{i}")(seq, (h, w))
        return seq.transpose(1, 2).reshape(b, c, h, w)
