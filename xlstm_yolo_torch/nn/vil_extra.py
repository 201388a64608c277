"""The standalone ViL model in torch.

Port of ``VisionLSTM2`` in ``xlstm_yolo_tpu/nn/vil_extra.py``: patch embed,
position embed, ``depth`` ViLBlockPairs with a stochastic-depth schedule, a
final LayerNorm, one of three poolings and, as a classifier, a linear head.
Submodule names follow the JAX tree (``patch_embed/proj``,
``pos_embed/embed``, ``block{i}/fwd/layer/...``, ``norm``, ``head``), so
``utils.jax_weights.load_jax_variables`` fills it. The rest of that JAX
module (the hierarchical model, the ViT baseline, the fusion blocks) is not
ported.

``qkv_block_size`` is the head dim of the ViL layers (``num_heads = 2 * dim
// qkv_block_size``), as in the JAX class; its default, 4, gives 96 heads at
dim 192. On the CPU any head dim runs; on the GPU the ViL kernels take head
dims 4, 8, 16, 32 and 64 (another raises there).

The JAX package has no trainer for this model: a train step is the model in
train mode with a generator, ``utils.loss.classification_loss``,
``backward()`` and ``utils.train_utils.StepUpdate``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..utils import resolve_device
from .modules import init_tree, lecun_normal_
from .vil import AffineLayerNorm, ViLBlockPair, VitPatchEmbed, VitPosEmbed2d

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
