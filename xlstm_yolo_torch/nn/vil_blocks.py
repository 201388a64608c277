"""YAML-graph blocks of the ViL subsystem.

Port of the sequence-domain blocks of ``xlstm_yolo_tpu/nn/vil_blocks.py``,
registered under the JAX names (``graph.REGISTRY``): ViLBlockPairBlock,
SequenceToImage, ImageToSequence, PermuteBlock, FeatureSplitIndex,
VitPatchEmbedBlock, VitPosEmbedBlock, FlattenPosEmbedBlock,
SequenceConv2dBlock, PatchMergeBlock, PatchMerging, VisionClueMerge,
PatchMerger, ViLLayerNormBlock, MultiScaleFusionBlock, ViLFusionBlock (with
RGBlock and LSBlock), VisionLSTM (``VisionLSTMBlock``), FusionViLLayerBlock,
VilLayerUpdated / mLSTMVisionBlock (both ``mLSTMVisionBlockWrap``), and
MoEFFN (``MoEFFNBlock``, over ``parallel/moe.py``). Layouts: a
sequence is (B, S, D) with tokens in row-major (H, W) order, as in the JAX
package; an image is NCHW, as every other layer of the port (the JAX blocks
are NHWC), so SequenceToImage gives (B, D, H, W) and ImageToSequence takes
it. A list output (VisionLSTM's partials) is a Python list, which
FeatureSplitIndex indexes.

Each block has ``parse(args, ch_in, width, max_ch, n) -> (c2, args,
kwargs)``, the graph compiler's channel rule, with ``ch_in`` the channels
of every input the row reads (the JAX ``parse`` reads them from
``channels, fs``). Submodule and parameter names follow the JAX tree, so
``utils.jax_weights.load_jax_variables`` fills every block.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.moe import MoEFeedForward
from . import vil as V
from .modules import (BN_EPS, BN_MOMENTUM, ConvBN, batch_norm_eval, batch_norm_train,
                      conv_in_dtype, lecun_normal_, linear_in_dtype)


def _seqlens(cfg: dict):
    s = cfg.get("seqlens")
    return tuple(s) if s else None


def _nchw_to_seq(x):  # (B, D, H, W) -> (B, H*W, D); a sequence passes as it is
    return x.flatten(2).transpose(1, 2) if x.dim() == 4 else x


def _init_dense(g: torch.Generator, *layers) -> None:
    """flax's default Dense / Conv init: lecun-normal kernel, zero bias."""
    for m in layers:
        lecun_normal_(m.weight, g)
        if m.bias is not None:
            nn.init.zeros_(m.bias)


class ViLBlockPairBlock(nn.Module):
    """``n`` ViLBlockPairs. YAML: ``[c1, c2, config]``, config keys
    qkv_block_size (16), chunk_size (256, the plain path's), conv_kernel_size,
    igate_act, bidirectional, seqlens, backend. An NCHW map gives its token
    grid from its shape; a (B, S, D) sequence takes ``seqlens`` (a square
    grid without it). ``backend`` is the ViL layers' ``mlstm_backend``:
    "auto" and "pallas" run the kernels on the card ("pallas" refuses the
    CPU), "native" the plain torch versions.

    ``stack(stages, microbatches, mesh)`` (``TaskModel.enable_pipeline``)
    switches the n pairs to the JAX stacked layout: one pair module
    ``pairs`` whose every parameter holds the n pairs' tensors stacked on a
    leading axis (the weights carried over), each pair applied with its
    slice (``torch.func.functional_call``). With a mesh whose pp axis has
    ``stages`` ranks and a local batch that divides into the microbatches
    (``pp_microbatches``, or ``stages`` when 0), the pairs run as a GPipe
    pipeline (``parallel.pipeline``), n / stages a rank, on this rank's
    stage (``shard_params`` stores only it); otherwise, or without a mesh,
    the stacked pairs apply one after another: the same parameters and the
    same numbers."""

    stacked_init = False  # init_tree initializes a stacked block's pairs itself

    def __init__(self, c2: int, config: dict | None = None, n: int = 1):
        super().__init__()
        cfg = dict(config or {})
        self.n = n
        self.seqlens = _seqlens(cfg)
        self.pair_kwargs = dict(
            dim=c2,
            qkv_block_size=int(cfg.get("qkv_block_size", 16)),
            seqlens=self.seqlens,
            chunk_size=int(cfg.get("chunk_size", 256)),
            conv_kernel_size=int(cfg.get("conv_kernel_size", 3)),
            igate_act=str(cfg.get("igate_act", "exp")),
            bidirectional=bool(cfg.get("bidirectional", False)),
            mlstm_backend=str(cfg.get("backend", "auto")),
        )
        self.pp_stages, self.pp_microbatches, self.pp_mesh = 0, 0, None
        for i in range(n):
            setattr(self, f"pair{i}", V.ViLBlockPair(**self.pair_kwargs))

    @classmethod
    def parse(cls, args, ch_in, width: float = 1.0, max_ch: float = float("inf"), n: int = 1):
        from .graph import make_divisible

        if len(args) >= 2 and isinstance(args[1], int):
            c2, config = args[1], (args[2] if len(args) > 2 else {})
        else:
            c2, config = args[0], (args[1] if len(args) > 1 else {})
        c2 = make_divisible(min(c2, max_ch) * width, 8)
        return c2, [c2], {"config": config, "n": n}

    @torch.no_grad()
    def stack(self, stages: int, microbatches: int = 0, mesh=None) -> None:
        """Switch to the stacked layout (``stages`` > 1; see the class)."""
        if self.n % stages:
            raise ValueError(f"pipeline over pp={stages} needs the pair count ({self.n}) "
                             f"divisible — use a scale with n % pp == 0 blocks per stage")
        if self.pp_stages == 0:
            pairs = [getattr(self, f"pair{i}") for i in range(self.n)]
            for name, p in list(pairs[0].named_parameters()):
                path, _, leaf = name.rpartition(".")
                stacked = torch.stack([q.get_parameter(name) for q in pairs])
                setattr(pairs[0].get_submodule(path), leaf,
                        nn.Parameter(stacked, requires_grad=p.requires_grad))
            for i in range(self.n):
                delattr(self, f"pair{i}")
            self.pairs = pairs[0]
            self.stacked_init = True
        self.pp_stages, self.pp_microbatches, self.pp_mesh = stages, int(microbatches), mesh

    @torch.no_grad()
    def unstack(self) -> None:
        """Back to the n pair modules ``pair{i}`` (the whole stack must be
        held here), off any pipeline."""
        if self.pp_stages == 0:
            return
        stacked = dict(self.pairs.named_parameters())
        for i in range(self.n):
            pair = V.ViLBlockPair(**self.pair_kwargs).to(next(iter(stacked.values())).device)
            for name, p in pair.named_parameters():
                p.copy_(stacked[name][i])
                p.requires_grad_(stacked[name].requires_grad)
            setattr(self, f"pair{i}", pair)
        del self.pairs
        self.stacked_init = False
        self.pp_stages, self.pp_microbatches, self.pp_mesh = 0, 0, None

    def leave_mesh(self) -> None:
        self.pp_mesh = None

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        if self.pp_stages == 0:
            return  # the pairs' own modules initialize themselves
        for i in range(self.n):
            pair = V.ViLBlockPair(**self.pair_kwargs)
            for m in pair.modules():
                if hasattr(m, "init_params"):
                    m.init_params(g)
            for name, p in pair.named_parameters():
                self.pairs.get_parameter(name)[i].copy_(p)

    def _apply_pair(self, params: dict, i, x, seqlens):
        return torch.func.functional_call(self.pairs, {k: v[i] for k, v in params.items()},
                                          (x, seqlens))

    def _run(self, x, seqlens):
        if self.pp_stages == 0:
            for i in range(self.n):
                x = getattr(self, f"pair{i}")(x, seqlens)
            return x
        from ..parallel.distributed import gather_shard
        from ..parallel.pipeline import pipeline_apply_nested

        pp, mesh = self.pp_stages, self.pp_mesh
        stacked = dict(self.pairs.named_parameters())
        n_loc = next(iter(stacked.values())).shape[0]
        M = self.pp_microbatches or pp
        group = None if mesh is None else mesh.group_of("pp")
        if group is not None and mesh.shape["pp"] == pp and x.shape[0] % M == 0:
            per = self.n // pp
            if n_loc == self.n:  # the whole stack held here: this rank's stage of it
                r = mesh.index("pp")
                stacked = {k: v[r * per:(r + 1) * per] for k, v in stacked.items()}

            def stage_fn(ps, a):
                for k in range(per):
                    a = self._apply_pair(ps, k, a, seqlens)
                return a

            return pipeline_apply_nested(mesh, stage_fn, stacked, x, num_microbatches=M)
        if n_loc != self.n:  # a stage held here, run sequentially: gather the stack
            if group is None:
                raise ValueError(f"{n_loc} of {self.n} stacked pairs held and no pp group")
            stacked = {k: gather_shard(v, group, 0) for k, v in stacked.items()}
        for i in range(self.n):
            x = self._apply_pair(stacked, i, x, seqlens)
        return x

    def forward(self, x):
        if x.dim() == 3:  # (B, S, D)
            return self._run(x, self.seqlens)
        b, c, h, w = x.shape
        seq = x.flatten(2).transpose(1, 2)  # (B, H*W, C), token index h*W + w
        seq = self._run(seq, (h, w))
        return seq.transpose(1, 2).reshape(b, c, h, w)


class MoEFFNBlock(nn.Module):
    """Mixture-of-experts FFN as a YAML block, residual over tokens:
    ``[-1, 1, MoEFFN, [num_experts, top_k]]`` (4 and 1 by default),
    channel-preserving; an NCHW map's tokens in row-major (H, W) order, a
    (B, S, D) sequence as it is. The experts shard over the mesh's ep axis
    (``parallel.moe``); the load-balance loss joins the task loss
    (``TaskModel.loss``)."""

    def __init__(self, c2: int, num_experts: int = 4, top_k: int = 1):
        super().__init__()
        self.moe = MoEFeedForward(c2, num_experts=num_experts, top_k=top_k)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        c1 = ch_in[0]
        return c1, [c1], {"num_experts": int(args[0]) if args else 4,
                          "top_k": int(args[1]) if len(args) > 1 else 1}

    def forward(self, x):
        tokens = _nchw_to_seq(x)
        y = tokens + self.moe(tokens)
        if x.dim() == 3:
            return y
        b, c, h, w = x.shape
        return y.transpose(1, 2).reshape(b, c, h, w)


class SequenceToImage(nn.Module):
    """(B, S, D) -> (B, D, H, W). YAML: ``[h, w]`` or ``[[h, w]]``."""

    def __init__(self, seqlens: tuple):
        super().__init__()
        self.seqlens = tuple(seqlens)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        seq = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) else args
        return ch_in[0], [tuple(seq)], {}

    def forward(self, x):
        b, s, d = x.shape
        h, w = self.seqlens
        if s != h * w:
            raise ValueError(f"SequenceToImage: sequence length {s} != {h}*{w}")
        return x.transpose(1, 2).reshape(b, d, h, w)


class PermuteBlock(SequenceToImage):
    """(B, S, D) -> (B, D, H, W) grid view (the JAX block does not check the
    length; the reshape does)."""

    def forward(self, x):
        b, s, d = x.shape
        return x.transpose(1, 2).reshape(b, d, *self.seqlens)


class ImageToSequence(nn.Module):
    """(B, D, H, W) -> (B, H*W, D)."""

    @classmethod
    def parse(cls, args, ch_in, **kw):
        return ch_in[0], [], {}

    def forward(self, x):
        return _nchw_to_seq(x)


class FeatureSplitIndex(nn.Module):
    """Element ``index`` of a list output. YAML: ``[i]``."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    @classmethod
    def parse(cls, args, ch_in, **kw):
        return ch_in[0], [int(args[0])], {}

    def forward(self, xs):
        return xs[self.index]


class VitPatchEmbedBlock(nn.Module):
    """Strided-conv patch embedding of an NCHW image -> (B, dim, H/P, W/P).
    YAML: ``[c1, c2, resolution, patch_size]`` or ``[c2, resolution, patch]``."""

    def __init__(self, c1: int, dim: int, patch_size: int = 16):
        super().__init__()
        self.embed = V.VitPatchEmbed(dim, patch_size, in_channels=c1)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        if len(args) >= 4:
            c2, patch = args[1], args[3]
        else:
            c2, patch = args[0], args[2] if len(args) > 2 else 16
        if isinstance(patch, (list, tuple)):
            patch = patch[0]
        return c2, [ch_in[0], c2], {"patch_size": int(patch)}

    def forward(self, x):
        return self.embed.proj(x)


class VitPosEmbedBlock(nn.Module):
    """Learnable position embedding on an NCHW map, resized bicubically to
    another grid as the JAX module resizes it. YAML: ``[c1, c2, seqlens]``."""

    def __init__(self, dim: int, seqlens: tuple = (14, 14)):
        super().__init__()
        self.embed = V.VitPosEmbed2d(dim, tuple(seqlens))

    @classmethod
    def parse(cls, args, ch_in, **kw):
        seq = next((tuple(a) for a in args if isinstance(a, (list, tuple))), (14, 14))
        return ch_in[0], [ch_in[0]], {"seqlens": seq}

    def forward(self, x):
        return self.embed(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class FlattenPosEmbedBlock(nn.Module):
    """Learnable position embedding ``embed`` (1, seqlen, dim) on (B, S, D)
    tokens. YAML: ``[c1, c2, seqlen]``."""

    def __init__(self, dim: int, seqlen: int):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(1, seqlen, dim))

    def init_params(self, g: torch.Generator) -> None:
        nn.init.trunc_normal_(self.embed, 0.0, 0.02, -0.04, 0.04, generator=g)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        c1 = ch_in[0]
        seqlen = next((a for a in args if isinstance(a, int) and a != c1), args[-1])
        return c1, [c1, int(seqlen)], {}

    def forward(self, x):
        return x + self.embed.to(x.dtype)


class SequenceConv2dBlock(nn.Module):
    """Strided conv in token space (B, S, c1) -> (B, S', c2), padding k // 2
    when strided, else none (the JAX block's rule). YAML: ``[c1, c2, k, s,
    config{seqlens}]``."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2, config: dict | None = None):
        super().__init__()
        self.seqlens = _seqlens(dict(config or {}))
        self.conv = V.SequenceConv2d(c1, k, out_channels=c2, stride=s,
                                     padding=k // 2 if s > 1 else 0, groups=1)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        c2, k, s = args[1], args[2], args[3]
        return c2, [ch_in[0], c2, k, s], {"config": args[4] if len(args) > 4 else {}}

    def forward(self, x):
        return self.conv(x, self.seqlens)


class PatchMergeBlock(nn.Module):
    """Merge each merge_factor x merge_factor window of a (B, S, D) grid:
    flatten it, ``proj`` and LayerNorm ``norm``. YAML: ``[input_seqlens,
    merge_factor, in_dim, out_dim]``."""

    def __init__(self, c1: int, seqlens: tuple, merge_factor: int, out_dim: int):
        super().__init__()
        self.seqlens, self.m = tuple(seqlens), merge_factor
        self.proj = nn.Linear(merge_factor * merge_factor * c1, out_dim)
        self.norm = V.AffineLayerNorm(out_dim)

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, self.proj)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        seqlens, mf, _, out_dim = args
        return int(out_dim), [ch_in[0], tuple(seqlens), int(mf), int(out_dim)], {}

    def forward(self, x):
        b, s, d = x.shape
        (h, w), m = self.seqlens, self.m
        x = x.reshape(b, h // m, m, w // m, m, d).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // m) * (w // m), m * m * d)
        return self.norm(linear_in_dtype(x, self.proj.weight, self.proj.bias))


def _merge2x2(img):
    """NHWC (B, H, W, D) -> (B, H/2, W/2, 4D): the four 2 x 2 phases in the
    JAX blocks' order (0,0), (1,0), (0,1), (1,1)."""
    return torch.cat([img[:, 0::2, 0::2], img[:, 1::2, 0::2], img[:, 0::2, 1::2],
                      img[:, 1::2, 1::2]], dim=-1)


class PatchMerging(nn.Module):
    """SWIN 2 x 2 patch merging: 4C -> RMSNorm ``norm`` -> 2C ``reduction``
    (no bias). A (B, S, C) sequence on a square grid stays a sequence; an
    NCHW map stays a map. YAML: ``[c1]`` (or nothing)."""

    def __init__(self, c1: int):
        super().__init__()
        self.norm = V.RMSNorm(4 * c1)
        self.reduction = nn.Linear(4 * c1, 2 * c1, bias=False)

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, self.reduction)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        return 2 * ch_in[0], [ch_in[0]], {}

    def forward(self, x):
        seq = x.dim() == 3
        if seq:
            b, s, d = x.shape
            h = w = int(round(math.sqrt(s)))
            img = x.reshape(b, h, w, d)
        else:
            img = x.permute(0, 2, 3, 1)
        y = linear_in_dtype(self.norm(_merge2x2(img)), self.reduction.weight)
        return y.reshape(y.shape[0], -1, y.shape[-1]) if seq else y.permute(0, 3, 1, 2)


class VisionClueMerge(nn.Module):
    """Space-to-depth 2 x 2 merge of a (B, S, D) grid, then a 1 x 1
    Conv-BN-SiLU ``pw`` -> (B, S/4, out_dim). YAML: ``[dim, out_dim,
    config{seqlens}]``."""

    def __init__(self, c1: int, out_dim: int, config: dict | None = None):
        super().__init__()
        self.seqlens = _seqlens(dict(config or {}))
        self.pw = ConvBN(4 * c1, out_dim, 1, 1)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        out_dim = args[1]
        return out_dim, [ch_in[0], out_dim], {"config": args[2] if len(args) > 2 else {}}

    def forward(self, x):
        b, s, d = x.shape
        h, w = self.seqlens or (int(s ** 0.5), int(s ** 0.5))
        y = self.pw(_merge2x2(x.reshape(b, h, w, d)).permute(0, 3, 1, 2))
        return y.flatten(2).transpose(1, 2)


class PatchMerger(nn.Module):
    """Learned token-count reduction: LayerNorm ``norm``, then
    ``num_tokens_out`` learned ``queries`` attend over the tokens. YAML:
    ``[dim, num_tokens_out]``."""

    def __init__(self, c1: int, num_tokens_out: int):
        super().__init__()
        self.norm = V.AffineLayerNorm(c1)
        self.queries = nn.Parameter(torch.zeros(num_tokens_out, c1))

    def init_params(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.queries.normal_(0.0, 1.0, generator=g)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        n_out = args[1] if len(args) > 1 else args[0]
        return ch_in[0], [ch_in[0], int(n_out)], {}

    def forward(self, x):
        d = x.shape[-1]
        x = self.norm(x)
        sim = torch.einsum("md,bnd->bmn", self.queries.to(x.dtype), x) * (d ** -0.5)
        attn = torch.softmax(sim.float(), dim=-1).to(x.dtype)
        return torch.einsum("bmn,bnd->bmd", attn, x)


class ViLLayerNormBlock(nn.Module):
    """LayerNorm ``ln`` without bias over the channels: the last dim of a
    sequence, dim 1 of an NCHW map. YAML: ``[dim]``."""

    def __init__(self, c1: int):
        super().__init__()
        self.ln = V.AffineLayerNorm(c1, use_bias=False)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        return ch_in[0], [ch_in[0]], {}

    def forward(self, x):
        return self.ln(x) if x.dim() == 3 else self.ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MultiScaleFusionBlock(nn.Module):
    """Mean-pooled high-resolution tokens concatenated to every
    low-resolution token, then ``proj``. Two inputs [high_res, low_res]
    (sequences or NCHW maps) -> (B, S_low, fused_dim). YAML: ``[high_res_dim,
    low_res_dim, fused_dim]``."""

    def __init__(self, c_high: int, c_low: int, fused_dim: int):
        super().__init__()
        self.proj = nn.Linear(c_high + c_low, fused_dim)

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, self.proj)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        return int(args[2]), [ch_in[0], ch_in[1], int(args[2])], {}

    def forward(self, xs):
        high, low = (_nchw_to_seq(t) for t in xs)
        pooled = high.mean(1, keepdim=True).expand(low.shape[0], low.shape[1], high.shape[-1])
        return linear_in_dtype(torch.cat([pooled, low], dim=-1), self.proj.weight, self.proj.bias)


def _gelu(x):  # flax's nn.gelu: the tanh approximation
    return F.gelu(x, approximate="tanh")


class RGBlock(nn.Module):
    """Gated conv MLP on an NCHW map: ``fc1`` 1 x 1 to two halves (a, v),
    gelu(``dwconv``(a) + a) * v, ``fc2`` 1 x 1."""

    def __init__(self, c1: int, hidden: int, out: int):
        super().__init__()
        hid = int(2 * hidden / 3)
        self.fc1 = nn.Conv2d(c1, 2 * hid, 1)
        self.dwconv = nn.Conv2d(hid, hid, 3, padding=1, groups=hid)
        self.fc2 = nn.Conv2d(hid, out, 1)

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, self.fc1, self.dwconv, self.fc2)

    def forward(self, x):
        a, v = conv_in_dtype(self.fc1, x).chunk(2, dim=1)
        return conv_in_dtype(self.fc2, _gelu(conv_in_dtype(self.dwconv, a) + a) * v)


class FlaxBatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` under its own names (``scale``, ``bias``; the
    running ``mean`` and ``var`` load into ``running_mean`` and
    ``running_var``), computed as the port's ``ConvBN`` computes its
    BatchNorm (fp32, flax's train-mode update)."""

    def __init__(self, c: int, eps: float = BN_EPS, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    @property
    def weight(self):  # what batch_norm_eval / batch_norm_train read
        return self.scale

    def forward(self, x):
        return batch_norm_train(x, self) if self.training else batch_norm_eval(x, self)


class LSBlock(nn.Module):
    """Local spatial block on an NCHW map: depthwise 3 x 3 ``fc1``,
    BatchNorm ``norm``, 1 x 1 ``fc2``, gelu, 1 x 1 ``fc3``, residual."""

    def __init__(self, hidden: int):
        super().__init__()
        self.fc1 = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.norm = FlaxBatchNorm(hidden)
        self.fc2 = nn.Conv2d(hidden, hidden, 1)
        self.fc3 = nn.Conv2d(hidden, hidden, 1)

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, self.fc1, self.fc2, self.fc3)

    def forward(self, x):
        y = self.norm(conv_in_dtype(self.fc1, x))
        return x + conv_in_dtype(self.fc3, _gelu(conv_in_dtype(self.fc2, y)))


class ViLFusionBlock(nn.Module):
    """XSSBlock-style fusion on an NCHW map: ConvBN ``in_proj`` (where c1 !=
    c2), LSBlock ``ls``, ``n`` ViLBlockPairs ``vil{i}`` in token space plus a
    residual, then the RGBlock MLP ``mlp`` plus a residual (config
    ``mlp_ratio``: 4 when unset or 0, as the JAX block reads it; a negative
    one drops the MLP). Config keys as
    ViLBlockPairBlock's; its head dim defaults to 16. YAML: ``[c1, c2,
    config, n]``."""

    def __init__(self, c1: int, c2: int, config: dict | None = None, n: int = 1):
        super().__init__()
        cfg = dict(config or {})
        self.n = n
        self.in_proj = ConvBN(c1, c2, 1, 1) if c1 != c2 else None
        self.ls = LSBlock(c2)
        for i in range(n):
            setattr(self, f"vil{i}", V.ViLBlockPair(
                dim=c2,
                qkv_block_size=int(cfg.get("qkv_block_size", 16)),
                chunk_size=int(cfg.get("chunk_size", 256)),
                igate_act=str(cfg.get("igate_act", "exp")),
                bidirectional=bool(cfg.get("bidirectional", False)),
            ))
        mlp_ratio = float(cfg.get("mlp_ratio") or 4.0)
        self.mlp = RGBlock(c2, int(c2 * mlp_ratio), c2) if mlp_ratio > 0 else None

    @classmethod
    def parse(cls, args, ch_in, **kw):
        c2 = args[1]
        config = args[2] if len(args) > 2 else {}
        n = args[3] if len(args) > 3 else 1
        return c2, [ch_in[0], c2], {"config": config, "n": int(n)}

    def forward(self, x):
        if self.in_proj is not None:
            x = self.in_proj(x)
        x_local = self.ls(x)
        b, d, h, w = x_local.shape
        seq = x_local.flatten(2).transpose(1, 2)
        y = seq
        for i in range(self.n):
            y = getattr(self, f"vil{i}")(y, (h, w))
        x = x + (seq + y).transpose(1, 2).reshape(b, d, h, w)
        return x if self.mlp is None else x + self.mlp(x)


class VisionLSTMBlock(nn.Module):
    """The whole ViL backbone as one YAML row (name ``VisionLSTM``): an NCHW
    image -> the list of its partials at ``output_indices`` and the final
    one, each an NCHW map (B, dim, h, w). YAML: ``[c1, dim, config{depth,
    resolution, patch_size, output_indices, qkv_block_size (16), chunk_size,
    igate_act, bidirectional, backend}]`` or ``[dim, config]``."""

    def __init__(self, c1: int, dim: int, config: dict | None = None):
        super().__init__()
        cfg = dict(config or {})
        t = lambda v: tuple(v) if isinstance(v, (list, tuple)) else v
        self.backbone = V.VisionLSTMBackbone(
            dim=dim,
            depth=int(cfg.get("depth", 12)),
            patch_size=int(cfg.get("patch_size", 16)),
            resolution=t(cfg.get("resolution", (224, 224))),
            output_indices=t(cfg.get("output_indices", ())) or (),
            qkv_block_size=int(cfg.get("qkv_block_size", 16)),
            chunk_size=int(cfg.get("chunk_size", 64)),
            igate_act=str(cfg.get("igate_act", "exp")),
            bidirectional=bool(cfg.get("bidirectional", False)),
            mlstm_backend=str(cfg.get("backend", "auto")),
            in_channels=c1, device=None)

    @classmethod
    def parse(cls, args, ch_in, **kw):
        if len(args) >= 2 and isinstance(args[1], int):
            dim, config = args[1], (args[2] if len(args) > 2 else {})
        else:
            dim, config = args[0], (args[1] if len(args) > 1 else {})
        return dim, [ch_in[0], dim], {"config": config}

    def forward(self, x):
        return [o.permute(0, 3, 1, 2) for o in self.backbone(x.permute(0, 2, 3, 1))]


def _tokens(x, cfg: dict):
    """An NCHW map -> its (B, H*W, C) tokens and (H, W) grid; a (B, S, D)
    sequence passes with the config's ``seqlens``."""
    if x.dim() == 4:
        return x.flatten(2).transpose(1, 2), tuple(x.shape[2:])
    return x, _seqlens(cfg)


def _untokens(y, x):
    """The block's output in its input's layout."""
    return y.transpose(1, 2).reshape(x.shape) if x.dim() == 4 else y


def _parse_dim_config(cls, args, ch_in, **kw):
    """The two JAX adapters' ``parse``: ``[c1, dim, config]`` or ``[dim,
    config]``; dim as written (no width multiple, no max_channels)."""
    dim = args[1] if len(args) >= 2 and isinstance(args[1], int) else args[0]
    config = next((a for a in args if isinstance(a, dict)), {})
    return dim, [dim], {"config": config}


class FusionViLLayerBlock(nn.Module):
    """``vil_extra.FusionViLLayer`` as a YAML row: ``[c1, dim, {mlp_type,
    use_mlp, seq_len, chunk_size (64), qkv_block_size (16), seqlens}]`` or
    ``[dim, config]``. ``dim`` is taken as written and the row's repeats are
    dropped, as in the JAX graph. An NCHW map gives its grid from its shape
    and comes back a map. The ``mixer`` MLP's width is the token count,
    which the JAX block reads from its input at init: here it is the
    config's ``seq_len``, else the product of its ``seqlens`` (a
    ValueError without either)."""

    def __init__(self, dim: int, config: dict | None = None):
        super().__init__()
        self.cfg = dict(config or {})
        mlp_type = str(self.cfg.get("mlp_type", "baseline"))
        seq_len = self.cfg.get("seq_len")
        if seq_len is None and self.cfg.get("seqlens"):
            seq_len = math.prod(self.cfg["seqlens"])
        if seq_len is None and mlp_type == "mixer":
            raise ValueError("FusionViLLayerBlock: the mixer MLP needs seq_len or seqlens "
                             "in its config (the token count)")
        from .vil_extra import FusionViLLayer

        self.fusion = FusionViLLayer(
            dim, mlp_type=mlp_type, use_mlp=bool(self.cfg.get("use_mlp", True)),
            seqlens=_seqlens(self.cfg), chunk_size=int(self.cfg.get("chunk_size", 64)),
            qkv_block_size=int(self.cfg.get("qkv_block_size", 16)),
            seq_len=int(seq_len or 64))

    parse = classmethod(_parse_dim_config)

    def forward(self, x):
        seq, seqlens = _tokens(x, self.cfg)
        return _untokens(self.fusion(seq, seqlens=seqlens), x)


class mLSTMVisionBlockWrap(nn.Module):
    """``vil_extra.mLSTMVisionBlock`` (the xLSTM-7B-style vision block) as a
    YAML row, registered as ``VilLayerUpdated`` and ``mLSTMVisionBlock``:
    ``[c1, dim, {num_heads (4), chunk_size (64), seqlens}]`` or ``[dim,
    config]``; dim as written, repeats dropped, as in the JAX graph. Its
    layer chunks the sequence by ``min(chunk_size, S)``, which must divide
    S (at the default 64 a 20 x 20 grid raises, as in JAX)."""

    def __init__(self, dim: int, config: dict | None = None):
        super().__init__()
        self.cfg = dict(config or {})
        from .vil_extra import mLSTMVisionBlock

        self.block = mLSTMVisionBlock(dim, num_heads=int(self.cfg.get("num_heads", 4)),
                                      chunk_size=int(self.cfg.get("chunk_size", 64)),
                                      seqlens=_seqlens(self.cfg))

    parse = classmethod(_parse_dim_config)

    def forward(self, x):
        seq, seqlens = _tokens(x, self.cfg)
        return _untokens(self.block(seq, seqlens), x)


# the graph compiler's names (graph.REGISTRY)
BLOCKS = {
    "ViLBlockPairBlock": ViLBlockPairBlock,
    "MoEFFN": MoEFFNBlock,
    "SequenceToImage": SequenceToImage,
    "ImageToSequence": ImageToSequence,
    "PermuteBlock": PermuteBlock,
    "FeatureSplitIndex": FeatureSplitIndex,
    "VitPatchEmbedBlock": VitPatchEmbedBlock,
    "VitPosEmbedBlock": VitPosEmbedBlock,
    "FlattenPosEmbedBlock": FlattenPosEmbedBlock,
    "SequenceConv2dBlock": SequenceConv2dBlock,
    "PatchMergeBlock": PatchMergeBlock,
    "PatchMerging": PatchMerging,
    "VisionClueMerge": VisionClueMerge,
    "PatchMerger": PatchMerger,
    "ViLLayerNormBlock": ViLLayerNormBlock,
    "MultiScaleFusionBlock": MultiScaleFusionBlock,
    "ViLFusionBlock": ViLFusionBlock,
    "VisionLSTM": VisionLSTMBlock,
    "FusionViLLayerBlock": FusionViLLayerBlock,
    "VilLayerUpdated": mLSTMVisionBlockWrap,
    "mLSTMVisionBlock": mLSTMVisionBlockWrap,
}
