"""YAML model graph -> torch module.

Port of ``parse_model``, ``Repeat`` and ``GraphModel`` in
``xlstm_yolo_tpu/nn/graph.py`` for the detect, segment, pose, obb,
classify and rtdetr tasks: every layer name of the YAMLs the port ships
(YOLOv3, v5, v6, v8 and its ghost / P2 / P6 variants, v9, v10, YOLO11,
YOLO12, ViL-YOLO, the ``-seg``, ``-pose`` and ``-obb`` files of v8, v9, 11
and 12, the six ``-cls`` files with their ``ResNetLayer`` and
``TorchVision`` backbones, and the five RT-DETR files with ``HGStem``,
``HGBlock`` (arguments raw, the row's repeat count its chain length),
``AIFI``, ``RepC3`` and ``LightConv``), YOLO-World's (``C2fAttn`` ``[c2,
ec, nh]``, c2 and ec width-scaled, the row's repeat count its inner
Bottlenecks; ``ImagePoolingAttn`` ``[ec]``, ec width-scaled, its output the
512-wide guide) and the ViL blocks of
``nn/vil_blocks.py`` (registered under their JAX names). The head row sets
the task: ``Segment`` (its third argument, the prototype channels,
width-scaled), ``Pose`` (``kpt_shape`` from the YAML's top level, as a
tuple), ``OBB``, ``Classify`` (its one argument, the class count, or the
YAML's ``nc``), ``RTDETRDecoder`` and ``WorldDetect`` (``[nc, embed_dim,
with_bn]``, task ``world``; its class count is the guide's). ``GraphModel.forward`` hands the
head row its keyword arguments (``head_kwargs``: RT-DETR's denoising
queries) and threads the text guide (``guide``, YOLO-World's text
embeddings) through the rows that take it. The names of the other JAX heads and
families (``NOT_PORTED``) raise a ``KeyError`` that says what they wait
on. As in JAX, a graph with a ``C3k2`` or ``A2C2f`` row (YOLO11, 12)
builds its head with ``legacy=False``. The YAML
format is the Ultralytics one: ``backbone``/``head`` rows of ``[from,
repeats, module, args]`` plus ``nc`` and ``scales``; channels are resolved
statically with the same width scaling and depth rounding. Layer ``i`` is
the submodule ``l{i}``, as in the JAX parameter tree; a repeated row that
is not a CSP block is a ``Repeat`` of copies ``l{i}.r{j}``. Channel Concat
runs on dim 1 (NCHW). A layer's output may be an NCHW map, a (B, S, D)
sequence or a list (a ViL backbone's partials, a ``CBLinear``'s maps,
whose channel entry is then a tuple); a "custom" block's own ``parse``
resolves its channels from those of every input it reads, in ``from``
order (``CBFuse``'s target is the last).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import torch.nn as nn

from . import heads as H
from . import modules as M
from . import rtdetr as R
from . import world as W
from .vil_blocks import BLOCKS

# name -> (module class, kind); kind decides channel/argument resolution:
#   "conv"   args[0] is c2 (width-scaled)
#   "csp"    like conv, with the depth-scaled repeat count inserted
#   "elan"   RepNCSPELAN4 [c2, c3, c4, n]: only c2 is width-scaled
#   "plain"  c2 = c1, the row's arguments per layer name
#   "concat" c2 = sum of the input channels
#   "index"  c2 = args[0], the channels of the selected list element
#   "head"   detection head over a list of taps
#   "world"  C2fAttn [c2, ec, nh]: c2 and ec width-scaled, the repeats internal
#   "world_pool" ImagePoolingAttn [ec]: ec width-scaled, c2 the 512-wide guide
#   "custom" the class's own ``parse``
REGISTRY: dict[str, tuple[Any, str]] = {
    "Conv": (M.ConvBN, "conv"),
    "DWConv": (M.DWConv, "conv"),
    "GhostConv": (M.GhostConv, "conv"),
    "ConvTranspose": (M.ConvTransposeBN, "conv"),
    "Bottleneck": (M.Bottleneck, "conv"),
    "GhostBottleneck": (M.GhostBottleneck, "conv"),
    "SPP": (M.SPP, "conv"),
    "SPPF": (M.SPPF, "conv"),
    "SCDown": (M.SCDown, "conv"),
    "ADown": (M.ADown, "conv"),
    "AConv": (M.AConv, "conv"),
    "RepConv": (M.RepConv, "conv"),
    "RepVGGDW": (M.RepVGGDW, "conv"),
    "LightConv": (M.LightConv, "conv"),
    "PSA": (M.PSA, "conv"),
    "C2": (M.C2, "csp"),
    "C2f": (M.C2f, "csp"),
    "C3": (M.C3, "csp"),
    "C3Ghost": (M.C3Ghost, "csp"),
    "C3k2": (M.C3k2, "csp"),
    "C2PSA": (M.C2PSA, "csp"),
    "C2fCIB": (M.C2fCIB, "csp"),
    "A2C2f": (M.A2C2f, "csp"),
    "RepC3": (M.RepC3, "csp"),
    "RepNCSPELAN4": (M.RepNCSPELAN4, "elan"),
    "SPPELAN": (M.SPPELAN, "custom"),
    "ELAN1": (M.ELAN1, "custom"),
    "CBLinear": (M.CBLinear, "custom"),
    "CBFuse": (M.CBFuse, "custom"),
    "Concat": (M.Concat, "concat"),
    "Index": (M.Index, "index"),
    "nn.Upsample": (M.Upsample, "plain"),
    "nn.MaxPool2d": (M.MaxPool, "plain"),
    "MaxPool": (M.MaxPool, "plain"),
    "nn.ZeroPad2d": (nn.ZeroPad2d, "plain"),
    "nn.Identity": (nn.Identity, "plain"),
    "Silence": (nn.Identity, "plain"),
    "Detect": (H.Detect, "head"),
    "v10Detect": (H.v10Detect, "head"),
    "Segment": (H.Segment, "head"),
    "Pose": (H.Pose, "head"),
    "OBB": (H.OBB, "head"),
    "Classify": (M.Classify, "head"),
    "RTDETRDecoder": (R.RTDETRDecoder, "head"),
    "WorldDetect": (W.WorldDetect, "head"),
    "C2fAttn": (W.C2fAttn, "world"),
    "ImagePoolingAttn": (W.ImagePoolingAttn, "world_pool"),
    "HGStem": (R.HGStem, "custom"),
    "HGBlock": (R.HGBlock, "custom"),
    "AIFI": (R.AIFI, "custom"),
    "ResNetLayer": (M.ResNetLayer, "custom"),
    "TorchVision": (M.TorchVision, "custom"),
    **{name: (cls, "custom") for name, cls in BLOCKS.items()},
}


# names of the JAX graph the port refuses, with what they wait on
NOT_PORTED = {
    **{name: "no detection YAML uses it; it is not ported yet"
       for name in ("Focus", "Conv2", "C1", "C2fPSA", "C3x", "BottleneckCSP", "CBAM",
                    "ChannelAttention", "SpatialAttention")},
}


# the task each head row sets
TASKS = {"Detect": "detect", "v10Detect": "detect", "Segment": "segment", "Pose": "pose",
         "OBB": "obb", "Classify": "classify", "RTDETRDecoder": "rtdetr",
         "WorldDetect": "world"}

GUIDE_DIM = 512  # the guide's width where no WorldDetect row names one, and ImagePoolingAttn's


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round channels up to a multiple of ``divisor``."""
    return int(math.ceil(x / divisor) * divisor)


@dataclass(frozen=True)
class LayerSpec:
    i: int
    f: tuple  # input layer indices
    name: str
    c1: int
    c2: int
    args: tuple = ()
    kwargs: tuple = ()  # (k, v) pairs
    n: int = 1  # copies of a repeated row that is not a CSP block

    def build(self) -> nn.Module:
        return Repeat(self) if self.n > 1 else self.build_one(self.c1)

    def build_one(self, c1) -> nn.Module:
        cls, kind = REGISTRY[self.name]
        kw = dict(self.kwargs)
        if kind in ("conv", "csp", "elan", "world"):
            return cls(c1, *self.args, **kw)
        return cls(*self.args, **kw)


class Repeat(nn.Module):
    """``n`` copies of a row's module chained, ``r0`` ... (YAML repeats of a
    row that is not a CSP block, e.g. YOLOv3's bottlenecks and YOLOv6's
    convs): the first maps c1 to c2, the others c2 to c2."""

    def __init__(self, spec: LayerSpec):
        super().__init__()
        self.n = spec.n
        for j in range(spec.n):
            setattr(self, f"r{j}", spec.build_one(spec.c1 if j == 0 else spec.c2))

    def forward(self, x):
        for j in range(self.n):
            x = getattr(self, f"r{j}")(x)
        return x


@dataclass
class ParsedModel:
    specs: tuple
    save: tuple  # layers whose outputs later layers read
    nc: int
    task: str
    head_index: int
    yaml: dict = field(default_factory=dict)


def parse_model(cfg: dict, ch: int = 3, scale: str | None = None) -> ParsedModel:
    """Parse an Ultralytics-style model YAML dict into LayerSpecs."""
    nc = int(cfg.get("nc", 80))
    scales = cfg.get("scales") or {}
    depth, width, max_ch = cfg.get("depth_multiple", 1.0), cfg.get("width_multiple", 1.0), float("inf")
    if scales:
        scale = scale or cfg.get("scale") or next(iter(scales))
        if scale not in scales:
            scale = next(iter(scales))
        depth, width, max_ch = scales[scale]

    specs: list[LayerSpec] = []
    save: set[int] = set()
    channels = [ch]
    head_index = -1
    task = "detect"
    rows = list(cfg["backbone"]) + list(cfg.get("head", []))
    # the YOLO11 / 12 graphs switch the Detect class branch to its depthwise form
    legacy_head = not any(r[2] in ("C3k2", "A2C2f") for r in rows)
    # the guide's width: the WorldDetect row's embed_dim (the default text
    # embeddings' width) until an ImagePoolingAttn row replaces it
    guide_dim = next((int(r[3][1]) if len(r[3]) > 1 else GUIDE_DIM
                      for r in rows if r[2] == "WorldDetect"), GUIDE_DIM)
    for i, (f, n, name, args) in enumerate(rows):
        fs = tuple(f) if isinstance(f, (list, tuple)) else (f,)
        fs = tuple(x if x >= 0 else i + x for x in fs)
        n_rep = max(round(n * depth), 1) if n > 1 else n
        args = [cfg.get(a, a) if isinstance(a, str) and a in ("nc", "kpt_shape") else a
                for a in args]
        if name not in REGISTRY:
            why = f": {NOT_PORTED[name]}" if name in NOT_PORTED else ""
            raise KeyError(f"module {name!r} (layer {i}) is not ported{why}")
        cls, kind = REGISTRY[name]
        c1 = channels[fs[0] + 1]
        kwargs: dict[str, Any] = {}
        if kind in ("conv", "csp"):
            c2 = args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_ch) * width, 8)
            margs = [c2, *args[1:]] if kind == "conv" else [c2, n_rep, *args[1:]]
        elif kind == "elan":
            c2 = make_divisible(min(args[0], max_ch) * width, 8)
            margs = [c2, args[1], args[2], args[3] if len(args) > 3 else 1]
        elif kind == "world":
            c2 = make_divisible(min(args[0], max_ch) * width, 8)
            ec = make_divisible(min(args[1], max_ch) * width, 8) if len(args) > 1 else 128
            margs = [c2]
            kwargs = {"ec": ec, "nh": int(args[2]) if len(args) > 2 else 1, "n": n_rep,
                      "gc": guide_dim}
        elif kind == "world_pool":
            c2 = GUIDE_DIM
            margs = [tuple(channels[x + 1] for x in fs)]
            kwargs = {"ec": make_divisible(min(args[0] if args else 256, max_ch) * width, 8),
                      "gc": guide_dim}
            guide_dim = c2
        elif kind == "concat":
            c2 = sum(channels[x + 1] for x in fs)
            margs = [args[0] if args else 1]  # YAML dims are NCHW already
        elif kind == "index":
            c2 = args[0] if args else 0
            margs = list(args[1:])
        elif kind == "plain":
            c2 = c1
            margs = []
            if cls is M.Upsample:  # [None, scale, mode]
                if len(args) >= 2 and args[1]:
                    kwargs["scale"] = int(args[1])
                if len(args) >= 3 and args[2]:
                    kwargs["mode"] = str(args[2])
            elif cls is M.MaxPool:  # [k, s, p]: explicit padding is a ZeroPad2d row
                margs = list(args[:2])
            elif cls is nn.ZeroPad2d:  # [[left, right, top, bottom]]
                margs = [tuple(args[0])]
        elif kind == "head":
            head_index = i
            c2 = 0
            task = TASKS[name]
            margs = list(args) if args and name in ("Segment", "Pose", "OBB") else [
                args[0] if args else nc]
            if name == "WorldDetect":  # [nc, embed_dim, with_bn]: nc is the guide's
                margs = [int(args[1]) if len(args) > 1 else GUIDE_DIM]
                kwargs["with_bn"] = bool(args[2]) if len(args) > 2 else False
            if name == "Segment" and len(margs) > 2:  # the prototype channels width-scale
                margs[2] = make_divisible(min(margs[2], max_ch) * width, 8)
            if name == "Pose" and len(margs) > 1 and isinstance(margs[1], (list, tuple)):
                margs[1] = tuple(margs[1])
            if name == "Classify":  # one map in, its channels first
                margs = [c1, *margs]
            else:
                kwargs["ch"] = tuple(channels[x + 1] for x in fs)
                if name not in ("v10Detect", "RTDETRDecoder", "WorldDetect") and not legacy_head:
                    kwargs["legacy"] = False
        else:
            ch_in = tuple(channels[x + 1] for x in fs)
            c2, margs, kwargs = cls.parse(args, ch_in, width=width, max_ch=max_ch, n=n_rep)
        if kind in ("csp", "elan", "custom", "world", "world_pool"):
            n_rep = 1  # the block takes its own repeat count
        specs.append(LayerSpec(i=i, f=fs, name=name, c1=c1, c2=c2,
                               args=tuple(margs),
                               kwargs=tuple(sorted(kwargs.items())), n=n_rep))
        channels.append(c2)
        save.update(x for x in fs if x != i - 1 and x >= 0)
    return ParsedModel(specs=tuple(specs), save=tuple(sorted(save)), nc=nc, task=task,
                       head_index=head_index, yaml=cfg)


class GraphModel(nn.Module):
    """Replays a parsed graph, caching the outputs later layers read.
    Returns the head's output; ``head_kwargs`` go to the head row. A row
    whose module sets ``needs_guide`` takes the running ``guide`` (B | 1,
    nt, C) after its input (without one, zeros (B, 1, 512), as the JAX
    graph's init-time fallback); one that sets ``updates_guide`` replaces it
    for every later row. ``upto`` stops the replay after layer ``upto`` and
    returns that layer's output (the truncated replay per-layer profiling
    times, as the JAX graph's ``upto``)."""

    def __init__(self, parsed: ParsedModel):
        super().__init__()
        self.parsed = parsed
        for spec in parsed.specs:
            setattr(self, f"l{spec.i}", spec.build())

    def forward(self, x, head_kwargs: dict | None = None, guide=None, upto: int | None = None):
        cache = {}
        prev = x
        save = set(self.parsed.save)
        for spec in self.parsed.specs:
            if len(spec.f) == 1:
                inp = prev if spec.f[0] == spec.i - 1 else cache[spec.f[0]]
            else:
                inp = [prev if j == spec.i - 1 else cache[j] for j in spec.f]
            extra = head_kwargs if head_kwargs and spec.i == self.parsed.head_index else {}
            mod = getattr(self, f"l{spec.i}")
            if getattr(mod, "needs_guide", False):
                if guide is None:
                    guide = x.new_zeros((x.shape[0], 1, GUIDE_DIM))
                prev = mod(inp, guide, **extra)
                if getattr(mod, "updates_guide", False):
                    guide = prev
            else:
                prev = mod(inp, **extra)
            if spec.i in save:
                cache[spec.i] = prev
            if upto is not None and spec.i >= upto:
                break
        return prev
