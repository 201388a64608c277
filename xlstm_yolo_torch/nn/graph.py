"""YAML model graph -> torch module.

Port of ``parse_model`` and ``GraphModel`` in ``xlstm_yolo_tpu/nn/graph.py``,
restricted to the layer names the ViL-YOLO and YOLOv8 graphs use. The YAML
format is the Ultralytics one: ``backbone``/``head`` rows of
``[from, repeats, module, args]`` plus ``nc`` and ``scales``; channels are
resolved statically with the same width scaling and depth rounding. Layer
``i`` is the submodule ``l{i}``, as in the JAX parameter tree. Channel
Concat runs on dim 1 (NCHW).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import torch.nn as nn

from . import heads as H
from . import modules as M
from .vil_blocks import ViLBlockPairBlock

# name -> (module class, kind); kind decides channel/argument resolution:
#   "conv"   args[0] is c2 (width-scaled)
#   "csp"    like conv, with the depth-scaled repeat count inserted
#   "plain"  c2 = c1
#   "concat" c2 = sum of the input channels
#   "head"   detection head over a list of taps
#   "custom" the class's own ``parse``
REGISTRY: dict[str, tuple[Any, str]] = {
    "Conv": (M.ConvBN, "conv"),
    "C2f": (M.C2f, "csp"),
    "SPPF": (M.SPPF, "conv"),
    "Concat": (M.Concat, "concat"),
    "nn.Upsample": (M.Upsample, "plain"),
    "Detect": (H.Detect, "head"),
    "ViLBlockPairBlock": (ViLBlockPairBlock, "custom"),
}


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

    def build(self) -> nn.Module:
        cls, kind = REGISTRY[self.name]
        kw = dict(self.kwargs)
        if kind in ("conv", "csp"):
            return cls(self.c1, *self.args, **kw)
        return cls(*self.args, **kw)


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
    rows = list(cfg["backbone"]) + list(cfg.get("head", []))
    for i, (f, n, name, args) in enumerate(rows):
        fs = tuple(f) if isinstance(f, (list, tuple)) else (f,)
        fs = tuple(x if x >= 0 else i + x for x in fs)
        n_rep = max(round(n * depth), 1) if n > 1 else n
        args = [cfg.get(a, a) if isinstance(a, str) and a == "nc" else a for a in args]
        if name not in REGISTRY:
            raise KeyError(f"module {name!r} (layer {i}) is not ported")
        cls, kind = REGISTRY[name]
        c1 = channels[fs[0] + 1]
        kwargs: dict[str, Any] = {}
        if kind in ("conv", "csp"):
            c2 = args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_ch) * width, 8)
            margs = [c2, *args[1:]] if kind == "conv" else [c2, n_rep, *args[1:]]
        elif kind == "concat":
            c2 = sum(channels[x + 1] for x in fs)
            margs = [args[0] if args else 1]  # YAML dims are NCHW already
        elif kind == "plain":
            c2 = c1
            margs = []
            if len(args) >= 2 and args[1]:
                kwargs["scale"] = int(args[1])
            if len(args) >= 3 and args[2]:
                kwargs["mode"] = str(args[2])
        elif kind == "head":
            head_index = i
            c2 = 0
            margs = [args[0] if args else nc]
            kwargs["ch"] = tuple(channels[x + 1] for x in fs)
        else:
            c2, margs, kwargs = cls.parse(args, c1, width=width, max_ch=max_ch, n=n_rep)
        if kind not in ("csp", "custom") and n_rep > 1:
            raise ValueError(f"layer {i}: repeats of {name!r} are not ported")
        specs.append(LayerSpec(i=i, f=fs, name=name, c1=c1, c2=c2, args=tuple(margs),
                               kwargs=tuple(sorted(kwargs.items()))))
        channels.append(c2)
        save.update(x for x in fs if x != i - 1 and x >= 0)
    return ParsedModel(specs=tuple(specs), save=tuple(sorted(save)), nc=nc, task="detect",
                       head_index=head_index, yaml=cfg)


class GraphModel(nn.Module):
    """Replays a parsed graph, caching the outputs later layers read.
    Returns the head's output."""

    def __init__(self, parsed: ParsedModel):
        super().__init__()
        self.parsed = parsed
        for spec in parsed.specs:
            setattr(self, f"l{spec.i}", spec.build())

    def forward(self, x):
        cache = {}
        prev = x
        save = set(self.parsed.save)
        for spec in self.parsed.specs:
            if len(spec.f) == 1:
                inp = prev if spec.f[0] == spec.i - 1 else cache[spec.f[0]]
            else:
                inp = [prev if j == spec.i - 1 else cache[j] for j in spec.f]
            prev = getattr(self, f"l{spec.i}")(inp)
            if spec.i in save:
                cache[spec.i] = prev
        return prev
