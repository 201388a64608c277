"""Ultralytics-layout torch checkpoints and SAM / SAM2 encoder tensors, in
and out of the port's models.

Port of ``xlstm_yolo_tpu/utils/torch_import.py``. The JAX package maps an
Ultralytics state dict (``model.{i}.<sub>.weight``, OIHW convs, ``(out,
in)`` linears, ``running_mean`` / ``running_var``) onto its flax variable
tree by name rules; the port's modules carry that tree's names
(``utils.jax_weights``), so the same rules run here on the port model's
state seen as the flat JAX tree (``jax_weights.jax_named``), and the result
lands in the model through ``jax_weights.load_jax_variables``. The rules
are the JAX module's, copied: ``_flax_path`` (``model.{i}`` -> ``l{i}``,
numeric children merged, ``m.2`` -> ``m2``, ``cv2.0.1`` -> ``cv2_0_1``,
``proto.*``), ``_rename_transformer_mods`` (AIFI and the RT-DETR decoder),
the packed ``in_proj`` split into query / key / value, the Segment / Pose
/ OBB heads' ``detect`` nesting, HGBlock's ``LightConv`` list and the
``LayerNorm.weight`` -> ``scale`` fallbacks. A name that matches nothing,
or a shape that does not, is reported in ``missed`` (and printed with
``verbose``), never dropped silently; ``to_torch_state_dict`` raises on a
key with no Ultralytics name (every ViL weight: neither package has
reference names for them).

Files are read with ``torch.load(weights_only=True)``: tensors and plain
containers only.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from .jax_weights import jax_named, load_jax_variables


def torch_state_dict(pt_path: str | Path) -> dict:
    """Load a .pt checkpoint to {name: numpy array} without unpickling code."""
    obj = torch.load(str(pt_path), map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj and hasattr(obj["model"], "state_dict"):
        sd = obj["model"].state_dict()
    elif isinstance(obj, dict) and all(hasattr(v, "numpy") for v in obj.values()):
        sd = obj
    elif isinstance(obj, dict) and "state_dict" in obj:
        sd = obj["state_dict"]
    else:
        raise ValueError(f"unrecognized checkpoint structure in {pt_path}")
    return {k: v.detach().float().numpy() for k, v in sd.items()}


def _rename_transformer_mods(mods: list[str]) -> list[str]:
    """Torch transformer / RT-DETR module paths -> the tree's names (AIFI's
    ``ma`` -> ``mha``, ``decoder.layers.{i}`` -> ``layer{i}``,
    ``dec_{bbox,score}_head.{i}`` -> ``{bbox,score}_head{i}``, MLP
    ``layers.{j}`` -> ``l{j}``, ``enc_output.{0,1}``, ``input_proj.{i}.{0,1}``,
    ``out_proj`` -> ``out``, ``linear{1,2}`` -> ``fc{1,2}``)."""
    out = list(mods)
    if len(out) >= 3 and out[0] == "decoder" and out[1] == "layers":
        out = [f"layer{out[2]}"] + out[3:]
    if len(out) >= 2 and out[0] in ("dec_bbox_head", "dec_score_head"):
        out = [out[0][4:] + out[1]] + out[2:]
    i = 0
    while i < len(out) - 1:  # MLP heads: layers.{j} -> l{j}
        if out[i] == "layers" and out[i + 1].isdigit():
            out[i: i + 2] = [f"l{out[i + 1]}"]
        else:
            i += 1
    if out[:2] == ["enc_output", "0"]:
        out = ["enc_output"] + out[2:]
    elif out[:2] == ["enc_output", "1"]:
        out = ["enc_output_norm"] + out[2:]
    if len(out) >= 3 and out[0] == "input_proj" and out[1].isdigit():
        out = [f"input_proj{out[1]}", "conv" if out[2] == "0" else "bn"] + out[3:]
    rename = {"ma": "mha", "out_proj": "out", "linear1": "fc1", "linear2": "fc2"}
    return [rename.get(p, p) for p in out]


def _flax_path(torch_name: str) -> tuple | None:
    """A torch parameter name -> (collection, path tuple, kind), None for
    ``num_batches_tracked``."""
    parts = torch_name.split(".")
    if parts[0] == "model":
        parts = parts[1:]
        layer = f"l{parts[0]}"
        parts = parts[1:]
    else:
        layer = None
    leaf = parts[-1]
    mods = _rename_transformer_mods(parts[:-1])

    if "proto" in parts:
        i = parts.index("proto")
        child = parts[i + 1]
        parts[i: i + 2] = ["proto_up" if child == "upsample" else f"proto_{child}"]
        mods = parts[:-1]
    merged: list[str] = []
    for p in mods:
        if p.isdigit() and merged:
            base = merged[-1]
            if base == "m" or (base[0] == "m" and base[1:].isdigit()):
                merged[-1] = base + p if base == "m" else base  # m -> m2 (only first digit)
                if base != "m":
                    merged.append(p)  # unexpected deeper nesting
            else:
                merged[-1] = f"{base}_{p}"
        else:
            merged.append(p)

    if leaf in ("in_proj_weight", "in_proj_bias"):
        coll = "params"
        name = "kernel" if leaf == "in_proj_weight" else "bias"
        kind = "mha_in_proj"
    elif leaf == "weight" and merged and merged[-1] == "denoising_class_embed":
        coll, name, kind = "params", "embedding", "raw"
    elif leaf in ("weight", "bias") and merged and merged[-1] == "bn":
        coll = "params"
        name = "scale" if leaf == "weight" else "bias"
        kind = "bn_affine"
    elif leaf in ("running_mean", "running_var"):
        coll = "batch_stats"
        name = "mean" if leaf == "running_mean" else "var"
        kind = "bn_stats"
    elif leaf == "num_batches_tracked":
        return None
    elif leaf == "weight" and merged and merged[-1] == "proto_up":
        coll, name, kind = "params", "kernel", "deconv"
    elif leaf == "weight" and merged and merged[-1] == "conv":
        coll, name, kind = "params", "kernel", "conv"
    elif leaf == "weight":
        coll, name, kind = "params", "kernel", "linear"
    elif leaf == "bias":
        coll, name, kind = "params", "bias", "bias"
    else:
        coll, name, kind = "params", leaf, "raw"

    path = ([layer] if layer else []) + merged + [name]
    return coll, tuple(path), kind


def _flat(model: nn.Module) -> dict:
    """The model's state as the flat JAX tree, keyed by tuples, in a JAX
    tree's order (keys sorted at every level)."""
    return dict(sorted((tuple(k.split("/")), v) for k, v in jax_named(model).items()))


def load_torch_weights(model: nn.Module, pt_path: str | Path, verbose: bool = True):
    """Fill ``model`` (in place) from an Ultralytics-layout checkpoint;
    returns (model, matched, missed torch keys)."""
    return load_torch_state_dict(model, torch_state_dict(pt_path), verbose=verbose)


def load_torch_state_dict(model: nn.Module, sd: dict, verbose: bool = True):
    """Fill ``model`` (in place) from an Ultralytics-layout state dict
    ({name: array}); the tensors no name matches stay as they were.
    Returns (model, matched, missed torch keys)."""
    flat = _flat(model)
    out = dict(flat)
    matched, missed = 0, []
    for tname, arr in sd.items():
        arr = np.asarray(arr, np.float32)
        mapped = _flax_path(tname)
        if mapped is None:
            continue
        coll, path, kind = mapped
        if kind == "mha_in_proj":
            # packed (3D, ...) qkv: rows [q; k; v] -> three sub-modules
            assigns = [((coll,) + path[:-1] + (qkv, path[-1]), sub)
                       for qkv, sub in zip(("query", "key", "value"), np.split(arr, 3, axis=0))]
        else:
            assigns = [((coll,) + path, arr)]
        for key, arr in assigns:
            if key not in flat and len(key) > 2:
                # the Segment / Pose / OBB heads nest the Detect branches under "detect"
                alt = (key[0], key[1], "detect") + key[2:]
                if alt in flat:
                    key = alt
            if key not in flat and any(p in ("conv1", "conv2") for p in key):
                # HGBlock's LightConv list: torch "m.{i}.conv{j}" vs the tree's "m{i}_cv{j}"
                alt, i = list(key), 1
                while i < len(alt):
                    if alt[i] in ("conv1", "conv2") and re.fullmatch(r"m\d+", alt[i - 1]):
                        alt[i - 1: i + 1] = [alt[i - 1] + "_cv" + alt[i][-1]]
                    else:
                        i += 1
                if tuple(alt) in flat:
                    key = tuple(alt)
            if key not in flat and key[-1] == "kernel" and arr.ndim == 1:
                alt = key[:-1] + ("scale",)  # torch LayerNorm.weight -> "scale"
                if alt in flat:
                    key = alt
            if key not in flat:
                missed.append(tname)
                continue
            want_shape = tuple(flat[key].shape)
            if kind == "deconv" and arr.ndim == 4:
                arr = np.transpose(arr, (2, 3, 0, 1))  # IOHW -> HWIO
            elif kind in ("conv", "linear") and arr.ndim == 4:
                arr = np.transpose(arr, (2, 3, 1, 0))  # OIHW -> HWIO
            elif kind in ("linear", "mha_in_proj") and arr.ndim == 2:
                arr = arr.T
            if (arr.shape != want_shape and arr.size == int(np.prod(want_shape))
                    and kind in ("linear", "mha_in_proj", "bias") and arr.ndim <= 2):
                arr = arr.reshape(want_shape)  # attention (D, D) -> (D, H, Hd) and the like
            if arr.shape != want_shape:
                missed.append(tname)
                continue
            out[key] = np.ascontiguousarray(arr, dtype=flat[key].dtype)
            matched += 1

    load_jax_variables(model, {"/".join(k): v for k, v in out.items()})
    if verbose:
        print(f"torch import: {matched} tensors matched, {len(missed)} unmatched")
        for m in missed[:10]:
            print("  unmatched:", m)
    return model, matched, missed


def load_torch_model(path: str | Path, device: str | torch.device = "cuda", verbose: bool = False):
    """(model, meta): the model an Ultralytics-layout ``.pt`` describes
    (``Exporter(format="torch")`` of either package: a ``state_dict`` and
    the ``yaml`` it was built from, a YAML name or the port's graph dict),
    its class count and names, the state dict loaded, on ``device``; meta
    holds the file's ``yaml``, ``task``, ``nc`` and ``names``. A bare state
    dict names no architecture: it raises (``Model(yaml).load(path)``
    takes it)."""
    from ..nn.tasks import TaskModel
    from . import resolve_device

    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if not (isinstance(obj, dict) and "state_dict" in obj and obj.get("yaml")):
        raise ValueError(f"{str(path)!r} has no architecture metadata — build the architecture "
                         f"first: Model('cfg.yaml').load(pt_path)")
    model = TaskModel(obj["yaml"], nc=obj.get("nc"), scale=obj.get("scale"), device="cpu")
    if obj.get("names"):
        model.names = {int(k): v for k, v in dict(obj["names"]).items()}
    sd = {k: t.detach().float().numpy() for k, t in obj["state_dict"].items()}
    load_torch_state_dict(model, sd, verbose=verbose)
    meta = {k: obj[k] for k in ("yaml", "task", "nc", "names") if k in obj}
    return model.to(resolve_device(device)), meta


def export_torch_names(model: nn.Module) -> dict:
    """The model's tree keys (tuples) -> Ultralytics-style torch names."""
    return _torch_names(_flat(model))


def _torch_names(keys) -> dict:
    out = {}
    for key in keys:
        coll, *path = key
        leaf, mods = path[-1], path[:-1]
        tparts = []
        for p in mods:
            if p.startswith("l") and p[1:].isdigit():
                tparts.extend(["model", p[1:]])
            elif "_" in p:
                head, *idxs = p.split("_")
                tparts.append(head)
                tparts.extend(idxs)
            elif p[-1].isdigit() and not p[-2:].isdigit() and p[0] == "m":
                tparts.extend([p[0], p[1:]])
            else:
                tparts.append(p)
        if leaf in ("kernel", "scale"):
            tleaf = "weight"
        elif leaf in ("mean", "var"):
            tleaf = f"running_{leaf}"
        else:
            tleaf = leaf
        out[key] = ".".join(tparts + [tleaf])
    return out


def to_torch_state_dict(model: nn.Module) -> dict:
    """Inverse of ``load_torch_state_dict``: ``model`` -> an Ultralytics-style
    state dict (numpy arrays, torch layouts). Every emitted name is checked
    by running ``_flax_path`` back over it; a key with no reference name
    raises."""
    flat = _flat(model)
    out = {}
    for key, tname in _torch_names(flat).items():
        tname = tname.replace(".detect.", ".")  # the seg/pose/obb heads' nesting

        def _resolves(mapped):
            if mapped is None:
                return False
            got = (mapped[0],) + mapped[1]
            return got == key or (got[:2] + ("detect",) + got[2:]) == key

        mapped = _flax_path(tname)
        if not _resolves(mapped):
            alt = re.sub(r"\bm\.(\d+)\.cv(\d)\b", r"m.\1.conv\2", tname)  # HGBlock LightConv
            mapped = _flax_path(alt)
            if not _resolves(mapped):
                raise ValueError(f"no reference torch name for {key} (candidate {tname!r})")
            tname = alt
        kind = mapped[2]
        arr = np.asarray(flat[key], np.float32)
        if kind == "deconv" and arr.ndim == 4:
            arr = np.transpose(arr, (2, 3, 0, 1))  # HWIO -> IOHW
        elif kind in ("conv", "linear") and arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        elif kind == "linear" and arr.ndim >= 2:
            if arr.ndim == 3:  # attention kernels
                if key[-2] == "out":  # (H, Hd, D)
                    arr = arr.reshape(-1, arr.shape[-1])
                else:  # q/k/v (D, H, Hd)
                    arr = arr.reshape(arr.shape[0], -1)
            arr = arr.T
        elif kind == "bias" and arr.ndim == 2:
            arr = arr.reshape(-1)  # per-head attention bias (H, Hd)
        out[tname] = np.ascontiguousarray(arr)
    return out


# ---------------------------------------------------------------------------
# SAM / SAM2 image encoders (the released sam_*.pt / sam2*.pt key names)
# ---------------------------------------------------------------------------

def sam_encoder_params(sd: dict, prefix: str = "image_encoder.") -> dict:
    """A torch SAM image-encoder state dict -> the params subtree of the
    ``ImageEncoderViT`` in JAX layout (nested dicts of numpy arrays): convs
    HWIO, linears (in, out), ``blocks.i`` -> ``block{i}``, ``mlp.lin{1,2}``
    -> ``mlp/Dense_{0,1}``, ``neck.{0,2}`` -> ``neck{0,1}``, ``neck.{1,3}`` ->
    ``neck_ln{0,1}``; ``pos_embed`` and ``rel_pos_{h,w}`` as they are."""
    def g(k):
        return np.asarray(sd[prefix + k], np.float32)

    def lin(k):
        return {"kernel": g(k + ".weight").T, "bias": g(k + ".bias")}

    p = {
        "patch_embed": {"kernel": g("patch_embed.proj.weight").transpose(2, 3, 1, 0),
                        "bias": g("patch_embed.proj.bias")},
        "pos_embed": g("pos_embed"),
        "neck0": {"kernel": g("neck.0.weight").transpose(2, 3, 1, 0)},
        "neck_ln0": {"scale": g("neck.1.weight"), "bias": g("neck.1.bias")},
        "neck1": {"kernel": g("neck.2.weight").transpose(2, 3, 1, 0)},
        "neck_ln1": {"scale": g("neck.3.weight"), "bias": g("neck.3.bias")},
    }
    i = 0
    while f"{prefix}blocks.{i}.norm1.weight" in sd:
        b = f"blocks.{i}."
        blk = {
            "norm1": {"scale": g(b + "norm1.weight"), "bias": g(b + "norm1.bias")},
            "norm2": {"scale": g(b + "norm2.weight"), "bias": g(b + "norm2.bias")},
            "attn": {"qkv": lin(b + "attn.qkv"), "proj": lin(b + "attn.proj")},
            "mlp": {"Dense_0": lin(b + "mlp.lin1"), "Dense_1": lin(b + "mlp.lin2")},
        }
        if prefix + b + "attn.rel_pos_h" in sd:
            blk["attn"]["rel_pos_h"] = g(b + "attn.rel_pos_h")
            blk["attn"]["rel_pos_w"] = g(b + "attn.rel_pos_w")
        p[f"block{i}"] = blk
        i += 1
    return p


def sam2_hiera_params(sd: dict, prefix: str = "image_encoder.trunk.") -> dict:
    """A torch SAM2 Hiera trunk state dict -> the params subtree of
    ``Hiera`` in JAX layout: the patch embed HWIO, ``pos_embed`` and
    ``pos_embed_window`` NHWC, ``blocks.i`` -> ``b{i}`` (norms, attention
    qkv / proj, the dim-change ``proj``, ``mlp.layers.{0,1}`` ->
    ``mlp{0,1}``)."""
    def g(k):
        return np.asarray(sd[prefix + k], np.float32)

    def lin(k):
        return {"kernel": g(k + ".weight").T, "bias": g(k + ".bias")}

    p = {
        "patch_embed": {"kernel": g("patch_embed.proj.weight").transpose(2, 3, 1, 0),
                        "bias": g("patch_embed.proj.bias")},
        "pos_embed": g("pos_embed").transpose(0, 2, 3, 1),
        "pos_embed_window": g("pos_embed_window").transpose(0, 2, 3, 1),
    }
    i = 0
    while f"{prefix}blocks.{i}.norm1.weight" in sd:
        b = f"blocks.{i}."
        blk = {
            "norm1": {"scale": g(b + "norm1.weight"), "bias": g(b + "norm1.bias")},
            "norm2": {"scale": g(b + "norm2.weight"), "bias": g(b + "norm2.bias")},
            "attn": {"qkv": lin(b + "attn.qkv"), "proj": lin(b + "attn.proj")},
            "mlp0": lin(b + "mlp.layers.0"),
            "mlp1": lin(b + "mlp.layers.1"),
        }
        if prefix + b + "proj.weight" in sd:
            blk["proj"] = lin(b + "proj")
        p[f"b{i}"] = blk
        i += 1
    return p


def _flatten(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


def _load_subtree(module: nn.Module, new: dict, what: str) -> nn.Module:
    """``new`` (a params subtree in JAX layout) into ``module``, whose params
    it must match key for key and shape for shape (the JAX loaders' checks
    and messages)."""
    flat_old = {k[1:]: v for k, v in _flat(module).items() if k[0] == "params"}
    flat_new = _flatten(new)
    missing = set(flat_old) - set(flat_new)
    extra = set(flat_new) - set(flat_old)
    if missing or extra:
        raise ValueError(f"{what} map mismatch: missing={sorted(missing)[:4]} "
                         f"extra={sorted(extra)[:4]}")
    for k, v in flat_new.items():
        if tuple(flat_old[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: {flat_old[k].shape} vs {v.shape}")
    stats = {"/".join(k): v for k, v in _flat(module).items() if k[0] != "params"}
    load_jax_variables(module, {**stats, **{"/".join(("params",) + k): v
                                            for k, v in flat_new.items()}})
    return module


def load_sam_encoder(model: nn.Module, sd: dict, prefix: str = "image_encoder.") -> nn.Module:
    """``model``'s image encoder (``model.image_encoder`` of a SAM model, or
    the bare ``ImageEncoderViT``) filled in place from a SAM checkpoint's
    tensors; a key or shape that does not match raises. Returns ``model``."""
    enc = getattr(model, "image_encoder", model)
    _load_subtree(enc, sam_encoder_params(sd, prefix), "SAM encoder")
    return model


def load_sam2_hiera(model: nn.Module, sd: dict, prefix: str = "image_encoder.trunk.") -> nn.Module:
    """``model``'s Hiera trunk (a bare ``Hiera``, or a SAM2 model's trunk
    under ``image_encoder.trunk`` or ``trunk``) filled in place from a SAM2
    checkpoint's tensors; a key or shape that does not match raises.
    Returns ``model``."""
    trunk = None
    if hasattr(model, "b0"):
        trunk = model
    else:
        for path in (("image_encoder", "trunk"), ("trunk",)):
            node = model
            for k in path:
                node = getattr(node, k, None)
            if node is not None and hasattr(node, "b0"):
                trunk = node
                break
    if trunk is None:
        raise ValueError("no Hiera trunk found in params")
    _load_subtree(trunk, sam2_hiera_params(sd, prefix), "SAM2 Hiera")
    return model
