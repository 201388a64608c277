"""Load a JAX (flax) variable tree of the JAX package into the port.

The port's modules carry the JAX tree's names (``l4.pair0.fwd.layer.proj_up``
for ``params/l4/pair0/fwd/layer/proj_up``), so the mapping is by path with
the layout conventions converted:

* 3-D conv ``kernel`` (kd, kh, kw, in/groups, out) DHWIO -> ``weight``
  OIDHW;
* 2-D conv ``kernel`` (kh, kw, in/groups, out) HWIO -> ``weight`` OIHW;
* a flax ``ConvTranspose`` ``kernel`` (kh, kw, in, out), flipped in both
  spatial axes -> torch's transposed-conv ``weight`` (in, out, kh, kw):
  flax does not flip the kernel, torch's transposed conv does. The path
  alone cannot tell it from a conv's, so the caller names the port's
  ``nn.ConvTranspose2d`` modules (``transposed``; ``transposed_convs``),
  a ``ConvTransposeBN``'s conv and the Segment head's bare ``proto_up``
  (npr to npr channels: its kernel's shape reads the same either way, so
  only the name keeps it from loading unflipped) alike;
* 1-D conv ``kernel`` (k, in/groups, out) WIO -> ``weight`` (out, in/groups,
  k) OIW;
* dense ``kernel`` (in, out) -> ``weight`` (out, in), the gate kernels
  (3*inner, nh) and ``lm_head`` included;
* the ``DenseGeneral`` kernels of flax's ``MultiHeadDotProductAttention``
  (modules ``query``, ``key``, ``value`` and ``out``): ``query``/``key``/
  ``value`` ``kernel`` (D, NH, hd) -> ``weight`` (NH*hd, D) and ``bias``
  (NH, hd) -> (NH*hd,); ``out`` ``kernel`` (NH, hd, D) -> ``weight`` (D,
  NH*hd) (the port's ``nn.Linear`` layouts). A kernel of another rank
  there raises (a plain Dense of such a name, 2-D, is a dense kernel);
* an embedding table ``embedding`` (vocab, dim) -> ``weight``, not transposed;
* BatchNorm ``bn/scale`` -> ``bn.weight``; ``batch_stats`` ``mean``/``var``
  -> ``running_mean``/``running_var``;
* a leaf under ``pairs`` (the stacked layout of a pipelined
  ``ViLBlockPairBlock``: every pair's tensor stacked on a leading axis n)
  takes the rule of its pair's leaf slice by slice, the leading axis kept;
* the mixture-of-experts leaves ``w_gate`` / ``w_up`` (E, D, F) and
  ``w_down`` (E, F, D) are raw parameters and keep their layout (the
  ``router``'s kernel is a dense kernel);
* everything else (biases, norm scales, headwise (nh, dh, dh) weights,
  ``learnable_skip``, the sLSTM ``recurrent_kernel`` (nh, dh, 4, dh) and
  ``bias`` (nh, 4, dh), YOLO-World's 0-d ``bias``, ``logit_scale`` and
  ``scale``, a BatchNorm's ``scale`` under another name than ``bn``, which
  the port keeps as ``scale``) keeps its name and shape. The layout rules
  apply to leaves named ``kernel`` only.

Any missing or extra key, or a shape mismatch, raises. ``port_named`` maps
any tree shaped like ``params`` (gradients, an optimizer trace, an EMA) to
port names and layouts the same way. ``jax_named`` runs the rules backwards:
a port model's state as the flat JAX variable tree (what the interchange
formats of ``utils.torch_import`` read and write). This module reads plain
numpy arrays and imports nothing of JAX.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn


def flatten_variables(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested mapping of arrays -> {"params/l0/conv/kernel": np.ndarray, ...}."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_variables(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def transposed_convs(model: nn.Module) -> frozenset:
    """The names of ``model``'s ``nn.ConvTranspose2d`` modules."""
    return frozenset(n for n, m in model.named_modules() if isinstance(m, nn.ConvTranspose2d))


STACKED = "pairs"  # the module name of a stacked (pipelined) ViL pair tree


def torch_name(path: str, arr: np.ndarray, transposed: frozenset = frozenset()
               ) -> tuple[str, np.ndarray]:
    """One flat JAX key and array -> (state_dict key, array in torch layout);
    ``transposed`` names the port's transposed-conv modules."""
    if STACKED in path.split("/")[1:-1]:  # one pair's rule on each slice
        if arr.ndim == 0:
            raise ValueError(f"a stacked leaf without its leading axis at {path!r}")
        parts = [_torch_leaf(path, a, transposed) for a in arr]
        return parts[0][0], np.stack([a for _, a in parts])
    return _torch_leaf(path, arr, transposed)


def _torch_leaf(path: str, arr: np.ndarray, transposed: frozenset) -> tuple[str, np.ndarray]:
    coll, *mods, leaf = path.split("/")
    if coll == "batch_stats":
        stat = {"mean": "running_mean", "var": "running_var"}
        if leaf not in stat:
            raise KeyError(f"unknown batch statistic {path!r}")
        leaf = stat[leaf]
    elif coll != "params":
        raise KeyError(f"unknown variable collection in {path!r}")
    elif (mods and mods[-1] in ATTENTION_PARTS and leaf in ("kernel", "bias")
          and arr.ndim != (2 if leaf == "kernel" else 1)):  # not a plain Dense's
        arr = _dense_general(mods[-1], leaf, arr, path)
        leaf = "weight" if leaf == "kernel" else leaf
    elif leaf == "kernel" and ".".join(mods) in transposed:
        if arr.ndim != 4:
            raise ValueError(f"unexpected transposed-conv kernel rank {arr.ndim} at {path!r}")
        leaf = "weight"
        arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
    elif leaf == "kernel":
        leaf = "weight"
        if arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"unexpected kernel rank {arr.ndim} at {path!r}")
    elif leaf == "scale" and mods and mods[-1] == "bn":
        leaf = "weight"
    elif leaf == "embedding":
        leaf = "weight"
    # np.ascontiguousarray makes a 0-d leaf (a scalar parameter) 1-d
    return ".".join([*mods, leaf]), np.ascontiguousarray(arr) if arr.ndim else np.array(arr)


ATTENTION_PARTS = ("query", "key", "value", "out")  # flax MultiHeadDotProductAttention's


def _dense_general(part: str, leaf: str, arr: np.ndarray, path: str) -> np.ndarray:
    """A ``DenseGeneral`` leaf of flax's attention in the port's
    ``nn.Linear`` layout (see the module docstring); raises on any other
    shape."""
    if leaf == "bias" and part != "out" and arr.ndim == 2:
        return arr.reshape(-1)
    if leaf == "kernel" and arr.ndim == 3:
        if part == "out":  # (NH, hd, D) -> (D, NH*hd)
            return arr.reshape(-1, arr.shape[-1]).T
        return arr.reshape(arr.shape[0], -1).T  # (D, NH, hd) -> (NH*hd, D)
    raise ValueError(f"unexpected {leaf} of shape {arr.shape} for attention's {part!r} "
                     f"at {path!r}")


def port_named(flat: Mapping[str, np.ndarray], collection: str = "params",
               transposed: frozenset = frozenset()) -> dict[str, np.ndarray]:
    """A flattened tree shaped like the JAX ``collection`` (keys without the
    collection, as ``flatten_variables(grads)`` gives them) -> {port
    state_dict name: array in the port's layout}; ``transposed`` as for
    ``torch_name``."""
    out = {}
    for path, arr in flat.items():
        name, a = torch_name(f"{collection}/{path}", np.asarray(arr), transposed)
        if name in out:
            raise KeyError(f"two JAX keys map to {name!r}")
        out[name] = a
    return out


@torch.no_grad()
def load_jax_variables(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Fill ``model`` (in place) from a flattened JAX variable tree holding
    both ``params`` and ``batch_stats``; returns ``model``."""
    state = model.state_dict()
    targets = {k for k in state if not k.endswith("num_batches_tracked")}
    transposed = transposed_convs(model)
    loaded = {}
    for path, arr in flat.items():
        name, arr = torch_name(path, np.asarray(arr), transposed)
        if name in loaded:
            raise KeyError(f"two JAX keys map to {name!r}")
        loaded[name] = arr
    missing = sorted(targets - loaded.keys())
    extra = sorted(loaded.keys() - targets)
    if missing or extra:
        raise KeyError(f"JAX variables do not match the model: missing {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}, extra {extra[:8]}"
                       f"{' ...' if len(extra) > 8 else ''}")
    for name, arr in loaded.items():
        dst = state[name]
        if tuple(dst.shape) != arr.shape:
            raise ValueError(f"shape mismatch at {name!r}: model {tuple(dst.shape)}, "
                             f"JAX {arr.shape}")
        dst.copy_(torch.from_numpy(arr.copy()).to(dst.dtype))
    return model


def _jax_leaf(mod: nn.Module, parent: nn.Module | None, mname: str, leaf: str,
              arr: np.ndarray) -> tuple[str, str, np.ndarray]:
    """One parameter or buffer ``leaf`` of module ``mod`` (named ``mname``
    in ``parent``) -> (collection, JAX leaf name, array in JAX layout):
    ``torch_name``'s rules backwards, told apart by the module's class."""
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", leaf[len("running_"):], arr
    if leaf != "weight":
        return "params", leaf, arr
    if isinstance(mod, nn.modules.batchnorm._BatchNorm) and mname == "bn":
        return "params", "scale", arr
    if isinstance(mod, nn.Embedding):
        return "params", "embedding", arr
    if isinstance(mod, nn.ConvTranspose2d):
        return "params", "kernel", arr.transpose(2, 3, 0, 1)[::-1, ::-1]
    if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
        return "params", "kernel", arr.transpose(*{3: (2, 1, 0), 4: (2, 3, 1, 0),
                                                   5: (2, 3, 4, 1, 0)}[arr.ndim])
    if isinstance(mod, nn.Linear):
        nh = getattr(parent, "num_heads", None)
        if mname in ATTENTION_PARTS and nh:  # flax attention's DenseGeneral
            if mname == "out":  # (D, NH*hd) -> (NH, hd, D)
                return "params", "kernel", arr.T.reshape(nh, -1, arr.shape[0])
            return "params", "kernel", arr.T.reshape(arr.shape[1], nh, -1)
        return "params", "kernel", arr.T
    return "params", leaf, arr


def jax_named(model: nn.Module) -> dict[str, np.ndarray]:
    """``model``'s parameters and BatchNorm statistics as the flattened JAX
    variable tree ({"params/l0/conv/kernel": array in JAX layout, ...}); see
    ``jax_items``."""
    return {key: jarr for _, key, jarr in jax_items(model)}


def jax_items(model: nn.Module):
    """(state_dict name, flat JAX key, array in JAX layout) for each of
    ``model``'s parameters and BatchNorm statistics, in state_dict order.
    ``torch_name`` backwards, each key checked by running it forward again
    (a leaf whose way back is not the way there raises). An attention part
    (``query``, ``key``, ``value``, ``out``) whose parent sets
    ``num_heads`` is a flax ``DenseGeneral``; its bias (NH, hd) but
    ``out``'s."""
    mods = dict(model.named_modules())
    transposed = transposed_convs(model)
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        *path, leaf = name.split(".")
        owner = ".".join(path)
        parent = mods.get(".".join(path[:-1])) if path else None
        arr = t.detach().cpu().float().numpy()
        slices = list(arr) if STACKED in path else [arr]
        nh = getattr(parent, "num_heads", None)
        jarrs = []
        for a in slices:
            coll, jleaf, jarr = _jax_leaf(mods[owner], parent, path[-1] if path else "", leaf, a)
            if (jleaf == "bias" and path and path[-1] in ATTENTION_PARTS[:3] and nh
                    and isinstance(mods[owner], nn.Linear)):
                jarr = jarr.reshape(nh, -1)
            jarrs.append(np.ascontiguousarray(jarr))
        jarr = np.stack(jarrs) if STACKED in path else jarrs[0]
        key = "/".join([coll, *path, jleaf])
        back, barr = torch_name(key, jarr, transposed)
        if back != name or barr.shape != arr.shape or not np.array_equal(barr, arr, equal_nan=True):
            raise ValueError(f"{name!r}: no JAX key maps back to it (tried {key!r})")
        yield name, key, jarr
