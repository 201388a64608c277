"""Load a JAX (flax) variable tree of the JAX package into the port.

The port's modules carry the JAX tree's names (``l4.pair0.fwd.layer.proj_up``
for ``params/l4/pair0/fwd/layer/proj_up``), so the mapping is by path with
the layout conventions converted:

* 2-D conv ``kernel`` (kh, kw, in/groups, out) HWIO -> ``weight`` OIHW;
* 1-D conv ``kernel`` (k, in/groups, out) -> ``weight`` (out, in/groups, k);
* dense ``kernel`` (in, out) -> ``weight`` (out, in), the gate kernels
  (3*inner, nh) and ``lm_head`` included;
* an embedding table ``embedding`` (vocab, dim) -> ``weight``, not transposed;
* BatchNorm ``bn/scale`` -> ``bn.weight``; ``batch_stats`` ``mean``/``var``
  -> ``running_mean``/``running_var``;
* everything else (biases, norm scales, headwise (nh, dh, dh) weights,
  ``learnable_skip``, the sLSTM ``recurrent_kernel`` (nh, dh, 4, dh) and
  ``bias`` (nh, 4, dh)) keeps its name and shape. The layout rules apply to
  leaves named ``kernel`` only.

Any missing or extra key, or a shape mismatch, raises. ``port_named`` maps
any tree shaped like ``params`` (gradients, an optimizer trace, an EMA) to
port names and layouts the same way. This module reads plain numpy arrays
and imports nothing of JAX.
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


def torch_name(path: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    """One flat JAX key and array -> (state_dict key, array in torch layout)."""
    coll, *mods, leaf = path.split("/")
    if coll == "batch_stats":
        stat = {"mean": "running_mean", "var": "running_var"}
        if leaf not in stat:
            raise KeyError(f"unknown batch statistic {path!r}")
        leaf = stat[leaf]
    elif coll != "params":
        raise KeyError(f"unknown variable collection in {path!r}")
    elif leaf == "kernel":
        leaf = "weight"
        if arr.ndim == 4:
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
    return ".".join([*mods, leaf]), np.ascontiguousarray(arr)


def port_named(flat: Mapping[str, np.ndarray], collection: str = "params"
               ) -> dict[str, np.ndarray]:
    """A flattened tree shaped like the JAX ``collection`` (keys without the
    collection, as ``flatten_variables(grads)`` gives them) -> {port
    state_dict name: array in the port's layout}."""
    out = {}
    for path, arr in flat.items():
        name, a = torch_name(f"{collection}/{path}", np.asarray(arr))
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
    loaded = {}
    for path, arr in flat.items():
        name, arr = torch_name(path, np.asarray(arr))
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
