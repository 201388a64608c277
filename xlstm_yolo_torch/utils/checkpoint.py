"""Checkpoint save and load for training and resuming.

Port of ``save_checkpoint``, ``load_checkpoint`` and ``load_optimizer_state``
in ``xlstm_yolo_tpu/utils/checkpoint.py``. The JAX package writes a
directory (msgpack state and a YAML sidecar) so that loading unpickles
nothing; here one ``.pt`` file holds plain containers of tensors, numbers
and strings, and is read with ``torch.load(weights_only=True)``, which
refuses anything else. It holds the model's YAML graph, scale and class
count and class names, its parameters and buffers (the BatchNorm
statistics), the EMA parameters, the optimizer state
(``StepUpdate.state_dict``), ``n_updates``, the epoch and the best fitness.
"""
from __future__ import annotations

import datetime
from pathlib import Path

import torch

VERSION = "0.1.0"


def save_checkpoint(path: str | Path, step, epoch: int = -1, best_fitness: float = 0.0,
                    ema=None) -> Path:
    """Write ``step`` (an ``engine.trainer.TrainStep``: its model, update and
    ``n_updates``; or a bare ``TaskModel``, whose parameters then stand for
    the EMA unless ``ema``, a model of the same graph, holds it, and which
    has no optimizer state) at ``epoch`` to ``path``; returns the path."""
    model = step if isinstance(step, torch.nn.Module) else step.model
    ckpt = {
        "yaml": {k: v for k, v in model.yaml.items() if k != "yaml_file"},
        "scale": model.scale, "nc": model.nc,
        "names": {int(k): str(v) for k, v in getattr(model, "names", {}).items()},
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "n_updates": 0, "epoch": int(epoch), "best_fitness": float(best_fitness),
        "date": datetime.datetime.now().isoformat(), "version": VERSION,
    }
    if step is model:
        ckpt["ema"] = {n: p.detach().cpu() for n, p in (ema or model).named_parameters()}
    else:
        update = step.update
        ckpt["ema"] = {n: e.detach().cpu() for n, e in zip(update.names, update.ema)}
        ckpt["optimizer"] = {k: ([t.detach().cpu() for t in v] if isinstance(v, list) else v)
                             for k, v in update.state_dict().items()}
        ckpt["n_updates"] = int(step.n_updates)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(p.suffix + ".tmp")
    torch.save(ckpt, tmp)
    tmp.replace(p)
    return p


def _read(path: str | Path) -> dict:
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def load_checkpoint(path: str | Path, use_ema: bool = True, device: str | torch.device = "cuda"):
    """(model, meta): a ``TaskModel`` rebuilt from the checkpoint's graph on
    ``device``, holding its parameters (the EMA parameters when
    ``use_ema``) and BatchNorm statistics, and the checkpoint's other
    entries (epoch, best_fitness, n_updates, date, version)."""
    from ..nn.tasks import TaskModel

    ckpt = _read(path)
    model = TaskModel(ckpt["yaml"], nc=ckpt["nc"], scale=ckpt["scale"], device="cpu")
    state = dict(ckpt["model"])
    if use_ema:
        state.update(ckpt["ema"])
    model.load_state_dict(state)
    if ckpt.get("names"):
        model.names = dict(ckpt["names"])
    meta = {k: ckpt[k] for k in ("epoch", "best_fitness", "n_updates", "date", "version")}
    return model.to(device), meta


def load_optimizer_state(path: str | Path, step) -> bool:
    """Restore the optimizer state, the EMA and ``n_updates`` of ``step``
    (a ``TrainStep`` over the same model and optimizer) from the checkpoint
    at ``path``; the model's own weights are ``load_checkpoint``'s (or
    ``step.model.load_state_dict``). False if the file holds no optimizer
    state."""
    ckpt = _read(path)
    if "optimizer" not in ckpt:
        return False
    dev = step.update.params[0].device
    state = {k: ([t.to(dev) for t in v] if isinstance(v, list) else v)
             for k, v in ckpt["optimizer"].items()}
    step.update.load_state_dict(state)
    step.n_updates = int(ckpt["n_updates"])
    return True
