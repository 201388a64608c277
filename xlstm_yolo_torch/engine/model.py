"""The user-facing model: ``YOLO("vil_yolon.yaml").train(...)``, ``.val``,
``.predict``.

Port of ``Model`` in ``xlstm_yolo_tpu/engine/model.py`` for the detect task:
built from a model YAML (weights from a seed) or from a checkpoint ``.pt``
of the port (``utils.checkpoint``: its EMA weights), on ``device`` (the
card unless the caller asks for ``"cpu"``). ``train`` runs
``engine.trainer.Trainer`` and keeps its final model (the EMA weights and
the BatchNorm statistics, rebuilt to the dataset's classes); ``val`` runs
``engine.validator.Validator``; ``predict`` (and calling the model) runs
``engine.predictor.Predictor`` and returns ``Results``. Not ported:
``track``, ``export`` and reference torch ``.pt`` weights.
"""
from __future__ import annotations

import copy
from pathlib import Path

import torch


class Model:
    def __init__(self, model: str | Path = "vil_yolon.yaml", task: str | None = None,
                 device: str | torch.device = "cuda", seed: int = 0):
        from ..nn.tasks import TaskModel
        from ..utils import resolve_device
        from ..utils.callbacks import default_callbacks

        self.device = resolve_device(device)
        self.model_path = str(model)
        self.ckpt = None
        if self.model_path.endswith((".yaml", ".yml")):
            self.model = TaskModel(self.model_path, device=self.device, seed=seed)
        elif self.model_path.endswith(".pt"):
            from ..utils.checkpoint import load_checkpoint

            self.model, self.ckpt = load_checkpoint(self.model_path, use_ema=True,
                                                    device=self.device)
        else:
            raise ValueError(f"unsupported model source {model!r} (a model .yaml or a checkpoint "
                             f".pt of this package)")
        self.task = task or self.model.task
        if self.task != "detect":
            raise ValueError(f"task {self.task!r}: the port has the detect task only")
        self.predictor = None
        self.trainer = None
        self.metrics = None
        self.callbacks = default_callbacks()

    def add_callback(self, event: str, func) -> None:
        self.callbacks.add(event, func)

    def clear_callback(self, event: str) -> None:
        self.callbacks._cbs[event] = []

    def reset_callbacks(self) -> None:
        from ..utils.callbacks import default_callbacks

        self.callbacks = default_callbacks()

    @property
    def names(self) -> dict:
        return self.model.names

    def predict(self, source=None, **kwargs) -> list:
        """``source`` (an image file, a directory, an RGB ndarray, or a list)
        -> one ``Results`` per image. ``kwargs`` go to ``Predictor`` (conf,
        iou, imgsz, max_det, half) and rebuild it when given."""
        from .predictor import Predictor

        if source is None:
            raise ValueError("predict needs a source: an image file, a directory or an array")
        if self.predictor is None or kwargs:
            model = self.model.eval()
            if kwargs.get("half") or kwargs.get("dtype") == "bfloat16":
                model = copy.deepcopy(model)  # the Predictor casts its model's parameters
            self.predictor = Predictor(model, callbacks=self.callbacks, **kwargs)
        return self.predictor(source)

    def __call__(self, source=None, **kwargs):
        return self.predict(source, **kwargs)

    def val(self, data: str | None = None, **kwargs) -> dict:
        """mAP over ``data``'s val split; ``kwargs`` go to ``Validator``
        (imgsz, batch, conf, iou, half, ...)."""
        from .validator import Validator

        self.metrics = Validator(self.model, callbacks=self.callbacks, **kwargs)(data=data)
        return self.metrics

    def train(self, data: str | None = None, **kwargs) -> dict:
        """Train on ``data`` with ``cfg/default.yaml``'s keys as ``kwargs``;
        the model becomes the trained one (EMA weights)."""
        from .trainer import Trainer

        self.trainer = Trainer(self.model, overrides={"data": data, "device": str(self.device),
                                                      **kwargs}, callbacks=self.callbacks)
        result = self.trainer.train()
        self.model = self.trainer.model
        self.predictor = None
        self.metrics = self.trainer.metrics
        return result

    def save(self, path: str | Path) -> Path:
        """Write the model as a checkpoint ``.pt`` that ``Model(path)`` reads."""
        from ..utils.checkpoint import save_checkpoint

        return save_checkpoint(path, self.model)


class YOLO(Model):
    """``YOLO("vil_yolon.yaml")``: the detect ``Model``."""
