"""The user-facing model: ``YOLO("vil_yolon.yaml").train(...)``, ``.val``,
``.predict``.

Port of ``Model`` in ``xlstm_yolo_tpu/engine/model.py`` for the detect,
segment, pose, obb, classify, rtdetr and world tasks (the head of the YAML sets it):
built from a model YAML (weights from a seed) or from a ``.pt``, told
apart by its content: a checkpoint of the port (``utils.checkpoint``: its
EMA weights) or an Ultralytics-layout interchange file with its YAML
(``Exporter(format="torch")`` of either package;
``utils.torch_import.load_torch_model``), on ``device`` (the card unless
the caller asks for ``"cpu"``). ``train`` runs
``engine.trainer.Trainer`` and keeps its final model (the EMA weights and
the BatchNorm statistics, rebuilt to the dataset's classes); ``val`` runs
``engine.validator.Validator``; ``predict`` (and calling the model) runs
``engine.predictor.Predictor`` and returns ``Results`` (with ``stream`` a
generator of them). ``fuse`` folds the BatchNorms into the convolutions,
``info`` describes the model, ``load`` reads either kind of ``.pt`` into
it (an interchange file may be a bare state dict), ``reset_weights`` starts it again from its seed, ``embed`` gives an
image's pooled head maps (a classify model has none: it raises, as the
JAX ``embed`` fails on its (B, nc) logits; an RT-DETR model has no maps
either, and it cannot be validated: ``val``, and ``train`` with its
default ``val=True``, raise, as the JAX package cannot validate one). A
world model's ``train`` takes the trainer's ``text_encoder`` as a
keyword; ``save`` keeps its class count and names but
not its ``txt_feats``, as the JAX checkpoint, so a reloaded world model
has the default guide of its class count. ``export`` runs
``engine.exporter.Exporter`` (``pt2`` by default), ``benchmark``
``utils.benchmarks.benchmark`` and ``tune`` ``engine.tuner.Tuner``, each on
the model's device. ``track`` runs ``predict`` through a ByteTrack or
BoT-SORT tracker (``trackers``).
"""
from __future__ import annotations

import copy
from pathlib import Path

import torch

from ..cfg import TASKS

class Model:
    def __init__(self, model: str | Path = "vil_yolon.yaml", task: str | None = None,
                 device: str | torch.device = "cuda", seed: int = 0, scale: str | None = None):
        from ..nn.tasks import TaskModel
        from ..utils import resolve_device
        from ..utils.callbacks import default_callbacks

        self.device = resolve_device(device)
        self.seed = seed
        self.model_path = str(model)
        self.ckpt = None
        if self.model_path.endswith((".yaml", ".yml")):
            self.model = TaskModel(self.model_path, device=self.device, seed=seed, scale=scale)
        elif self.model_path.endswith(".pt"):
            from ..nn.autobackend import sniff_pt
            from ..utils.checkpoint import load_checkpoint
            from ..utils.torch_import import load_torch_model

            load = load_checkpoint if sniff_pt(self.model_path) == "ckpt" else load_torch_model
            self.model, self.ckpt = load(self.model_path, device=self.device)
        else:
            raise ValueError(f"unsupported model source {model!r} (a model .yaml, or a .pt: a "
                             f"checkpoint of this package or an Ultralytics-layout file)")
        self.task = task or self.model.task
        # RT-DETR and YOLO-World are not among the JAX cfg's TASKS either; the model's
        # own task passes
        if self.task not in TASKS and not self.task == self.model.task in ("rtdetr", "world"):
            raise ValueError(f"task {self.task!r}: the port has the {', '.join(TASKS)} tasks")
        if self.task != self.model.task:
            raise ValueError(f"task {self.task!r} does not match the model's {self.model.task!r}")
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

    def predict(self, source=None, stream: bool = False, **kwargs):
        """``source`` (an image file, a directory, an RGB ndarray, or a list)
        -> one ``Results`` per image, in a list or, with ``stream``, from a
        generator. ``kwargs`` go to ``Predictor`` (conf, iou, imgsz, max_det,
        classes, agnostic_nms, verbose, half) and rebuild it when given."""
        from .predictor import Predictor

        if source is None:
            raise ValueError("predict needs a source: an image file, a directory or an array")
        if self.predictor is None or kwargs:
            model = self.model.eval()
            if kwargs.get("half") or kwargs.get("dtype") == "bfloat16":
                model = copy.deepcopy(model)  # the Predictor casts its model's parameters
            self.predictor = Predictor(model, callbacks=self.callbacks, **kwargs)
        return self.predictor(source, stream=stream)

    def __call__(self, source=None, **kwargs):
        return self.predict(source, **kwargs)

    def track(self, source=None, tracker: str = "bytetrack.yaml", stream: bool = False,
              **kwargs):
        """``predict`` with multi-object tracking: a fresh ``Predictor``
        (``conf`` 0.1 unless given: the tracker takes low-confidence
        detections too) streams ``source`` into the ``tracker`` (a name or
        tracker YAML, ``trackers.create_tracker``) -> ``Results`` with the
        tracks' boxes and ``track_ids`` (``trackers.track_results``), in a
        list or, with ``stream``, from a generator."""
        from ..trackers import create_tracker, track_results
        from .predictor import Predictor

        if source is None:
            raise ValueError("track needs a source: an image file, a directory or arrays")
        kwargs.setdefault("conf", 0.1)
        model = self.model.eval()
        if kwargs.get("half") or kwargs.get("dtype") == "bfloat16":
            model = copy.deepcopy(model)  # the Predictor casts its model's parameters
        predictor = Predictor(model, callbacks=self.callbacks, **kwargs)
        gen = track_results(create_tracker(tracker), predictor(source, stream=True))
        return gen if stream else list(gen)

    def val(self, data: str | None = None, **kwargs) -> dict:
        """mAP over ``data``'s val split; ``kwargs`` go to ``Validator``
        (imgsz, batch, conf, iou, half, ...)."""
        from .validator import RTDETR_NO_VAL, Validator

        if self.task == "rtdetr":
            raise ValueError(RTDETR_NO_VAL)
        self.metrics = Validator(self.model, callbacks=self.callbacks, **kwargs)(data=data)
        return self.metrics

    def train(self, data: str | None = None, text_encoder=None, **kwargs) -> dict:
        """Train on ``data`` with ``cfg/default.yaml``'s keys as ``kwargs``;
        the model becomes the trained one (EMA weights). A world model's
        run takes ``text_encoder`` (``Trainer``'s)."""
        from .trainer import Trainer

        self.trainer = Trainer(self.model, overrides={"data": data, "device": str(self.device),
                                                      **kwargs}, callbacks=self.callbacks)
        self.trainer.text_encoder = text_encoder
        result = self.trainer.train()
        self.model = self.trainer.model
        self.predictor = None
        self.metrics = self.trainer.metrics
        return result

    def save(self, path: str | Path) -> Path:
        """Write the model as a checkpoint ``.pt`` that ``Model(path)`` reads."""
        from ..utils.checkpoint import save_checkpoint

        return save_checkpoint(path, self.model)

    def fuse(self):
        """Fold every BatchNorm into its convolution (``nn.fuse.fuse_conv_bn``,
        exact in eval); returns the model."""
        from ..nn.fuse import fuse_conv_bn

        fuse_conv_bn(self.model.eval())
        self.predictor = None
        return self

    def info(self) -> str:
        return self.model.info()

    def load(self, weights: str | Path):
        """The weights of a ``.pt`` into this model: the parameters and
        BatchNorm statistics (the EMA parameters) and class names of a
        checkpoint of the port, whose graph must match the model; or the
        tensors of an Ultralytics-layout file (a bare state dict too) by
        the name rules of ``utils.torch_import`` (the names that match
        nothing are printed). Returns the model."""
        from ..nn.autobackend import sniff_pt
        from ..utils.checkpoint import load_checkpoint
        from ..utils.torch_import import load_torch_weights

        if not str(weights).endswith(".pt"):
            raise ValueError(f"load takes a .pt (a checkpoint of this package or an "
                             f"Ultralytics-layout file), not {weights!r}")
        if sniff_pt(weights) == "torch":
            load_torch_weights(self.model, weights)
        else:
            loaded, self.ckpt = load_checkpoint(weights, use_ema=True, device="cpu")
            self.model.load_state_dict(loaded.state_dict())
            self.model.names = dict(loaded.names)
        self.predictor = None
        return self

    def export(self, **kwargs) -> str:
        """``engine.exporter.Exporter`` of the model (``format``, ``imgsz``,
        ``batch``, ``nms``, ``half``, ...; on the model's device unless
        ``device`` says otherwise); returns the artifact's path."""
        from .exporter import Exporter

        kwargs.setdefault("device", self.device)
        return Exporter(self.model, callbacks=self.callbacks, **kwargs)()

    def benchmark(self, data: str | None = None, **kwargs) -> list:
        """Export, reload and time each format (``utils.benchmarks.benchmark``)."""
        from ..utils.benchmarks import benchmark

        kwargs.setdefault("device", self.device)
        return benchmark(self.model, data=data, **kwargs)

    def tune(self, data: str | None = None, iterations: int = 10, **kwargs) -> dict:
        """Genetic hyperparameter evolution (``engine.tuner.Tuner``): each
        iteration trains a fresh model of this graph (weights from the
        seed) on ``data`` with ``kwargs`` as the trainer's keys, into
        ``project`` (``runs/tune``)."""
        from ..nn.tasks import TaskModel
        from .tuner import Tuner

        m = self.model
        overrides = {"data": data, "device": str(self.device), **kwargs}

        def model_fn():
            return TaskModel(m.cfg_name or m.yaml, ch=m.ch, nc=m.nc, scale=m.scale,
                             device=self.device, seed=self.seed)

        return Tuner(model_fn, overrides, save_dir=str(kwargs.get("project", "runs/tune")))(
            iterations)

    def reset_weights(self):
        """The model rebuilt from its graph with fresh weights from the seed
        (unfused, BatchNorm statistics reset; a world model's guide kept);
        returns the model."""
        from ..nn.tasks import TaskModel

        m = self.model
        names = dict(m.names)
        self.model = TaskModel(m.yaml, ch=m.ch, nc=m.nc, scale=m.scale, device=self.device,
                               seed=self.seed)
        self.model.names = names
        if m.txt_feats is not None:  # a world model keeps its guide, as the JAX model object
            self.model.txt_feats = m.txt_feats
        self.predictor = None
        return self

    def embed(self, source=None, imgsz: int = 640) -> list:
        """One vector an image of ``source``: each of the Detect head's output
        maps (per scale, the box then the class map; an end-to-end head's
        one2one maps) averaged over H and W, concatenated; fp32, the image
        letterboxed to ``imgsz``."""
        from ..data.augment import letterbox
        from ..nn.heads import det_maps
        from .predictor import load_source

        if self.task in ("classify", "rtdetr"):
            raise ValueError(f"embed pools a detection head's maps; a {self.task} model has none "
                             f"(the JAX Model.embed cannot pool its output either)")
        model = self.model.eval()
        outs = []
        for _, orig in load_source(source):
            img, _, _ = letterbox(orig, imgsz)
            with torch.inference_mode():
                x = torch.from_numpy(img).to(self.device)[None].float() / 255.0
                maps = det_maps(model(x.permute(0, 3, 1, 2)))
                pooled = [t.float().mean((2, 3)).reshape(-1) for pair in maps for t in pair]
                outs.append(torch.cat(pooled).cpu().numpy())
        return outs


class YOLO(Model):
    """``YOLO("vil_yolon.yaml")``, ``YOLO("yolo11n-seg.yaml")``: the
    ``Model`` of the YAML's task."""
