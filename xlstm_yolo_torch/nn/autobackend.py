"""AutoBackend: one ``forward(img)`` over every artifact the port reads.

Port of ``AutoBackend`` in ``xlstm_yolo_tpu/nn/autobackend.py``:
``forward`` takes (B, H, W, 3) float32 images in [0, 1] and returns the
(B, N, 4 + nc) candidates as numpy (the first output of an artifact with
NMS: its dets). The kinds, by name and, for ``.pt``, by content:

* ``pt2`` — a program of ``Exporter(format="pt2")``, through
  ``torch.export.load`` after the ViL ops are registered;
* ``ckpt`` — the port's own checkpoint ``.pt`` (a ``model`` dict and a
  ``yaml`` dict; ``utils.checkpoint``), its EMA weights;
* ``torch`` — an Ultralytics-layout ``.pt`` (``state_dict`` with a
  ``yaml``; ``utils.torch_import``);
* ``yaml`` — a model YAML, weights from seed 0;
* ``remote`` — an ``http(s)://`` URL of a ``utils.remote.serve_model``
  server (or the JAX package's: the protocol is the same);
* ``onnx``, ``savedmodel``, ``tflite`` — through onnxruntime or
  TensorFlow, each imported when such an artifact is opened (an
  ImportError names a missing one).

The torch kinds run on ``device``: the card unless the caller asks for
the CPU.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

TORCH_KINDS = ("pt2", "ckpt", "torch", "yaml")


def sniff_pt(path: str | Path) -> str:
    """A ``.pt`` file's kind by its content: ``ckpt`` for the port's
    checkpoint (a ``model`` dict and a ``yaml`` dict), ``torch`` for an
    interchange file (a ``state_dict``, or a bare dict of tensors)."""
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: not a checkpoint dict")
    if isinstance(obj.get("model"), dict) and isinstance(obj.get("yaml"), dict):
        return "ckpt"
    if "state_dict" in obj or (obj and all(isinstance(v, torch.Tensor) for v in obj.values())):
        return "torch"
    raise ValueError(f"unrecognized checkpoint structure in {path}")


class AutoBackend:
    def __init__(self, weights: str | Path, imgsz: int = 640,
                 device: str | torch.device = "cuda"):
        from ..utils import resolve_device

        self._raw = str(weights)  # URLs must not round-trip through Path
        self.path = Path(self._raw)
        self.imgsz = imgsz
        self.device = resolve_device(device)
        self.kind = self._sniff_str(self._raw) or self._sniff(self.path)
        self.meta: dict = {}
        getattr(self, f"_init_{self.kind}")()

    @staticmethod
    def _sniff_str(s: str) -> str | None:
        return "remote" if s.startswith(("http://", "https://")) else None

    @staticmethod
    def _sniff(p: Path) -> str:
        s = str(p)
        if s.endswith(".pt2"):
            return "pt2"
        if s.endswith(".pt"):
            return sniff_pt(p)
        if s.endswith(".tflite"):
            return "tflite"
        if s.endswith(".onnx"):
            return "onnx"
        if s.endswith("_savedmodel") or (p / "saved_model.pb").exists():
            return "savedmodel"
        if s.endswith((".yaml", ".yml")):
            return "yaml"
        raise ValueError(f"cannot determine backend for {p}")

    # -- init per kind ----------------------------------------------------
    def _model(self, model):
        model = model.eval()
        self.meta = {"task": model.task, "nc": model.nc, "names": model.names}
        self._fn = model.predictions

    def _init_pt2(self):
        from ..engine.exporter import load_pt2

        self._fn, self.meta = load_pt2(self.path, self.device)

    def _init_ckpt(self):
        from ..utils.checkpoint import load_checkpoint

        self._model(load_checkpoint(self.path, use_ema=True, device=self.device)[0])

    def _init_torch(self):
        from ..utils.torch_import import load_torch_model

        self._model(load_torch_model(self.path, device=self.device)[0])

    def _init_yaml(self):
        from .tasks import TaskModel

        self._model(TaskModel(str(self.path), device=self.device, seed=0))

    def _init_savedmodel(self):
        import tensorflow as tf

        self._sm = tf.saved_model.load(str(self.path))
        fn = self._sm.signatures["serving_default"]

        def call(img):
            out = fn(images=tf.constant(np.asarray(img, np.float32)))
            return np.asarray(next(iter(out.values())))

        self._fn = call

    def _init_tflite(self):
        import tensorflow as tf

        self._interp = tf.lite.Interpreter(model_path=str(self.path))
        self._interp.allocate_tensors()
        inp = self._interp.get_input_details()[0]
        outs = self._interp.get_output_details()

        def call(img):
            self._interp.set_tensor(inp["index"], np.asarray(img, np.float32))
            self._interp.invoke()
            return self._interp.get_tensor(outs[0]["index"])

        self._fn = call

    def _init_onnx(self):
        try:
            import onnxruntime as ort
        except ImportError as e:
            raise ImportError("the onnx backend needs onnxruntime: pip install onnxruntime"
                              ) from e
        self._sess = ort.InferenceSession(str(self.path), providers=["CPUExecutionProvider"])
        inp_name = self._sess.get_inputs()[0].name
        meta_path = self.path.with_suffix(".json")
        if meta_path.exists():
            self.meta = json.loads(meta_path.read_text())

        def call(img):
            return self._sess.run(None, {inp_name: np.asarray(img, np.float32)})[0]

        self._fn = call

    def _init_remote(self):
        from ..utils.remote import RemoteModel

        rm = RemoteModel(self._raw)
        self.meta = rm.meta
        self._fn = rm

    # -- uniform API -------------------------------------------------------
    def forward(self, img) -> np.ndarray:
        """img: (B, H, W, 3) float32 in [0, 1] -> (B, N, 4 + nc) candidates."""
        if self.kind not in TORCH_KINDS:
            out = self._fn(np.asarray(img, np.float32))
        else:
            with torch.inference_mode():
                out = self._fn(torch.as_tensor(img, dtype=torch.float32).to(self.device))
        if isinstance(out, (list, tuple)):
            out = out[0]
        if isinstance(out, torch.Tensor):
            out = out.float().cpu().numpy()
        return np.asarray(out)

    def warmup(self, batch: int | None = None):
        """One forward of zeros: an exported program's batch and size
        (its meta), else ``batch`` (1) at ``imgsz``."""
        batch = batch or int(self.meta.get("batch", 1))
        sz = int(self.meta.get("imgsz", self.imgsz)) if self.kind == "pt2" else self.imgsz
        self.forward(np.zeros((batch, sz, sz, 3), np.float32))
        return self

    __call__ = forward
