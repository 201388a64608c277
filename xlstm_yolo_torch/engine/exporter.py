"""Exporter: the inference function of a model, serialized.

Port of ``Exporter``, ``FORMATS`` and ``load_stablehlo`` in
``xlstm_yolo_tpu/engine/exporter.py``. Every format wraps the same
function: NHWC float32 images in [0, 1], (B, imgsz, imgsz, 3), through
``TaskModel.predictions`` to (B, N, 4 + nc) candidates; with ``nms`` the
fixed-shape ``ops.nms.non_max_suppression`` follows and the function
returns (dets (B, max_det, 6), valid). ``half`` casts the parameters to
bf16 as bf16 serving does (``nn.fuse.cast_params``: BatchNorm statistics
stay fp32) and the images with them, so the ViL layers run their bf16
kernel; the candidates come back in fp32. The model given is not changed:
the export works on a copy on ``device`` (the card unless the caller asks
for the CPU).

* ``pt2`` (the counterpart of the JAX ``stablehlo``): ``torch.export`` at
  fixed shapes under ``torch.no_grad()``, saved with ``torch.export.save``
  beside a JSON sidecar of the JAX meta keys (``imgsz``, ``batch``,
  ``task``, ``nc``, ``names``, ``nms``, ``strides``, ``format``; plus
  ``half``). The ViL kernels are registered ops
  (``kernels.vil_cell.register_op``), so each ViL layer stays one
  ``xlstm_yolo::vil_layer_fwd`` node of the graph, which launches the
  hand-written kernel when the program runs on the card. ``load_pt2``
  reads it back.
* ``torch``: the Ultralytics-layout ``{state_dict, yaml, task, nc, names,
  strides}`` (``utils.torch_import.to_torch_state_dict``; a ViL model
  raises: its weights have no reference names), which ``Model(path)`` of
  either package reads.
* ``onnx``, ``savedmodel``, ``tflite`` need packages the port does not
  carry (``onnx`` and ``onnxscript`` for torch's ONNX exporter, then
  ``onnx2tf`` and ``tensorflow`` for the TensorFlow formats): without them
  they raise an ``ImportError`` that names the missing package.

The ``on_export_start`` and ``on_export_end`` callbacks run around an
export, as in JAX.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

FORMATS = ("pt2", "torch", "onnx", "savedmodel", "tflite")
# the packages each gated format needs, in the order it needs them
GATED = {"onnx": ("onnx", "onnxscript"), "savedmodel": ("onnx", "onnxscript", "onnx2tf"),
         "tflite": ("onnx", "onnxscript", "onnx2tf", "tensorflow")}


class InferenceFunction(nn.Module):
    """The exported function (module docstring): ``model.predictions`` on
    NHWC float32 images in [0, 1] (cast to ``dtype`` first), fp32
    candidates out, then, with ``nms``, the fixed-shape NMS."""

    def __init__(self, model, nms: bool = False, conf: float = 0.25, iou: float = 0.7,
                 max_det: int = 300, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model, self.dtype = model, dtype
        self.nms, self.conf, self.iou, self.max_det = nms, conf, iou, max_det

    def forward(self, img):
        pred = self.model.predictions(img.to(self.dtype)).float()
        if not self.nms:
            return pred
        from ..ops.nms import non_max_suppression

        return non_max_suppression(pred, conf_thres=self.conf, iou_thres=self.iou,
                                   max_det=self.max_det)


def require(fmt: str) -> None:
    """Raise an ImportError naming the first package ``fmt`` needs that is
    not installed."""
    for pkg in GATED.get(fmt, ()):
        if importlib.util.find_spec(pkg) is None:
            raise ImportError(f"format {fmt!r} needs the {pkg!r} package, which is not "
                              f"installed (pip install {' '.join(GATED[fmt])}); the export "
                              f"that needs no extra package is format='pt2'")


class Exporter:
    def __init__(self, model, format: str = "pt2", imgsz: int = 640, batch: int = 1,
                 nms: bool = False, conf: float = 0.25, iou: float = 0.7, max_det: int = 300,
                 half: bool = False, output_dir: str = "runs/export",
                 device: str | torch.device = "cuda", callbacks=None):
        from ..utils import resolve_device
        from ..utils.callbacks import default_callbacks

        if format not in FORMATS:
            raise ValueError(f"unknown export format {format!r}; choose from {FORMATS}")
        self.callbacks = callbacks if callbacks is not None else default_callbacks()
        self.model = model
        self.format = format
        self.imgsz, self.batch = imgsz, batch
        self.nms, self.conf, self.iou, self.max_det = nms, conf, iou, max_det
        self.half = half
        self.device = resolve_device(device)
        self.output_dir = Path(output_dir)

    def function(self) -> InferenceFunction:
        """The exported function on a copy of the model on the device (its
        parameters in bf16 with ``half``), in eval mode."""
        from ..nn.fuse import cast_params

        model = copy.deepcopy(self.model).eval().to(self.device)
        if self.half:
            cast_params(model, torch.bfloat16)
        return InferenceFunction(model, self.nms, self.conf, self.iou, self.max_det,
                                 torch.bfloat16 if self.half else torch.float32)

    def __call__(self) -> str:
        t0 = time.time()
        self.callbacks.run("on_export_start", self)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        if self.format == "pt2":
            out = self._export_pt2()
        elif self.format == "torch":
            out = self._export_torch()
        else:
            out = self._export_gated()
        print(f"export {self.format} done in {time.time() - t0:.1f}s -> {out}")
        self.callbacks.run("on_export_end", self)
        return str(out)

    def example(self) -> torch.Tensor:
        return torch.zeros((self.batch, self.imgsz, self.imgsz, 3), device=self.device)

    def meta(self) -> dict:
        m = self.model
        return {"imgsz": self.imgsz, "batch": self.batch, "task": m.task, "nc": m.nc,
                "names": m.names, "nms": self.nms, "strides": [int(s) for s in m.strides],
                "format": self.format, "half": self.half}

    def _export_pt2(self) -> Path:
        fn = self.function()
        with torch.no_grad():
            program = torch.export.export(fn, (self.example(),))
        out = self.output_dir / f"{self._stem()}.pt2"
        torch.export.save(program, str(out))
        out.with_suffix(".json").write_text(json.dumps(self.meta(), indent=2))
        return out

    def _export_torch(self) -> Path:
        """The Ultralytics-layout checkpoint (module docstring): ``yaml`` is
        the YAML name the model was built from (the JAX key), or its graph
        where it was built from a dict (which only the port reads)."""
        from ..utils.torch_import import to_torch_state_dict

        m = self.model
        sd = {k: torch.from_numpy(np.ascontiguousarray(v).copy())
              for k, v in to_torch_state_dict(m).items()}
        yaml = m.cfg_name or {k: v for k, v in m.yaml.items() if k != "yaml_file"}
        ckpt = {"state_dict": sd, "yaml": yaml, "scale": m.scale, "task": m.task, "nc": m.nc,
                "names": {int(k): str(v) for k, v in m.names.items()},
                "strides": [int(s) for s in m.strides]}
        out = self.output_dir / f"{self._stem()}.pt"
        torch.save(ckpt, out)
        return out

    def _export_gated(self) -> Path:
        """ONNX through torch's exporter, and the TensorFlow formats through
        ``onnx2tf``: each raises an ImportError naming a missing package."""
        require(self.format)
        onnx_path = self.output_dir / f"{self._stem()}.onnx"
        with torch.no_grad():
            torch.onnx.export(self.function(), (self.example(),), str(onnx_path),
                              input_names=["images"], dynamo=True)
        if self.format == "onnx":
            onnx_path.with_suffix(".json").write_text(json.dumps(self.meta(), indent=2))
            return onnx_path
        import onnx2tf

        sm = self.output_dir / f"{self._stem()}_savedmodel"
        onnx2tf.convert(input_onnx_file_path=str(onnx_path), output_folder_path=str(sm))
        if self.format == "savedmodel":
            return sm
        return next(sm.glob("*_float32.tflite"))

    def _stem(self) -> str:
        return f"{self.model.task}_{self.imgsz}"


def load_pt2(path: str | Path, device: str | torch.device | None = None):
    """An exported ``pt2`` -> (callable, meta): the program's module (on
    ``device`` where given) and its sidecar. The ViL ops are registered
    before the program loads."""
    from ..kernels import vil_conv  # noqa: F401  (registers the xlstm_yolo ops)

    program = torch.export.load(str(path))
    meta_path = Path(path).with_suffix(".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    fn = program.module()
    if device is not None:
        fn = fn.to(device)
    return fn, meta
