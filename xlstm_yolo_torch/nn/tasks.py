"""Detection model: a compiled YAML graph plus its task metadata.

Port of the detect path of ``TaskModel`` in ``xlstm_yolo_tpu/nn/tasks.py``.
The torch model owns its parameters (the JAX one keeps them outside as a
pytree): they are initialized from a ``torch.Generator`` seed with the JAX
package's init scheme, or loaded from a JAX variable tree with
``utils.jax_weights.load_jax_variables``. ``predictions`` keeps the JAX
boundary: NHWC images in, (B, N, 4 + nc) candidates out; ``loss`` is the
forward plus the v8 detection loss on a padded-label batch.
"""
from __future__ import annotations

import torch

from ..cfg import load_model_yaml
from ..utils import resolve_device
from ..utils.loss import detection_loss
from . import heads as H
from .graph import GraphModel, ParsedModel, parse_model
from .modules import init_tree


class TaskModel(GraphModel):
    """``TaskModel("vil_yolon.yaml", device="cuda")``: the graph on
    ``device`` in eval mode, weights from ``seed``."""

    def __init__(self, cfg: str | dict, ch: int = 3, nc: int | None = None,
                 scale: str | None = None, device: str | torch.device = "cuda", seed: int = 0):
        dev = resolve_device(device)
        if isinstance(cfg, str):
            yaml_dict, yscale = load_model_yaml(cfg)
            scale = scale or yscale
        else:
            yaml_dict = dict(cfg)
        if nc is not None:
            yaml_dict["nc"] = nc
        parsed: ParsedModel = parse_model(yaml_dict, ch=ch, scale=scale)
        super().__init__(parsed)
        self.yaml, self.scale, self.ch = yaml_dict, scale, ch
        self.nc = parsed.nc
        self.names = {i: f"{i}" for i in range(self.nc)}
        self.task = parsed.task
        self.reg_max = 16
        self.init_weights(seed)
        self.eval()
        self.strides = self._probe_strides()
        self.to(dev)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Re-initialize every parameter with the JAX package's scheme,
        drawing from a generator seeded with ``seed``."""
        init_tree(self, seed)

    @torch.no_grad()
    def _probe_strides(self, imgsz: int = 64) -> tuple:
        """Detection strides from a zero forward on the CPU (the model is
        still there when this runs)."""
        out = self(torch.zeros(1, self.ch, imgsz, imgsz))
        return tuple(imgsz // bm.shape[2] for bm, _ in out)

    def predictions(self, x: torch.Tensor) -> torch.Tensor:
        """Eval forward on NHWC images -> decoded (B, N, 4 + nc) candidates
        (pixel xywh + sigmoid scores)."""
        raw = self(x.permute(0, 3, 1, 2))
        return H.decode_detections(raw, self.strides, self.nc, self.reg_max)

    def loss(self, batch: dict):
        """Forward on ``batch["img"]`` (B, H, W, 3) float images plus the v8
        detection loss against ``batch["cls_boxes"]`` (B, n_max, 5) = (cls,
        x1, y1, x2, y2) pixels and ``batch["mask"]`` (B, n_max). The forward
        runs in the module's mode: in train mode (``model.train()``, as the
        trainer sets it) BatchNorm uses the batch statistics and updates its
        running ones. Returns (total, {"box", "cls", "dfl"})."""
        raw = self(batch["img"].permute(0, 3, 1, 2))
        lo = detection_loss(raw, batch["cls_boxes"], batch["mask"], self.strides, self.reg_max)
        return lo.total, {"box": lo.box, "cls": lo.cls, "dfl": lo.dfl}

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
