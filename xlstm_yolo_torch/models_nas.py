"""YOLO-NAS: the s / m / l topology of ``cfg/models/yolo_nas.yaml``
(re-parameterizable RepConv stem and stages, C2f bodies, SPPF, a PAN neck
and the anchor-free Detect head), inference only.

Port of ``xlstm_yolo_tpu/models_nas.py``: ``NAS("yolo_nas_s.yaml")`` (or
``_m``, ``_l``) is ``yolo_nas.yaml`` at that scale; predict, val and the
rest go through the shared engine, and ``train`` raises, as the reference
has no NAS trainer. The JAX facade builds a YAML with a scale without
``Model.__init__``, so there its callbacks are missing and ``predict``,
``val`` and ``add_callback`` raise; the port builds through
``Model.__init__``, where all of them work.
"""
from __future__ import annotations

from .engine.model import Model


class NAS(Model):
    """Inference-only facade: ``NAS("yolo_nas_s.yaml").predict(img)``."""

    def __init__(self, model: str = "yolo_nas_s.yaml", **kw):
        name = str(model)
        for scale in ("s", "m", "l"):
            if name.endswith(f"yolo_nas_{scale}.yaml"):
                name = name.replace(f"yolo_nas_{scale}.yaml", "yolo_nas.yaml")
                kw.setdefault("scale", scale)
                break
        super().__init__(name, **kw)

    def train(self, *a, **kw):
        raise NotImplementedError("YOLO-NAS is inference-only (the reference has no NAS trainer)")
