"""PyTorch/CUDA port of the xlstm_yolo detection framework.

The package mirrors the JAX package's module paths; importing it pulls in
nothing heavier than torch, numpy and yaml. Entry points run on the GPU
(``device="cuda"``) unless the caller asks for the CPU:

    from xlstm_yolo_torch import YOLO
    model = YOLO("vil_yolon.yaml")
    model.train(data="data.yaml", epochs=2, imgsz=640, batch=8)
    model.val(data="data.yaml")
    results = model.predict("images/")
"""
from .engine.model import YOLO, Model  # noqa: F401
