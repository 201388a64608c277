"""Batched detection inference on the device.

Port of the device function of ``Predictor`` in
``xlstm_yolo_tpu/engine/predictor.py``, at the boundary the JAX ``bench.py``
times: uint8 NHWC frames -> ``letterbox_device`` -> forward -> DFL decode ->
fixed-shape NMS (pre_topk 512, bfloat16 score selection). The stages are
also callable one by one, for timing. Host-side results and source loaders
are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.letterbox import letterbox_device
from ..ops.nms import non_max_suppression


class Predictor:
    def __init__(self, model, imgsz: int = 640, conf: float = 0.25, iou: float = 0.7,
                 max_det: int = 300, pre_topk: int = 512):
        self.model = model
        self.imgsz = imgsz
        self.conf, self.iou, self.max_det, self.pre_topk = conf, iou, max_det, pre_topk
        self.device = next(model.parameters()).device

    def preprocess(self, frames) -> tuple[torch.Tensor, tuple]:
        """uint8 (B, H, W, 3) frames (numpy or tensor) -> letterboxed
        (B, imgsz, imgsz, 3) fp32 batch on the model's device, and its meta."""
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(frames)
        if frames.dtype != torch.uint8 or frames.ndim != 4:
            raise ValueError(f"expected uint8 (B, H, W, 3) frames, got {frames.dtype} "
                             f"{tuple(frames.shape)}")
        return letterbox_device(frames.to(self.device), imgsz=self.imgsz)

    def postprocess(self, cands: torch.Tensor):
        """(B, N, 4 + nc) candidates -> (dets (B, max_det, 6), valid)."""
        return non_max_suppression(cands, conf_thres=self.conf, iou_thres=self.iou,
                                   max_det=self.max_det, pre_topk=self.pre_topk,
                                   fast_sel=True)

    @torch.inference_mode()
    def __call__(self, frames):
        """Frames -> (dets, valid, cands, meta); dets boxes are xyxy in the
        letterboxed frame (``ops.boxes.scale_boxes`` maps them back)."""
        x, meta = self.preprocess(frames)
        cands = self.model.predictions(x)
        dets, valid = self.postprocess(cands)
        return dets, valid, cands, meta
