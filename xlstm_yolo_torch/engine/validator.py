"""Validator: mAP of a detection model over a dataset's val split.

Port of the detect path of ``Validator`` in
``xlstm_yolo_tpu/engine/validator.py``: on the device, the eval forward,
the DFL decode and the fixed-shape multi-label NMS (conf 0.001, IoU 0.7,
300 detections, a 1,024-candidate pool); on the host, the greedy IoU
matching at ten thresholds and the 101-point AP (``utils.metrics``). The
batches ship uint8 and are normalized on the device. fp32 by default, as
the reference's ``half: False``; ``half=True`` validates a bf16 copy of the
model (``nn.fuse.cast_params``, as the port's ``Predictor``). Not ported:
``save_json``, plots and rect batches.
"""
from __future__ import annotations

import copy
import time
from pathlib import Path

import numpy as np
import torch

from ..data.dataset import build_dataloader, check_det_dataset
from ..nn.fuse import cast_params
from ..ops.nms import non_max_suppression
from ..utils import metrics as MET
from ..utils.callbacks import default_callbacks


class Validator:
    """``Validator(model, data=...)()`` -> {precision, recall, mAP50,
    mAP50-95, fitness, images, img_s}; runs on the model's device."""

    def __init__(self, model, data=None, imgsz: int = 640, conf: float = 0.001,
                 iou: float = 0.7, max_det: int = 300, max_labels: int = 128,
                 batch: int = 16, verbose: bool = False, callbacks=None,
                 half: bool = False, pre_topk: int = 1024):
        self.callbacks = callbacks if callbacks is not None else default_callbacks()
        self.model = model
        self.half = half
        self.data = data
        self.imgsz, self.conf, self.iou, self.max_det = imgsz, conf, iou, max_det
        self.max_labels, self.batch, self.pre_topk = max_labels, batch, pre_topk
        self.verbose = verbose

    @torch.inference_mode()
    def __call__(self, data: str | dict | None = None) -> dict:
        self.callbacks.run("on_val_start", self)
        data = data or self.data
        if isinstance(data, (str, Path)):
            data = check_det_dataset(data)
        loader, _ = build_dataloader(data, "val", batch=self.batch, imgsz=self.imgsz,
                                     augment=False, max_labels=self.max_labels)
        loader.ds.uint8_images = True
        model = self.model.eval()
        dtype = torch.bfloat16 if self.half else torch.float32
        if self.half:
            model = cast_params(copy.deepcopy(model), torch.bfloat16)
        device = next(model.parameters()).device
        stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        n_img = 0
        t0 = time.time()
        for batch in loader:
            self.callbacks.run("on_val_batch_start", self)
            img = torch.from_numpy(batch["img"]).to(device)
            x = (img.float() / 255.0).to(dtype)
            dets, valid = non_max_suppression(
                model.predictions(x).float(), conf_thres=self.conf, iou_thres=self.iou,
                max_det=self.max_det, multi_label=True, pre_topk=self.pre_topk)
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            n_img += len(dets)
            for bi in range(len(dets)):
                d = dets[bi][valid[bi]]  # (n, 6) xyxy conf cls
                gt = batch["cls_boxes"][bi][batch["mask"][bi]]  # (m, 5) cls xyxy
                gt_cls = gt[:, 0]
                if len(d) == 0:
                    if len(gt):
                        stats["target_cls"].append(gt_cls)
                    continue
                iou = MET.box_iou_np(gt[:, 1:5], d[:, :4]) if len(gt) else np.zeros((0, len(d)))
                stats["tp"].append(MET.match_predictions(d[:, 5], gt_cls, iou))
                stats["conf"].append(d[:, 4])
                stats["pred_cls"].append(d[:, 5])
                stats["target_cls"].append(gt_cls)
            self.callbacks.run("on_val_batch_end", self)
        dt = time.time() - t0
        if not stats["tp"]:
            self.callbacks.run("on_val_end", self)
            return {"mAP50": 0.0, "mAP50-95": 0.0, "precision": 0.0, "recall": 0.0,
                    "fitness": 0.0, "images": n_img, "img_s": round(n_img / dt, 1)}
        r = MET.ap_per_class(np.concatenate(stats["tp"]), np.concatenate(stats["conf"]),
                             np.concatenate(stats["pred_cls"]),
                             np.concatenate(stats["target_cls"]))
        out = {"precision": r["mp"], "recall": r["mr"], "mAP50": r["map50"], "mAP50-95": r["map"],
               "fitness": MET.fitness(r["map50"], r["map"]),
               "images": n_img, "img_s": round(n_img / dt, 1)}
        if self.verbose:
            names = getattr(self.model, "names", {}) or {}
            for ci, c in enumerate(r["unique_classes"]):
                print(f"  {names.get(int(c), c):>12}: n={r['nt'][ci]} P={r['p'][ci]:.3f} "
                      f"R={r['r'][ci]:.3f} AP50={r['ap50'][ci]:.3f} AP={r['ap'][ci].mean():.3f}")
        self.callbacks.run("on_val_end", self)
        return out
