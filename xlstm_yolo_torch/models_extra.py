"""FastSAM: a one-class YOLOv8-seg run as an "everything" segmenter, then
filtered on the host by a box, point or text prompt.

Port of ``FastSAM`` in ``xlstm_yolo_tpu/models_extra.py``. ``everything``
runs ``predictions_full`` on the device, the fixed-shape NMS with
``return_idx`` (each kept detection's source candidate, so that its mask
coefficients are its own even where same-class boxes overlap), and decodes
the kept masks on the host. The prompts are the JAX static methods on
numpy. The text prompt ranks instances by precomputed embeddings (of the
crops and of the text), as the JAX one does. The YOLO-World blocks are
re-exported from ``nn.world``, as the JAX module re-exports them.
"""
from __future__ import annotations

import numpy as np
import torch

from .nn.world import (  # noqa: F401
    C2fAttn, ContrastiveHead, MaxSigmoidAttnBlock, WorldDetect,
)

WorldDetectHead = WorldDetect  # the JAX name


class FastSAM:
    """``FastSAM(device="cuda").everything(img)``; ``model``: a one-class
    segment ``TaskModel`` (``yolov8s-seg.yaml`` with nc 1, weights from
    ``seed``, by default)."""

    def __init__(self, model=None, imgsz: int = 640, device: str | torch.device = "cuda",
                 seed: int = 0):
        from .nn.tasks import TaskModel

        self.model = model or TaskModel("yolov8s-seg.yaml", nc=1, device=device, seed=seed)
        self.imgsz = imgsz

    def everything(self, img: torch.Tensor, conf: float = 0.4, iou: float = 0.9,
                   max_det: int = 100):
        """NHWC float images (B, H, W, 3) in [0, 1] -> (dets (B, max_det, 6)
        xyxy, score, class; valid (B, max_det); masks (B, max_det, Hm, Wm)
        bool), numpy."""
        from .ops.nms import non_max_suppression

        dev = next(self.model.parameters()).device
        with torch.inference_mode():
            full = self.model.eval().predictions_full(torch.as_tensor(img).to(dev))
            dets, valid, src = non_max_suppression(full["cands"].float(), conf_thres=conf,
                                                   iou_thres=iou, max_det=max_det,
                                                   return_idx=True)
        dets_np, valid_np = dets.cpu().numpy(), valid.cpu().numpy()
        masks = self.masks_from_src(full["coefs"].float().cpu().numpy(),
                                    full["proto"].float().permute(0, 2, 3, 1).cpu().numpy(),
                                    valid_np, src.cpu().numpy())
        return dets_np, valid_np, masks

    @staticmethod
    def masks_from_src(coefs, proto, valid, src):
        """Binary masks of the NMS-kept detections from their source
        candidates' coefficients: coefs (B, N, nm), proto (B, Hm, Wm, nm)
        (the JAX layout), valid and src (B, max_det) -> (B, max_det, Hm, Wm)
        bool, sigmoid above 0.5."""
        masks = np.zeros((src.shape[0], src.shape[1], proto.shape[1], proto.shape[2]), bool)
        for bi in range(src.shape[0]):
            pm = proto[bi].reshape(-1, coefs.shape[-1]).T
            for di in range(src.shape[1]):
                if not valid[bi, di] or src[bi, di] < 0:
                    continue
                m = 1 / (1 + np.exp(-(coefs[bi, src[bi, di]] @ pm)))
                masks[bi, di] = (m > 0.5).reshape(proto.shape[1], proto.shape[2])
        return masks

    @staticmethod
    def box_prompt(dets, valid, masks, box, iou_thres: float = 0.5):
        """The instances whose box has an IoU above ``iou_thres`` with the
        prompt box."""
        from .utils.metrics import box_iou_np

        keep = []
        for di in range(len(dets)):
            if not valid[di]:
                continue
            iou = box_iou_np(np.asarray([box], np.float32), dets[di:di + 1, :4])[0, 0]
            if iou > iou_thres:
                keep.append(di)
        return keep

    @staticmethod
    def point_prompt(dets, valid, masks, points, labels=None, img_shape=None, mask_shape=None):
        """The instances whose mask holds a prompt point (labels: which
        points must be inside; a point counts only where it is inside)."""
        keep = []
        mh, mw = masks.shape[1:3]
        ih, iw = img_shape if img_shape else (mh, mw)
        for di in range(len(dets)):
            if not valid[di]:
                continue
            for pi, (px, py) in enumerate(points):
                inside = masks[di, int(py * mh / ih), int(px * mw / iw)]
                want = True if labels is None else bool(labels[pi])
                if inside == want and inside:
                    keep.append(di)
                    break
        return keep

    @staticmethod
    def text_prompt(crop_embeddings: np.ndarray, text_embedding: np.ndarray, topk: int = 1):
        """The ``topk`` instances by cosine similarity of their crop
        embeddings to the text embedding (norms clipped at 1e-7)."""
        c = crop_embeddings / np.clip(np.linalg.norm(crop_embeddings, axis=-1, keepdims=True),
                                      1e-7, None)
        t = text_embedding / np.clip(np.linalg.norm(text_embedding), 1e-7, None)
        return np.argsort(-(c @ t))[:topk].tolist()
