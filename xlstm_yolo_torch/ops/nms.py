"""Fixed-shape, on-device NMS.

Port of ``non_max_suppression`` and ``nms_rotated`` in
``xlstm_yolo_tpu/ops/nms.py``: every
image yields exactly ``max_det`` slots plus a validity mask; empty slots
are zeros with class -1. Suppression is matrix "Fast-NMS" (keep i iff no
higher-scoring box overlaps it above the threshold) or, with
``exact=True``, greedy NMS. Top-k selections use a stable descending sort,
so equal scores keep the lower index first, as ``jax.lax.top_k`` does.
No torchvision.
"""
from __future__ import annotations

import torch

from .boxes import batch_probiou, box_iou, xywh2xyxy


def _topk(x: torch.Tensor, k: int):
    """Top-k along the last axis; ties resolved to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _suppress_fast(iou: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """(B, K, K) IoU of score-sorted boxes -> keep (B, K): no j < i with
    IoU > thresh."""
    upper = torch.ones(iou.shape[-2:], dtype=torch.bool, device=iou.device).triu(1)
    max_prev = torch.where(upper, iou, torch.zeros((), dtype=iou.dtype, device=iou.device))
    return max_prev.amax(dim=-2) <= iou_thres


def _suppress_exact(iou: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Greedy NMS over score-sorted candidates: i is dropped if a kept
    j < i overlaps it above the threshold."""
    k = iou.shape[-1]
    keep = torch.ones(iou.shape[:-1], dtype=torch.bool, device=iou.device)
    over = iou > iou_thres
    for i in range(1, k):
        keep[..., i] = ~(keep[..., :i] & over[..., :i, i]).any(dim=-1)
    return keep


def _gather_top(boxes, final_scores, cls, max_det: int, conf_thres: float, src):
    """Top-``max_det`` of (B, K) scores, zero-padded to ``max_det`` slots;
    ``boxes`` (B, K, D) of any width D."""
    b, n = final_scores.shape
    kk = min(max_det, n)
    nd = boxes.shape[-1]
    out_scores, out_idx = _topk(final_scores, kk)
    out_valid = out_scores > conf_thres
    out_boxes = torch.where(out_valid[..., None],
                            torch.gather(boxes, 1, out_idx[..., None].expand(b, kk, nd)), 0.0)
    out_cls = torch.where(out_valid, torch.gather(cls, 1, out_idx), -1.0)
    out_src = torch.where(out_valid, torch.gather(src, 1, out_idx), -1)
    dets = torch.cat([out_boxes, torch.where(out_valid, out_scores, 0.0)[..., None],
                      out_cls[..., None]], dim=-1)
    if kk < max_det:
        pad = max_det - kk
        pad_dets = torch.zeros((b, pad, nd + 2), dtype=dets.dtype, device=dets.device)
        pad_dets[..., -1] = -1.0
        dets = torch.cat([dets, pad_dets], dim=1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros((b, pad))], dim=1)
        out_src = torch.cat([out_src, out_src.new_full((b, pad), -1)], dim=1)
    return dets, out_valid, out_src


def non_max_suppression(prediction: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, max_det: int = 300, pre_topk: int = 1024,
                        multi_label: bool = False, exact: bool = False,
                        max_wh: float = 7680.0, class_agnostic: bool = False,
                        fast_sel: bool = False, return_idx: bool = False):
    """Batched fixed-shape NMS over (B, N, 4 + nc) xywh + sigmoid scores.

    ``multi_label`` ranks every (box, class) pair; ``fast_sel`` (the predict
    path) reduces the class scores in bfloat16 before ranking, as the JAX
    predict path does. Returns dets (B, max_det, 6) = (x1, y1, x2, y2, score,
    cls), valid (B, max_det) and, with ``return_idx``, the source candidate
    index of each slot (-1 where empty)."""
    b, n, no = prediction.shape
    nc = no - 4
    boxes_xywh = prediction[..., :4]
    scores_all = prediction[..., 4:]
    if multi_label:
        k = min(pre_topk, n * nc)
        scores, top_idx = _topk(scores_all.reshape(b, n * nc), k)
        box_idx = top_idx // nc
        cls = (top_idx % nc).to(torch.float32)
    else:
        if fast_sel:
            smax, cls_full = scores_all.to(torch.bfloat16).max(dim=-1)
            smax = smax.to(torch.float32)
        else:
            smax, cls_full = scores_all.max(dim=-1)
        k = min(pre_topk, n)
        scores, box_idx = _topk(smax, k)
        cls = torch.gather(cls_full, 1, box_idx).to(torch.float32)
    boxes = xywh2xyxy(torch.gather(boxes_xywh, 1, box_idx[..., None].expand(b, k, 4)))
    src = box_idx.to(torch.int32)
    valid = scores > conf_thres

    offset = torch.zeros_like(cls) if class_agnostic else cls * max_wh
    oboxes = boxes + offset[..., None]
    # invalid candidates collapse to one degenerate point: IoU 0 with all
    oboxes = torch.where(valid[..., None], oboxes, -2.0 * max_wh * float(nc))
    iou = box_iou(oboxes, oboxes)
    keep = (_suppress_exact if exact else _suppress_fast)(iou, iou_thres) & valid
    final_scores = torch.where(keep, scores, 0.0)
    dets, out_valid, out_src = _gather_top(boxes, final_scores, cls, max_det, conf_thres, src)
    if return_idx:
        return dets, out_valid, out_src
    return dets, out_valid


def nms_rotated(prediction: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
                max_det: int = 300, pre_topk: int = 1024):
    """Fixed-shape rotated-box NMS: (B, N, 5 + nc) = (cx, cy, w, h) + class
    scores + angle (``nn.heads.decode_obb``'s layout) -> dets (B, max_det,
    7) = (cx, cy, w, h, angle, score, cls) and valid (B, max_det). The
    argmax class of each candidate, its ``pre_topk`` best, matrix Fast-NMS
    on their pairwise ``probiou`` (the candidates under ``conf_thres``
    zeroed first), across classes, as the JAX function does."""
    b, n, no = prediction.shape
    nc = no - 5
    rboxes = torch.cat([prediction[..., :4], prediction[..., 4 + nc:]], dim=-1)
    smax, cls_full = prediction[..., 4:4 + nc].max(dim=-1)
    k = min(pre_topk, n)
    scores, idx = _topk(smax, k)
    boxes = torch.gather(rboxes, 1, idx[..., None].expand(b, k, 5))
    cls = torch.gather(cls_full, 1, idx).to(torch.float32)
    valid = scores > conf_thres
    masked = torch.where(valid[..., None], boxes, 0.0)
    keep = _suppress_fast(batch_probiou(masked, masked), iou_thres) & valid
    final_scores = torch.where(keep, scores, 0.0)
    dets, out_valid, _ = _gather_top(boxes, final_scores, cls, max_det, conf_thres,
                                     idx.to(torch.int32))
    return dets, out_valid
