"""The v8 detection loss on padded ground truth, the segment, pose and OBB
losses built on it, the classification loss and the language-model loss.

Port of ``_bce_logits``, ``df_loss``, ``detection_loss``, ``_detection_core``,
``segmentation_loss``, ``OKS_SIGMA``, ``pose_loss``, ``obb_loss`` and
``classification_loss`` in ``xlstm_yolo_tpu/utils/loss.py``. Detection: TAL assignment, BCE on the class logits,
CIoU on the boxes and the distribution focal loss, with gains box 7.5, cls
0.5 and dfl 1.5, the total scaled by the batch size. Labels arrive as
(B, n_max, 5) = (cls, x1, y1, x2, y2) in pixels with a (B, n_max) validity
mask. The segmentation loss is the JAX package's static-shape form: the
masks of the ``mask_topk`` (32) anchors of highest assigned weight per
image (``select_mask_anchors``), not of every foreground anchor. The OBB
loss assigns with ``tal.assign_rotated`` on (B, n_max, 6) = (cls, cx, cy,
w, h, angle) labels and scores its boxes by ``probiou``. ``lm_loss`` is the mean token cross-entropy the JAX package's language
model tests train with (``optax.softmax_cross_entropy_with_integer_labels``
averaged over batch and positions).

Under a data-parallel group (``parallel.distributed.data_parallel``) every
batch-wide normalizer is the global batch's: the target-score sum ``tss``,
the batch size the total is scaled by, the count of selected mask anchors,
the foreground count of the pose terms and the classify batch; a rank's
loss and terms are then its share of the one-process loss on the global
batch, and the shares sum to it.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import math

import numpy as np
import torch

from ..nn.heads import flatten_maps, split_maps
from ..ops.anchors import bbox2dist, dfl_decode, dist2bbox, dist2rbox, make_anchors
from ..ops.boxes import bbox_iou, probiou
from ..ops.nms import _topk
from ..parallel.distributed import dp_group, dp_total
from . import at_least_fp32, tal

BOX_GAIN, CLS_GAIN, DFL_GAIN = 7.5, 0.5, 1.5


def _global_batch(b: int, like: torch.Tensor):
    """The batch size the total is scaled by: ``b``, or under a
    data-parallel group the sum of the ranks' batches."""
    if dp_group() is None:
        return b
    return dp_total(torch.tensor(float(b), dtype=like.dtype, device=like.device))


class DetectionLossOut(NamedTuple):
    total: torch.Tensor
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in the stable form."""
    logits, targets = at_least_fp32(logits), at_least_fp32(targets)
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def df_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution focal loss: raw logits (..., 4*reg_max) and continuous
    targets (..., 4) in [0, reg_max - 1) -> (...), the mean over the four
    sides of the cross-entropy against the two bins around the target,
    weighted by the hat function max(0, 1 - |bin - t|). fp32 inside; bf16
    logits take the JAX bf16 path (``utils/loss.py:df_loss``): with c the
    row's max over all 4*reg_max logits, exp(x - c) and w (x - c) are
    rounded to bf16 before their per-side sums, which accumulate in fp32."""
    bins = torch.arange(reg_max, dtype=torch.float32, device=pred_dist.device)
    w = (1.0 - (bins - target.float()[..., None]).abs()).clamp(min=0.0)
    if pred_dist.dtype == torch.bfloat16:
        x = pred_dist.float()
        xc = (x - x.amax(-1, keepdim=True)).unflatten(-1, (4, reg_max))
        lse = torch.exp(xc).bfloat16().float().sum(-1).log()
        return (lse - (w * xc).bfloat16().float().sum(-1)).mean(-1)
    logp = at_least_fp32(pred_dist).unflatten(-1, (4, reg_max)).log_softmax(-1)
    return -(w * logp).sum(-1).mean(-1)


def _detection_core(raw_maps: Sequence, targets: torch.Tensor, target_mask: torch.Tensor,
                    strides: Sequence[float], reg_max: int = 16, tal_topk: int = tal.TOPK) -> dict:
    """TAL assignment and the unweighted cls / box / dfl terms that every
    task loss shares, plus the pieces the task losses build on (the
    assignment, the anchors, the target-score sum)."""
    feat_shapes = [tuple(bm.shape[2:4]) for bm, _ in raw_maps]
    dev = raw_maps[0][0].device
    anchors, stride_t = make_anchors(feat_shapes, strides, device=dev)
    pred_dist_logits, pred_scores_logits = split_maps(raw_maps, reg_max)
    pred_bboxes = dist2bbox(dfl_decode(pred_dist_logits, reg_max), anchors, xywh=False)

    _, target_bboxes, target_scores, fg_mask, target_gt_idx = tal.assign(
        pred_scores_logits, pred_bboxes * stride_t, anchors * stride_t, targets[..., :1],
        targets[..., 1:5], target_mask[..., None], topk=tal_topk)
    tss = dp_total(target_scores.sum()).clamp(min=1.0)
    loss_cls = _bce_logits(pred_scores_logits, target_scores).sum() / tss
    target_bboxes_g = target_bboxes / stride_t
    weight = target_scores.sum(-1) * fg_mask.float()
    iou = bbox_iou(pred_bboxes, target_bboxes_g)
    loss_box = ((1.0 - iou) * weight).sum() / tss
    dfl = df_loss(pred_dist_logits, bbox2dist(anchors, target_bboxes_g, reg_max - 1), reg_max)
    loss_dfl = (dfl * weight).sum() / tss
    return {"loss_cls": loss_cls, "loss_box": loss_box, "loss_dfl": loss_dfl, "fg_mask": fg_mask,
            "target_gt_idx": target_gt_idx, "target_bboxes": target_bboxes,
            "target_scores": target_scores, "anchors": anchors, "stride_t": stride_t}


def detection_loss(raw_maps: Sequence, targets: torch.Tensor, target_mask: torch.Tensor,
                   strides: Sequence[float], reg_max: int = 16,
                   gains: Sequence[float] = (BOX_GAIN, CLS_GAIN, DFL_GAIN),
                   tal_topk: int = tal.TOPK) -> DetectionLossOut:
    """v8 detection loss over the Detect head's per-scale (box, cls) maps
    (NCHW): BCE cls + CIoU box + DFL, TAL-assigned in pixel units (each
    ground truth's ``tal_topk`` best anchors; YOLOv10's one2one branch takes
    1), weighted by ``gains`` (box, cls, dfl; the ``box`` / ``cls`` /
    ``dfl`` keys). The
    maps may be bf16 (the AMP step); the loss and the assigner compute in
    fp32 (in fp64 for fp64 maps), the DFL decode and loss take their bf16
    paths."""
    core = _detection_core(raw_maps, targets, target_mask, strides, reg_max, tal_topk)
    box, cls, dfl_l = (core["loss_box"] * gains[0], core["loss_cls"] * gains[1],
                       core["loss_dfl"] * gains[2])
    b = _global_batch(raw_maps[0][0].shape[0], box)
    return DetectionLossOut(total=(box + cls + dfl_l) * b, box=box, cls=cls, dfl=dfl_l)


class SegmentationLossOut(NamedTuple):
    total: torch.Tensor
    box: torch.Tensor
    seg: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def select_mask_anchors(weight: torch.Tensor, k: int):
    """The ``k`` anchors of largest assigned weight (B, N) per image, best
    first, ties to the lower index (``jax.lax.top_k``): (weights,
    indices)."""
    return _topk(weight, k)


def segmentation_loss(out: dict, batch: dict, strides: Sequence[float], reg_max: int = 16,
                      gains: Sequence[float] = (BOX_GAIN, CLS_GAIN, DFL_GAIN),
                      mask_topk: int = 32) -> SegmentationLossOut:
    """Detection loss + the prototype masks' BCE. ``out`` is the Segment
    head's dict (``proto`` (B, nm, Hm, Wm)), ``batch["masks"]`` (B, Hm, Wm)
    the overlap-encoded ground truth (0 background, slot + 1 per pixel).
    The masks of each image's ``mask_topk`` anchors of largest assigned
    weight (``select_mask_anchors``; foreground ones count) are cropped to
    their ground-truth box at mask resolution, their mean BCE divided by
    the box's normalized area; the seg term takes the box gain."""
    core = _detection_core(out["det"], batch["cls_boxes"], batch["mask"], strides, reg_max)
    proto = at_least_fp32(out["proto"])
    b, nm, hm, wm = proto.shape
    coefs = at_least_fp32(flatten_maps(out["coefs"]))  # (B, N, nm)
    fg = core["fg_mask"].to(proto.dtype)
    weight_all = core["target_scores"].sum(-1) * fg
    top_w, top_idx = select_mask_anchors(weight_all, min(mask_topk, weight_all.shape[1]))
    sel_valid = (fg.gather(1, top_idx) > 0) & (top_w > 0)
    sel_coefs = coefs.gather(1, top_idx[..., None].expand(-1, -1, nm))
    sel_gt_idx = core["target_gt_idx"].gather(1, top_idx)
    sel_boxes = core["target_bboxes"].gather(1, top_idx[..., None].expand(-1, -1, 4))

    pred_masks = torch.einsum("bkn,bnhw->bkhw", sel_coefs, proto)
    gt_masks = (batch["masks"][:, None] == (sel_gt_idx + 1)[..., None, None]).to(proto.dtype)
    bm = out["det"][0][0]
    sx, sy = wm / (bm.shape[3] * strides[0]), hm / (bm.shape[2] * strides[0])
    mx1, my1 = sel_boxes[..., 0] * sx, sel_boxes[..., 1] * sy
    mx2, my2 = sel_boxes[..., 2] * sx, sel_boxes[..., 3] * sy
    gx = torch.arange(wm, dtype=proto.dtype, device=proto.device)
    gy = torch.arange(hm, dtype=proto.dtype, device=proto.device)[:, None]
    e = lambda t: t[..., None, None]
    in_box = ((gx >= e(mx1)) & (gx < e(mx2)) & (gy >= e(my1)) & (gy < e(my2))).to(proto.dtype)
    bce = _bce_logits(pred_masks, gt_masks) * in_box
    area = ((mx2 - mx1) * (my2 - my1) / (wm * hm)).clamp(min=1e-4)
    per_anchor = bce.mean((2, 3)) / area
    loss_seg = (per_anchor * sel_valid).sum() / dp_total(sel_valid.sum()).clamp(min=1)

    box, cls, dfl_l = (core["loss_box"] * gains[0], core["loss_cls"] * gains[1],
                       core["loss_dfl"] * gains[2])
    seg = loss_seg * gains[0]
    return SegmentationLossOut((box + seg + cls + dfl_l) * _global_batch(b, box), box, seg, cls,
                               dfl_l)


# COCO's 17 keypoint sigmas; other keypoint counts take 1 / nk each
OKS_SIGMA = np.array([26, 25, 25, 35, 35, 79, 79, 72, 72, 62, 62, 107, 107, 87, 87, 89, 89]) / 1000.0


class PoseLossOut(NamedTuple):
    total: torch.Tensor
    box: torch.Tensor
    pose: torch.Tensor
    kobj: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def pose_loss(out: dict, batch: dict, strides: Sequence[float], kpt_shape: tuple = (17, 3),
              reg_max: int = 16, gains: Sequence[float] = (BOX_GAIN, CLS_GAIN, DFL_GAIN),
              pose_gain: float = 12.0, kobj_gain: float = 1.0) -> PoseLossOut:
    """Detection loss + the keypoint losses. ``batch["keypoints"]`` (B,
    n_max, nk, 3) pixels + visibility. Each foreground anchor's keypoints
    are decoded to pixels and held to its ground truth's: 1 - exp(-OKS
    error) over the visible points (``OKS_SIGMA`` at 17 points, 1 / nk
    otherwise), and with visibility channels the BCE of their logits
    against the visibility."""
    core = _detection_core(out["det"], batch["cls_boxes"], batch["mask"], strides, reg_max)
    nk, nd = kpt_shape
    kmaps = at_least_fp32(flatten_maps(out["kpts"]))
    b, n = kmaps.shape[:2]
    pk = kmaps.reshape(b, n, nk, nd)
    anchors, stride_t = core["anchors"], core["stride_t"]
    xy = (pk[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * stride_t[None, :, None, :]

    gt_k = at_least_fp32(batch["keypoints"]).to(kmaps.dtype)
    idx = core["target_gt_idx"][..., None, None].expand(-1, -1, *gt_k.shape[2:])
    sel_k = gt_k.gather(1, idx)  # (B, N, nk, 3)
    vis = ((sel_k[..., 2] > 0).to(kmaps.dtype) if nd == 3 and gt_k.shape[-1] > 2
           else torch.ones(sel_k.shape[:-1], dtype=kmaps.dtype, device=kmaps.device))
    fg = core["fg_mask"].to(kmaps.dtype)
    tb = core["target_bboxes"]
    area = ((tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1])).clamp(min=1e-9)[..., None]
    sigmas = torch.as_tensor(OKS_SIGMA if nk == 17 else np.ones(nk) / nk, dtype=kmaps.dtype,
                             device=kmaps.device)
    d2 = ((xy - sel_k[..., :2]) ** 2).sum(-1)
    err = d2 / (2 * sigmas) ** 2 / (area + 1e-9) / 2.0
    kpt_mask = vis * fg[..., None]
    factor = nk / (kpt_mask.sum(-1, keepdim=True) + 1e-9)
    fg_total = dp_total(fg.sum())
    loss_pose = (factor * (1 - torch.exp(-err)) * kpt_mask).sum() / fg_total.clamp(min=1.0)
    if nd == 3:
        loss_kobj = (_bce_logits(pk[..., 2], vis) * fg[..., None]).sum() / (fg_total * nk).clamp(
            min=1.0)
    else:
        loss_kobj = torch.zeros((), dtype=kmaps.dtype, device=kmaps.device)

    box, cls, dfl_l = (core["loss_box"] * gains[0], core["loss_cls"] * gains[1],
                       core["loss_dfl"] * gains[2])
    pose, kobj = loss_pose * pose_gain, loss_kobj * kobj_gain
    return PoseLossOut((box + pose + kobj + cls + dfl_l) * _global_batch(b, box), box, pose, kobj,
                       cls, dfl_l)


def obb_loss(out: dict, batch: dict, strides: Sequence[float], reg_max: int = 16,
             gains: Sequence[float] = (BOX_GAIN, CLS_GAIN, DFL_GAIN)) -> DetectionLossOut:
    """The oriented-box loss: ``batch["cls_boxes"]`` (B, n_max, 6) = cls,
    cx, cy, w, h, angle in pixels; rotated TAL (``tal.assign_rotated``),
    BCE cls, 1 - probiou for the box, and the DFL on the axis-aligned box
    of the rotated target's (cx, cy, w, h)."""
    raw_maps = out["det"]
    b = raw_maps[0][0].shape[0]
    feat_shapes = [tuple(bm.shape[2:4]) for bm, _ in raw_maps]
    anchors, stride_t = make_anchors(feat_shapes, strides, device=raw_maps[0][0].device)
    pred_dist_logits, pred_scores_logits = split_maps(raw_maps, reg_max)
    pred_angle = (torch.sigmoid(at_least_fp32(flatten_maps(out["angle"]))) - 0.25) * math.pi
    pred_rbox = dist2rbox(dfl_decode(pred_dist_logits, reg_max), pred_angle, anchors)

    gt = batch["cls_boxes"]
    _, target_rbox, target_scores, fg_mask, _ = tal.assign_rotated(
        torch.sigmoid(at_least_fp32(pred_scores_logits)),
        torch.cat([pred_rbox * stride_t, pred_angle], -1), anchors * stride_t, gt[..., :1],
        gt[..., 1:6], batch["mask"][..., None])
    tss = dp_total(target_scores.sum()).clamp(min=1.0)
    loss_cls = _bce_logits(pred_scores_logits, target_scores).sum() / tss
    weight = target_scores.sum(-1) * fg_mask.float()
    t_scaled = torch.cat([target_rbox[..., :4] / stride_t, target_rbox[..., 4:5]], -1)
    iou = probiou(torch.cat([pred_rbox, pred_angle], -1), t_scaled)
    loss_box = ((1.0 - iou) * weight).sum() / tss
    txy, twh = t_scaled[..., :2], t_scaled[..., 2:4]
    t_xyxy = torch.cat([txy - twh / 2, txy + twh / 2], -1)
    dfl = df_loss(pred_dist_logits, bbox2dist(anchors, t_xyxy, reg_max - 1), reg_max)
    loss_dfl = (dfl * weight).sum() / tss

    box, cls, dfl_l = loss_box * gains[0], loss_cls * gains[1], loss_dfl * gains[2]
    return DetectionLossOut(total=(box + cls + dfl_l) * _global_batch(b, box), box=box, cls=cls,
                            dfl=dfl_l)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of (B, C) logits against (B,) integer labels, taken in
    fp32 (fp64 logits in fp64) and averaged over the batch (the global
    batch under a data-parallel group)."""
    logp = at_least_fp32(logits).log_softmax(-1)
    picked = logp.gather(-1, labels[:, None])
    if dp_group() is None:
        return -picked.mean()
    return -picked.sum() / _global_batch(picked.shape[0], picked)


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of (B, S, vocab) logits against (B, S) integer
    targets, taken in fp32 over every position. For next-token training the
    caller shifts: ``lm_loss(model(tokens[:, :-1]), tokens[:, 1:])``."""
    logp = logits.float().log_softmax(-1)
    return -logp.gather(-1, targets[..., None]).mean()
