"""The v8 detection loss on padded ground truth, the classification loss and
the language-model loss.

Port of ``_bce_logits``, ``df_loss``, ``detection_loss`` and
``classification_loss`` in ``xlstm_yolo_tpu/utils/loss.py``. Detection: TAL assignment, BCE on the class logits,
CIoU on the boxes and the distribution focal loss, with gains box 7.5, cls
0.5 and dfl 1.5, the total scaled by the batch size. Labels arrive as
(B, n_max, 5) = (cls, x1, y1, x2, y2) in pixels with a (B, n_max) validity
mask. ``lm_loss`` is the mean token cross-entropy the JAX package's language
model tests train with (``optax.softmax_cross_entropy_with_integer_labels``
averaged over batch and positions).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..nn.heads import split_maps
from ..ops.anchors import bbox2dist, dfl_decode, dist2bbox, make_anchors
from ..ops.boxes import bbox_iou
from . import tal

BOX_GAIN, CLS_GAIN, DFL_GAIN = 7.5, 0.5, 1.5


class DetectionLossOut(NamedTuple):
    total: torch.Tensor
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in the stable form."""
    logits, targets = logits.float(), targets.float()
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
    logp = pred_dist.float().unflatten(-1, (4, reg_max)).log_softmax(-1)
    return -(w * logp).sum(-1).mean(-1)


def detection_loss(raw_maps: Sequence, targets: torch.Tensor, target_mask: torch.Tensor,
                   strides: Sequence[float], reg_max: int = 16) -> DetectionLossOut:
    """v8 detection loss over the Detect head's per-scale (box, cls) maps
    (NCHW): BCE cls + CIoU box + DFL, TAL-assigned in pixel units. The
    maps may be bf16 (the AMP step); the loss and the assigner compute in
    fp32, the DFL decode and loss take their bf16 paths."""
    b = raw_maps[0][0].shape[0]
    feat_shapes = [tuple(bm.shape[2:4]) for bm, _ in raw_maps]
    dev = raw_maps[0][0].device
    anchors, stride_t = make_anchors(feat_shapes, strides, device=dev)
    pred_dist_logits, pred_scores_logits = split_maps(raw_maps, reg_max)
    pred_bboxes = dist2bbox(dfl_decode(pred_dist_logits, reg_max), anchors, xywh=False)

    gt_labels, gt_bboxes = targets[..., :1], targets[..., 1:5]
    _, target_bboxes, target_scores, fg_mask, _ = tal.assign(
        pred_scores_logits, pred_bboxes * stride_t, anchors * stride_t, gt_labels, gt_bboxes,
        target_mask[..., None])
    target_scores_sum = target_scores.sum().clamp(min=1.0)

    loss_cls = _bce_logits(pred_scores_logits, target_scores).sum() / target_scores_sum
    target_bboxes_g = target_bboxes / stride_t
    weight = target_scores.sum(-1) * fg_mask.float()
    iou = bbox_iou(pred_bboxes, target_bboxes_g)
    loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum
    dfl = df_loss(pred_dist_logits, bbox2dist(anchors, target_bboxes_g, reg_max - 1), reg_max)
    loss_dfl = (dfl * weight).sum() / target_scores_sum

    box, cls, dfl_l = loss_box * BOX_GAIN, loss_cls * CLS_GAIN, loss_dfl * DFL_GAIN
    return DetectionLossOut(total=(box + cls + dfl_l) * b, box=box, cls=cls, dfl=dfl_l)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of (B, C) logits against (B,) integer labels, taken in
    fp32 and averaged over the batch."""
    logp = logits.float().log_softmax(-1)
    return -logp.gather(-1, labels[:, None]).mean()


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of (B, S, vocab) logits against (B, S) integer
    targets, taken in fp32 over every position. For next-token training the
    caller shifts: ``lm_loss(model(tokens[:, :-1]), tokens[:, 1:])``."""
    logp = logits.float().log_softmax(-1)
    return -logp.gather(-1, targets[..., None]).mean()
