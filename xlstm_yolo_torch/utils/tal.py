"""Task-aligned assignment on padded ground truth, static shapes.

Port of ``select_candidates_in_gts``, ``topk_positive_mask``,
``select_highest_overlaps`` and ``assign`` in ``xlstm_yolo_tpu/utils/tal.py``
(the TaskAlignedAssigner, with the fork's alpha 0.5, beta 6.0 and top-k
10, on class logits). Ground truth arrives padded to (B, n_max, ...) with a
validity mask. Assignment carries no gradient: the predictions are
detached, as the reference does before every assigner call. Per-anchor ground-truth lookups are ``torch.gather``; the JAX
package's one-hot products were a TPU workaround and select the same values.
"""
from __future__ import annotations

import torch

from ..kernels.topk import rowwise_kth_value_plain
from ..ops.boxes import bbox_iou

TOPK = 10
EPS = 1e-9


def select_candidates_in_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor,
                             eps: float = 1e-9) -> torch.Tensor:
    """Anchors whose center lies inside each ground-truth box: centers
    (n_anchors, 2), boxes (B, n_max, 4) xyxy -> (B, n_max, n_anchors) bool."""
    lt, rb = gt_bboxes[..., None, :2], gt_bboxes[..., None, 2:]
    deltas = torch.cat([xy_centers - lt, rb - xy_centers], dim=-1)
    return deltas.amin(dim=-1) > eps


def topk_positive_mask(candidate_metric: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k membership over the last axis as a kth-value threshold
    (``kernels.topk.rowwise_kth_value_plain``: k-1 passes each suppress every
    entry equal to the row max): an entry is a member when it reaches the
    kth value and is positive. Ties at the kth value are all admitted; this
    is not ``torch.topk`` membership. The chain runs on every device, as in
    the JAX package, whose assigner does not call its kth-value kernel."""
    kth = rowwise_kth_value_plain(candidate_metric, k).clamp(min=0.0)
    return ((candidate_metric >= kth) & (candidate_metric > 0.0)).to(candidate_metric.dtype)


def select_highest_overlaps(mask_pos: torch.Tensor, overlaps: torch.Tensor, n_max_boxes: int):
    """Anchors matched to several ground truths keep the one of highest IoU
    (the first on ties). mask_pos, overlaps (B, n_max, n_anchors) ->
    (target_gt_idx (B, n_anchors), fg_mask (B, n_anchors), mask_pos)."""
    fg_count = mask_pos.sum(dim=-2)
    multi = fg_count > 1
    best_gt = torch.where(mask_pos > 0, overlaps, -1.0).argmax(dim=-2)
    onehot = torch.nn.functional.one_hot(best_gt, n_max_boxes).transpose(-1, -2).to(mask_pos.dtype)
    mask_pos = torch.where(multi[:, None, :], onehot * (fg_count[:, None, :] > 0), mask_pos)
    fg_mask = mask_pos.sum(dim=-2) > 0
    return mask_pos.argmax(dim=-2), fg_mask, mask_pos


@torch.no_grad()
def assign(pd_logits: torch.Tensor, pd_bboxes: torch.Tensor, anc_points: torch.Tensor,
           gt_labels: torch.Tensor, gt_bboxes: torch.Tensor, mask_gt: torch.Tensor):
    """Task-aligned one-stage assignment (the JAX ``assign`` with
    ``scores_are_logits=True``).

    pd_logits (B, n_anchors, nc) class logits, pd_bboxes (B, n_anchors, 4)
    xyxy, anc_points (n_anchors, 2), gt_labels (B, n_max, 1), gt_bboxes (B, n_max, 4) xyxy in
    the units of pd_bboxes, mask_gt (B, n_max, 1) valid slots. Returns
    target_labels (B, n_anchors) int64, target_bboxes (B, n_anchors, 4),
    target_scores (B, n_anchors, nc), fg_mask (B, n_anchors) bool and
    target_gt_idx (B, n_anchors)."""
    pd_logits, pd_bboxes = pd_logits.detach().float(), pd_bboxes.detach().float()
    n_anchors, nc = pd_logits.shape[1:]
    n_max = gt_bboxes.shape[1]
    mask_gt = mask_gt.float()[..., 0]  # (B, n_max)

    # alignment metric: sigmoid score at the gt's class ^ 0.5 * CIoU ^ 6, the
    # powers as sqrt and multiplies, as the JAX package rounds them
    gt_cls = gt_labels[..., 0].long().clamp(0, nc - 1)  # (B, n_max)
    bbox_scores = pd_logits.gather(2, gt_cls[:, None, :].expand(-1, n_anchors, -1))
    bbox_scores = bbox_scores.transpose(1, 2).sigmoid()
    overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :]).clamp(min=0.0)
    o2 = overlaps * overlaps
    align_metric = bbox_scores.clamp(min=EPS).sqrt() * (o2 * o2 * o2)  # (B, n_max, n_anchors)

    # candidates: inside the gt box, then top-k of the metric per gt
    mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes).float()
    candidate_metric = align_metric * mask_in_gts * mask_gt[..., None]
    mask_topk = topk_positive_mask(candidate_metric, min(TOPK, n_anchors))
    mask_pos = mask_topk * mask_in_gts * mask_gt[..., None]
    target_gt_idx, fg_mask, mask_pos = select_highest_overlaps(mask_pos, overlaps, n_max)

    # targets
    target_labels = gt_cls.gather(1, target_gt_idx)
    target_bboxes = gt_bboxes.float().gather(1, target_gt_idx[..., None].expand(-1, -1, 4))
    target_scores = torch.nn.functional.one_hot(target_labels, nc).float() * fg_mask[..., None]

    # normalize: per-gt max alignment scaled by the per-gt max IoU
    align_metric = align_metric * mask_pos
    pos_align_max = align_metric.amax(dim=-1, keepdim=True)
    pos_overlap_max = (overlaps * mask_pos).amax(dim=-1, keepdim=True)
    norm_align = align_metric * (pos_overlap_max / (pos_align_max + EPS))
    target_scores = target_scores * norm_align.amax(dim=-2)[..., None]
    return target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx
