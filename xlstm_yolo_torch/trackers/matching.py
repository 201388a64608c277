"""Costs between tracks and detections, and their gated assignment.

Port of ``xlstm_yolo_tpu/trackers/matching.py``: ``iou_distance`` (1 - IoU of
the boxes), ``embedding_distance`` (cosine, ReID features) and
``linear_assignment`` (scipy's Hungarian solver on costs gated at a
threshold).
"""
from __future__ import annotations

import numpy as np


def iou_distance(atracks: list, btracks: list) -> np.ndarray:
    """1 - IoU cost matrix between two track lists."""
    if len(atracks) == 0 or len(btracks) == 0:
        return np.zeros((len(atracks), len(btracks)), np.float32)
    a = np.stack([t.xyxy for t in atracks])
    b = np.stack([t.xyxy for t in btracks])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iou = inter / np.clip(area_a[:, None] + area_b[None] - inter, 1e-7, None)
    return (1.0 - iou).astype(np.float32)


def embedding_distance(tracks: list, detections: list) -> np.ndarray:
    """Cosine cost between the tracks' smoothed and the detections' ReID features."""
    if len(tracks) == 0 or len(detections) == 0:
        return np.zeros((len(tracks), len(detections)), np.float32)
    t = np.stack([tr.smooth_feat for tr in tracks])
    d = np.stack([de.curr_feat for de in detections])
    t = t / np.clip(np.linalg.norm(t, axis=1, keepdims=True), 1e-7, None)
    d = d / np.clip(np.linalg.norm(d, axis=1, keepdims=True), 1e-7, None)
    return np.clip(1.0 - t @ d.T, 0.0, None).astype(np.float32)


def linear_assignment(cost: np.ndarray, thresh: float):
    """Hungarian assignment of ``cost`` with pairs above ``thresh`` left
    out -> (matches (m, 2), unmatched rows, unmatched columns)."""
    if cost.size == 0:
        return (np.empty((0, 2), int), tuple(range(cost.shape[0])), tuple(range(cost.shape[1])))
    from scipy.optimize import linear_sum_assignment

    gated = np.where(cost > thresh, thresh + 1e-4, cost)
    rows, cols = linear_sum_assignment(gated)
    matches = [(r, c) for r, c in zip(rows, cols) if cost[r, c] <= thresh]
    matched_a = {r for r, _ in matches}
    matched_b = {c for _, c in matches}
    unmatched_a = tuple(i for i in range(cost.shape[0]) if i not in matched_a)
    unmatched_b = tuple(i for i in range(cost.shape[1]) if i not in matched_b)
    return np.asarray(matches, int).reshape(-1, 2), unmatched_a, unmatched_b
