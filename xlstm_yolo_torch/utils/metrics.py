"""Detection metrics: COCO-style AP (101-point interpolation), the
confusion matrix and fitness, on the host in numpy.

A copy of ``box_iou_np``, ``match_predictions``, ``compute_ap``,
``ap_per_class``, ``fitness`` and ``ConfusionMatrix`` (without ``plot`` and
the oriented-box dispatch) of ``xlstm_yolo_tpu/utils/metrics.py``.
"""
from __future__ import annotations

import numpy as np

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz

IOUV = np.linspace(0.5, 0.95, 10)  # mAP50:95 thresholds


def box_iou_np(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU (M, 4) x (N, 4) xyxy -> (M, N)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None] - inter + eps)


def match_predictions(pred_cls: np.ndarray, true_cls: np.ndarray, iou: np.ndarray,
                      thresholds: np.ndarray = IOUV) -> np.ndarray:
    """Greedy unique matching at each IoU threshold (reference
    engine/validator.py:224-264 match_predictions).

    Args:
        pred_cls (P,), true_cls (T,), iou (T, P).
    Returns:
        tp: (P, len(thresholds)) bool.
    """
    tp = np.zeros((pred_cls.shape[0], thresholds.shape[0]), bool)
    if len(true_cls) == 0 or len(pred_cls) == 0:
        return tp
    correct_class = true_cls[:, None] == pred_cls[None, :]
    iou = np.where(correct_class, iou, 0.0)
    for ti, thr in enumerate(thresholds):
        matches = np.nonzero(iou >= thr)
        matches = np.stack(matches, 1)  # (n, 2) = (gt, pred)
        if matches.shape[0]:
            m_iou = iou[matches[:, 0], matches[:, 1]]
            order = m_iou.argsort()[::-1]
            matches = matches[order]
            # unique pred, then unique gt (greedy by IoU)
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            tp[matches[:, 1], ti] = True
    return tp


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> tuple:
    """AP via 101-point interpolation (reference utils/metrics.py:505)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, target_cls: np.ndarray,
                 eps: float = 1e-16) -> dict:
    """Per-class AP across IoU thresholds (reference utils/metrics.py:537).

    Args:
        tp (N, T) bool, conf (N,), pred_cls (N,), target_cls (M,).
    Returns:
        dict with p, r, ap (nc, T), f1, unique_classes, mp, mr, map50, map.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]
    T = tp.shape[1] if tp.ndim == 2 else 1
    ap = np.zeros((nc, T))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    px = np.linspace(0, 1, 1000)
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = nt[ci]
        n_p = int(i.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        r[ci] = np.interp(-px, -conf[i], recall[:, 0], left=0)
        p[ci] = np.interp(-px, -conf[i], precision[:, 0], left=1)
        for ti in range(T):
            ap[ci, ti], _, _ = compute_ap(recall[:, ti], precision[:, ti])
    f1 = 2 * p * r / (p + r + eps)
    i_best = f1.mean(0).argmax() if nc else 0
    # precision-at-recall curves on the px grid for PR plots (reference
    # prec_values, utils/metrics.py:616-618): envelope precision at IoU 0.5
    prec_values = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        if not i.any() or nt[ci] == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc[:, 0] / (nt[ci] + eps)
        precision = tpc[:, 0] / (tpc[:, 0] + fpc[:, 0])
        _, mpre, mrec = compute_ap(recall, precision)
        prec_values[ci] = np.interp(px, mrec[:-1], mpre[:-1])
    return {
        "unique_classes": unique_classes.astype(int),
        "nt": nt,
        "p": p[:, i_best] if nc else np.zeros(0),
        "r": r[:, i_best] if nc else np.zeros(0),
        "f1": f1[:, i_best] if nc else np.zeros(0),
        "ap": ap,
        "ap50": ap[:, 0] if T else np.zeros(0),
        "mp": float(p[:, i_best].mean()) if nc else 0.0,
        "mr": float(r[:, i_best].mean()) if nc else 0.0,
        "map50": float(ap[:, 0].mean()) if nc else 0.0,
        "map75": float(ap[:, min(5, T - 1)].mean()) if nc else 0.0,
        "map": float(ap.mean()) if nc else 0.0,
        # full confidence-sweep curves for plotting (reference p_curve/
        # r_curve/f1_curve/x returns, utils/metrics.py:632)
        "px": px,
        "p_curve": p,
        "r_curve": r,
        "f1_curve": f1,
        "prec_values": prec_values,
    }


def fitness(map50: float, map5095: float) -> float:
    """Weighted fitness (reference utils/metrics.py DetMetrics.fitness):
    0.1 * mAP50 + 0.9 * mAP50-95."""
    return 0.1 * map50 + 0.9 * map5095


class ConfusionMatrix:
    """Confusion matrix for detection and classification (reference
    utils/metrics.py:294): detection is (nc+1, nc+1) with a background
    row/col; classification is (nc, nc)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45,
                 task: str = "detect"):
        self.task = "classify" if task == "classify" else "detect"
        self.nc = nc
        # reference remaps the val-default 0.001 to 0.25 (utils/metrics.py:311)
        self.conf = 0.25 if conf in (None, 0.001) else conf
        self.iou_thres = iou_thres
        n = nc if self.task == "classify" else nc + 1
        self.matrix = np.zeros((n, n), int)

    def process_cls_preds(self, preds, targets):
        """Classification update (reference utils/metrics.py:314): preds =
        top-k class indices (N, k) or (N,); targets = (N,) true classes."""
        preds = np.asarray(preds)
        top1 = preds[:, 0] if preds.ndim == 2 else preds
        for p, t in zip(top1.astype(int), np.asarray(targets).astype(int)):
            self.matrix[p, t] += 1

    def process_batch(self, dets: np.ndarray, gt_boxes: np.ndarray, gt_cls: np.ndarray):
        """dets (N, 6) = xyxy, conf, cls; gt (M, 4) xyxy, gt_cls (M,)."""
        if dets is None or len(dets) == 0:
            for c in gt_cls.astype(int):
                self.matrix[self.nc, c] += 1
            return
        dets = dets[dets[:, 4] > self.conf]
        if len(gt_cls) == 0:
            for c in dets[:, 5].astype(int):
                self.matrix[c, self.nc] += 1
            return
        iou = box_iou_np(gt_boxes, dets[:, :4])
        matches = np.nonzero(iou > self.iou_thres)
        matches = np.stack(matches, 1)
        if matches.shape[0]:
            m_iou = iou[matches[:, 0], matches[:, 1]]
            matches = matches[m_iou.argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        matched_gt = set(matches[:, 0].tolist()) if matches.shape[0] else set()
        matched_det = set(matches[:, 1].tolist()) if matches.shape[0] else set()
        for gi, di in matches:
            self.matrix[int(dets[di, 5]), int(gt_cls[gi])] += 1
        for gi in range(len(gt_cls)):
            if gi not in matched_gt:
                self.matrix[self.nc, int(gt_cls[gi])] += 1
        for di in range(len(dets)):
            if di not in matched_det:
                self.matrix[int(dets[di, 5]), self.nc] += 1
