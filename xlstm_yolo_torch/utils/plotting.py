"""The plots of a detect run: the validation's PR / F1 / P / R curves and
confusion matrix, and the training curves and label statistics, each
written as a PNG through matplotlib's Agg backend.

Port of ``smooth``, ``plot_pr_curve``, ``plot_mc_curve``,
``plot_confusion_matrix``, ``plot_results`` and ``plot_labels`` in
``xlstm_yolo_tpu/utils/plotting.py`` (``plot_images`` and
``feature_visualization`` draw through OpenCV there and are not ported).
matplotlib is imported when a plot is drawn, not with this module: a
machine without it can still import, train and validate. There
``have_matplotlib()`` is False and each plot function raises ImportError;
the ``Validator`` checks first and prints one warning that names the files
it did not write.
"""
from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _pyplot(fname):
    """matplotlib.pyplot on the Agg backend; ImportError naming ``fname``
    where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError:
        raise ImportError(f"writing {fname} needs matplotlib, which is not installed") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, plt, fname, **kw) -> Path:
    fname = Path(fname)
    fname.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(fname, dpi=120, **kw)
    plt.close(fig)
    return fname


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box filter over a fraction ``f`` of the points, the ends padded with
    the end values (the reference's ``smooth``)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def plot_pr_curve(px: np.ndarray, py: np.ndarray, ap: np.ndarray, names: dict | None = None,
                  fname: str | Path = "PR_curve.png") -> Path:
    """Per-class precision-recall curves (py (nc, n) over recall px) and
    their mean, labelled with each class's AP50."""
    plt = _pyplot(fname)
    fig, ax = plt.subplots(figsize=(6, 5))
    for i in range(py.shape[0]):
        label = (names or {}).get(i, str(i))
        ax.plot(px, py[i], label=f"{label} {ap[i]:.3f}", linewidth=1)
    ax.plot(px, py.mean(0), color="black", linewidth=2,
            label=f"all classes {ap.mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(fontsize=7)
    return _save(fig, plt, fname, bbox_inches="tight")


def plot_mc_curve(px: np.ndarray, py: np.ndarray, fname: str | Path = "mc_curve.png",
                  names: dict | None = None, xlabel: str = "Confidence",
                  ylabel: str = "Metric") -> Path:
    """A metric against confidence (the F1 / P / R_curve.png family): py
    (nc, n) per class over px, and their mean smoothed, its best point in
    the legend."""
    plt = _pyplot(fname)
    fig, ax = plt.subplots(figsize=(6, 5))
    if 0 < py.shape[0] < 21:
        for i in range(py.shape[0]):
            ax.plot(px, py[i], linewidth=1, label=(names or {}).get(i, str(i)))
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = smooth(py.mean(0), 0.05) if py.shape[0] else np.zeros_like(px)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(fontsize=7)
    ax.set_title(f"{ylabel}-Confidence Curve")
    return _save(fig, plt, fname, bbox_inches="tight")


def plot_confusion_matrix(matrix: np.ndarray, names: dict | None = None,
                          fname: str | Path = "confusion_matrix.png", normalize: bool = True,
                          background: bool = True) -> Path:
    """The confusion matrix as a heatmap (predicted rows, true columns),
    each column normalized to sum 1 with ``normalize``; ``background``
    labels the last row and column."""
    plt = _pyplot(fname)
    m = matrix.astype(np.float64)
    if normalize:
        m = m / np.clip(m.sum(0, keepdims=True), 1, None)
    nc = m.shape[0] - (1 if background else 0)
    labels = [(names or {}).get(i, str(i)) for i in range(nc)] + (
        ["background"] if background else [])
    fig, ax = plt.subplots(figsize=(max(5, nc * 0.6), max(4, nc * 0.5)))
    im = ax.imshow(m, cmap="Blues", vmin=0)
    ax.set_xticks(range(len(labels)))
    ax.set_yticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=90, fontsize=7)
    ax.set_yticklabels(labels, fontsize=7)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    fig.colorbar(im)
    return _save(fig, plt, fname, bbox_inches="tight")


def _is_num(v) -> bool:
    try:
        float(v)
    except (TypeError, ValueError):
        return False
    return True


def plot_results(csv_file: str | Path, fname: str | Path | None = None) -> Path:
    """One panel per numeric column of a trainer's ``results.csv`` against
    the epoch; ``results.png`` beside it by default."""
    csv_file = Path(csv_file)
    fname = Path(fname or csv_file.with_name("results.png"))
    with open(csv_file) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"empty csv {csv_file}")
    plt = _pyplot(fname)
    keys = [k for k in rows[0] if k != "epoch" and _is_num(rows[0][k])]
    n = len(keys)
    cols = min(4, n)
    r = int(np.ceil(n / cols))
    fig, axes = plt.subplots(r, cols, figsize=(4 * cols, 3 * r), squeeze=False)
    epochs = [int(float(row["epoch"])) for row in rows]
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        ax.plot(epochs, [float(row[k] or 0) for row in rows], marker=".")
        ax.set_title(k, fontsize=9)
    for j in range(n, r * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    return _save(fig, plt, fname)


def plot_labels(cls: np.ndarray, boxes_xywhn: np.ndarray, names: dict | None = None,
                fname: str | Path = "labels.png") -> Path:
    """Label statistics: the class histogram, the boxes' centres and their
    sizes (normalized xywh)."""
    plt = _pyplot(fname)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    axes[0].hist(cls, bins=max(int(cls.max()) + 1 if len(cls) else 1, 1))
    axes[0].set_title("classes")
    if len(boxes_xywhn):
        axes[1].scatter(boxes_xywhn[:, 0], boxes_xywhn[:, 1], s=3, alpha=0.5)
        axes[1].set_title("centers (x, y)")
        axes[2].scatter(boxes_xywhn[:, 2], boxes_xywhn[:, 3], s=3, alpha=0.5)
        axes[2].set_title("sizes (w, h)")
    for ax in axes[1:]:
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
    return _save(fig, plt, fname, bbox_inches="tight")
