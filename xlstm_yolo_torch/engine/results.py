"""Prediction results of one image, in numpy.

Port of ``BaseNP``, ``Boxes`` and the detect part of ``Results`` in
``xlstm_yolo_tpu/engine/results.py`` (without ``plot`` and the other
tasks' containers): boxes in pixels of the original image, with their
confidence and class, and the summaries built on them.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..ops.boxes import xyxy2xywh


class BaseNP:
    """A numpy array ``data`` and the original image's (h, w); len, index
    and iteration give sliced copies."""

    def __init__(self, data: np.ndarray, orig_shape: tuple):
        self.data = np.asarray(data)
        self.orig_shape = tuple(orig_shape)

    @property
    def shape(self):
        return self.data.shape

    def numpy(self):
        return self

    def cpu(self):
        return self

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.__class__(self.data[idx], self.orig_shape)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class Boxes(BaseNP):
    """(n, 6) = x1, y1, x2, y2, conf, cls in pixels of the original image."""

    def __init__(self, data: np.ndarray, orig_shape: tuple):
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data.reshape(-1, data.shape[0] if data.size else 6)
        data = data.reshape(-1, data.shape[-1])
        if data.shape[-1] != 6:
            raise ValueError(f"expected 6 columns (x1, y1, x2, y2, conf, cls), got {data.shape}")
        super().__init__(data, orig_shape)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def xywh(self):
        return xyxy2xywh(self.data[:, :4])

    @property
    def xyxyn(self):
        h, w = self.orig_shape
        return self.data[:, :4] / np.asarray([w, h, w, h], np.float32)

    @property
    def xywhn(self):
        h, w = self.orig_shape
        return self.xywh / np.asarray([w, h, w, h], np.float32)


class Results:
    """One image's detections: the image, its path, the class names, the
    ``Boxes`` and the stage times in ms (``speed``)."""

    def __init__(self, orig_img: np.ndarray, path: str = "", names: dict | None = None,
                 boxes: np.ndarray | None = None, speed: dict | None = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names or {}
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.speed = speed or {}

    def __len__(self):
        return len(self.boxes) if self.boxes is not None else 0

    def __getitem__(self, idx):
        return self.new(boxes=self.boxes.data[idx] if self.boxes is not None else None)

    def update(self, boxes=None):
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)

    def new(self, **kw):
        """A new Results on the same image."""
        return Results(self.orig_img, path=self.path, names=self.names, speed=self.speed, **kw)

    def summary(self, normalize: bool = False, decimals: int = 5) -> list:
        """One dict per detection: name, class, confidence and the box corners
        (normalized by the image's size with ``normalize``)."""
        if self.boxes is None:
            return []
        h, w = self.orig_shape if normalize else (1, 1)
        out = []
        for i in range(len(self.boxes)):
            c = int(self.boxes.cls[i])
            box = {f"{axis}{j + 1}": round(float(v) / (w if axis == "x" else h), decimals)
                   for j, xy in enumerate(self.boxes.xyxy[i].reshape(2, 2))
                   for axis, v in zip("xy", xy)}
            out.append({"name": self.names.get(c, str(c)), "class": c,
                        "confidence": round(float(self.boxes.conf[i]), decimals), "box": box})
        return out

    def to_json(self, normalize: bool = False, decimals: int = 5) -> str:
        return json.dumps(self.summary(normalize=normalize, decimals=decimals), indent=2)

    def save_txt(self, txt_file: str, save_conf: bool = False):
        """YOLO-format lines: class and normalized (cx, cy, w, h), and the
        confidence with ``save_conf``."""
        lines = []
        if self.boxes is not None:
            for i in range(len(self.boxes)):
                coords = " ".join(f"{x:.6f}" for x in self.boxes.xywhn[i])
                line = f"{int(self.boxes.cls[i])} {coords}"
                if save_conf:
                    line += f" {self.boxes.conf[i]:.6f}"
                lines.append(line)
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_file).write_text("\n".join(lines) + ("\n" if lines else ""))

    def verbose(self) -> str:
        if self.boxes is None or len(self.boxes) == 0:
            return "(no detections)"
        counts = {}
        for c in self.boxes.cls.astype(int):
            counts[c] = counts.get(c, 0) + 1
        return ", ".join(f"{n} {self.names.get(c, c)}{'s' if n > 1 else ''}"
                         for c, n in sorted(counts.items()))
