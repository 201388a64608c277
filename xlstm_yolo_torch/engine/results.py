"""Prediction results of one image, in numpy.

Port of ``BaseNP``, ``Boxes``, ``Masks``, ``Keypoints``, ``Probs``, ``OBB``
and ``Results`` in ``xlstm_yolo_tpu/engine/results.py`` (without ``plot``):
boxes in pixels of the original image, with their
confidence and class, the segment task's masks, the pose task's keypoints,
the OBB task's rotated boxes, the classify task's probabilities (a
classify result has no boxes and a length of 0, as in JAX), and the
summaries built on them.
``Masks.xy`` / ``.xyn`` (polygons traced from the masks) are not ported.
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
    """(n, 6) = x1, y1, x2, y2, conf, cls in pixels of the original image,
    or (n, 7) with a track id before conf (``is_track``, ``id``); an empty
    (0, 7) keeps its 7 columns."""

    def __init__(self, data: np.ndarray, orig_shape: tuple):
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data.reshape(-1, data.shape[0] if data.size else 6)
        data = data.reshape(-1, data.shape[-1])
        if data.shape[-1] not in (6, 7):
            raise ValueError(f"expected 6 columns (x1, y1, x2, y2, conf, cls) or 7 (with a "
                             f"track id before conf), got {data.shape}")
        super().__init__(data, orig_shape)
        self.is_track = data.shape[-1] == 7

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
    def id(self):
        """The track ids of a 7-column form, else None."""
        return self.data[:, -3] if self.is_track else None

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


class Masks(BaseNP):
    """(n, h, w) boolean instance masks at the original image's size."""

    def __init__(self, masks, orig_shape):
        masks = np.asarray(masks)
        super().__init__(masks[None] if masks.ndim == 2 else masks, orig_shape)

    @property
    def xy(self):
        raise NotImplementedError("Masks.xy (polygons traced from the masks) is not ported")

    @property
    def xyn(self):
        raise NotImplementedError("Masks.xyn (polygons traced from the masks) is not ported")


class Keypoints(BaseNP):
    """(n, K, 2 or 3) keypoints in pixels of the original image; with a
    visibility column, points under 0.5 are zeroed, as the reference."""

    def __init__(self, keypoints, orig_shape):
        keypoints = np.asarray(keypoints, np.float32)
        if keypoints.ndim == 2:
            keypoints = keypoints[None]
        if keypoints.shape[-1] == 3:
            keypoints = keypoints.copy()
            keypoints[..., :2][keypoints[..., 2] < 0.5] = 0
        super().__init__(keypoints, orig_shape)
        self.has_visible = keypoints.shape[-1] == 3

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def xyn(self):
        h, w = self.orig_shape
        return self.xy / np.asarray([w, h], np.float32)

    @property
    def conf(self):
        return self.data[..., 2] if self.has_visible else None


class Probs(BaseNP):
    """(nc,) class probabilities, with the top-1 and top-5 classes and their
    probabilities."""

    def __init__(self, probs, orig_shape=None):
        super().__init__(np.asarray(probs, np.float32).reshape(-1), orig_shape or (0, 0))

    @property
    def top1(self) -> int:
        return int(self.data.argmax())

    @property
    def top5(self) -> list:
        return np.argsort(-self.data)[:5].tolist()

    @property
    def top1conf(self):
        return self.data[self.top1]

    @property
    def top5conf(self):
        return self.data[self.top5]


class OBB(BaseNP):
    """(n, 7) = cx, cy, w, h, angle (radians), conf, cls in pixels of the
    original image, or (n, 8) with a track id before conf (``is_track``,
    ``id``)."""

    def __init__(self, data, orig_shape):
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data.reshape(-1, data.shape[0] if data.size else 7)
        data = data.reshape(-1, data.shape[-1])
        if data.shape[-1] not in (7, 8):
            raise ValueError(f"expected 7 columns (cx, cy, w, h, angle, conf, cls) or 8 (with a "
                             f"track id before conf), got {data.shape}")
        super().__init__(data, orig_shape)
        self.is_track = data.shape[-1] == 8

    @property
    def xywhr(self):
        return self.data[:, :5]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def id(self):
        """The track ids of an 8-column form, else None."""
        return self.data[:, -3] if self.is_track else None

    @property
    def xyxyxyxy(self):
        """(n, 4, 2) corner points."""
        cx, cy, w, h, r = (self.data[:, i] for i in range(5))
        cos, sin = np.cos(r), np.sin(r)
        dx1, dy1 = w / 2 * cos, w / 2 * sin
        dx2, dy2 = -h / 2 * sin, h / 2 * cos
        return np.stack([np.stack([cx + dx1 + dx2, cy + dy1 + dy2], -1),
                         np.stack([cx + dx1 - dx2, cy + dy1 - dy2], -1),
                         np.stack([cx - dx1 - dx2, cy - dy1 - dy2], -1),
                         np.stack([cx - dx1 + dx2, cy - dy1 + dy2], -1)], 1).astype(np.float32)

    @property
    def xyxyxyxyn(self):
        h, w = self.orig_shape
        return self.xyxyxyxy / np.asarray([w, h], np.float32)

    @property
    def xyxy(self):
        """The axis-aligned boxes around the rotated ones."""
        p = self.xyxyxyxy
        return np.concatenate([p.min(1), p.max(1)], -1) if len(p) else np.zeros((0, 4), np.float32)


class Results:
    """One image's predictions: the image, its path, the class names, the
    ``Boxes`` and, by task, the ``Masks``, ``Keypoints``, ``OBB`` or
    ``Probs``, and the stage times in ms (``speed``)."""

    def __init__(self, orig_img: np.ndarray, path: str = "", names: dict | None = None,
                 boxes: np.ndarray | None = None, speed: dict | None = None,
                 masks: np.ndarray | None = None, keypoints: np.ndarray | None = None,
                 probs: np.ndarray | None = None, obb: np.ndarray | None = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names or {}
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.keypoints = (Keypoints(keypoints, self.orig_shape) if keypoints is not None
                          else None)
        self.probs = Probs(probs) if probs is not None else None
        self.obb = OBB(obb, self.orig_shape) if obb is not None else None
        self.speed = speed or {}

    def __len__(self):
        for v in (self.boxes, self.obb, self.masks, self.keypoints):
            if v is not None:
                return len(v)
        return 0

    def __getitem__(self, idx):
        return self.new(**{k: getattr(self, k).data[idx] for k in ("boxes", "masks",
                                                                   "keypoints", "obb")
                           if getattr(self, k) is not None})

    def update(self, boxes=None, masks=None, probs=None, obb=None, keypoints=None):
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)
        if masks is not None:
            self.masks = Masks(masks, self.orig_shape)
        if probs is not None:
            self.probs = Probs(probs)
        if keypoints is not None:
            self.keypoints = Keypoints(keypoints, self.orig_shape)
        if obb is not None:
            self.obb = OBB(obb, self.orig_shape)

    def new(self, **kw):
        """A new Results on the same image."""
        return Results(self.orig_img, path=self.path, names=self.names, speed=self.speed, **kw)

    def summary(self, normalize: bool = False, decimals: int = 5) -> list:
        """One dict per detection: name, class, confidence and the box corners
        (normalized by the image's size with ``normalize``); a classify
        result's one dict of its top-1 class."""
        if self.probs is not None:
            c = self.probs.top1
            return [{"name": self.names.get(c, str(c)), "class": c,
                     "confidence": round(float(self.probs.top1conf), decimals)}]
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
        if self.probs is not None:
            return ", ".join(f"{self.names.get(c, c)} {self.probs.data[c]:.2f}"
                             for c in self.probs.top5)
        if self.boxes is None or len(self.boxes) == 0:
            return "(no detections)"
        counts = {}
        for c in self.boxes.cls.astype(int):
            counts[c] = counts.get(c, 0) + 1
        return ", ".join(f"{n} {self.names.get(c, c)}{'s' if n > 1 else ''}"
                         for c, n in sorted(counts.items()))
