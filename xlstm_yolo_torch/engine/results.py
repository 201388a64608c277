"""Prediction results of one image, in numpy.

Port of ``BaseNP``, ``Boxes``, ``Masks``, ``Keypoints``, ``Probs``, ``OBB``
and ``Results`` in ``xlstm_yolo_tpu/engine/results.py``: boxes in pixels of
the original image, with their confidence and class, the segment task's
masks (``Masks.xy`` / ``.xyn``: the contour with the most points, traced by
``ops.contours`` as ``cv2.findContours`` traces it), the pose task's
keypoints, the OBB task's rotated boxes, the classify task's probabilities
(a classify result has no boxes and a length of 0, as in JAX); drawn by
``plot`` (``utils.annotator``), written by ``save`` / ``save_crop`` (JPEG
through ``data.imgproc.imwrite``, the bytes ``cv2.imwrite`` writes) and
``save_txt``, and serialized by ``summary``, ``to_json``, ``to_df``,
``to_csv``, ``to_xml`` and ``to_sql`` (pandas imported inside, as in JAX).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..data.imgproc import imwrite
from ..ops.boxes import xyxy2xywh
from ..ops.contours import masks2segments


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
    """(n, h, w) boolean instance masks; ``xy`` / ``xyn`` give per mask the
    (N, 2) polygon of its contour with the most points, scaled from mask
    space to the original image's pixels (or normalized by its size)."""

    def __init__(self, masks, orig_shape):
        masks = np.asarray(masks)
        super().__init__(masks[None] if masks.ndim == 2 else masks, orig_shape)

    def _segments(self, normalize: bool) -> list:
        mh, mw = self.data.shape[1:]
        oh, ow = self.orig_shape
        sx, sy = ow / mw, oh / mh
        out = []
        for seg in masks2segments(np.asarray(self.data, np.uint8)):
            seg = seg * np.asarray([sx, sy], np.float32)
            if normalize:
                seg = seg / np.asarray([ow, oh], np.float32)
            out.append(seg)
        return out

    @property
    def xy(self) -> list:
        return self._segments(normalize=False)

    @property
    def xyn(self) -> list:
        return self._segments(normalize=True)


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

    # ------------------------------------------------------------------
    # drawing and writing
    # ------------------------------------------------------------------
    def plot(self, line_width: int | None = None, font_scale: float | None = None,
             labels: bool = True, conf: bool = True, boxes: bool = True,
             masks: bool = True, kpt_line: bool = True) -> np.ndarray:
        """A copy of the image (RGB) with the masks, the rotated or upright
        boxes and their labels, the keypoint skeletons and a classify
        result's top-5 drawn by ``utils.annotator.Annotator``, as JAX draws
        them."""
        from ..utils.annotator import Annotator, colors

        ann = Annotator(self.orig_img, line_width=line_width, font_scale=font_scale)
        if self.masks is not None and masks and len(self.masks):
            cls_of = (lambda mi: int(self.boxes.cls[mi])
                      if self.boxes is not None and mi < len(self.boxes) else mi)
            ann.masks(self.masks.data, [colors(cls_of(mi)) for mi in range(len(self.masks.data))])
        if self.obb is not None and len(self.obb) and boxes:
            for oi, pts in enumerate(self.obb.xyxyxyxy):
                cl, cf = int(self.obb.cls[oi]), float(self.obb.conf[oi])
                name = self.names.get(cl, str(cl))
                if self.obb.is_track:
                    name = f"id:{int(self.obb.id[oi])} {name}"
                txt = (f"{name} {cf:.2f}" if conf else name) if labels else ""
                ann.box_label(pts, txt, color=colors(cl), rotated=True)
        if self.boxes is not None and self.obb is None and boxes:
            for row in self.boxes.data:
                cl, cf = int(row[-1]), float(row[-2])
                name = self.names.get(cl, str(cl))
                if self.boxes.is_track:
                    name = f"id:{int(row[4])} {name}"
                txt = (f"{name} {cf:.2f}" if conf else name) if labels else ""
                ann.box_label(row[:4], txt, color=colors(cl))
        if self.keypoints is not None:
            for inst in self.keypoints.data:
                ann.kpts(inst, kpt_line=kpt_line)
        if self.probs is not None and labels:
            for li, c in enumerate(self.probs.top5):
                ann.text((8, 28 + 24 * li), f"{self.names.get(c, c)} {self.probs.data[c]:.2f}",
                         box_style=True)
        return ann.result()

    def save(self, filename: str):
        """Write ``plot()`` to ``filename`` (.jpg at quality 95, .png or .bmp)."""
        imwrite(filename, self.plot())
        return filename

    def save_crop(self, save_dir, file_name: str | Path = Path("im.jpg")):
        """Write each box's crop, grown by 2% and 10 px about its centre, to
        ``save_dir/<class name>/<stem><i or ''>.jpg``; a classify or OBB
        result warns and writes nothing, as in JAX."""
        from ..utils import LOGGER

        if self.probs is not None:
            LOGGER.warning("save_crop: classify task not supported")
            return
        if self.obb is not None:
            LOGGER.warning("save_crop: OBB task not supported")
            return
        if self.boxes is None:
            return
        h, w = self.orig_shape
        for i in range(len(self.boxes)):
            x1, y1, x2, y2 = self.boxes.xyxy[i]
            bw, bh = (x2 - x1) * 1.02 + 10, (y2 - y1) * 1.02 + 10
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            xa, xb = int(max(cx - bw / 2, 0)), int(min(cx + bw / 2, w))
            ya, yb = int(max(cy - bh / 2, 0)), int(min(cy + bh / 2, h))
            crop = self.orig_img[ya:yb, xa:xb]
            if crop.size == 0:
                continue
            name = self.names.get(int(self.boxes.cls[i]), str(int(self.boxes.cls[i])))
            d = Path(save_dir) / name
            d.mkdir(parents=True, exist_ok=True)
            imwrite(d / f"{Path(file_name).stem}{i if i else ''}.jpg", crop)

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def summary(self, normalize: bool = False, decimals: int = 5) -> list:
        """One dict per detection: name, class, confidence, the box's corners
        (an OBB's four, normalized by the image's size with ``normalize``),
        and where present the track id, the mask's segment and the
        keypoints; a classify result's one dict of its top-1 class."""
        if self.probs is not None:
            c = self.probs.top1
            return [{"name": self.names.get(c, str(c)), "class": c,
                     "confidence": round(float(self.probs.top1conf), decimals)}]
        is_obb = self.obb is not None
        data = self.obb if is_obb else self.boxes
        if data is None:
            return []
        h, w = self.orig_shape if normalize else (1, 1)
        mask_xy = self.masks.xy if self.masks is not None else None
        out = []
        for i in range(len(data)):
            cls_i, conf = int(data.cls[i]), round(float(data.conf[i]), decimals)
            box = (data.xyxyxyxy[i] if is_obb else data.xyxy[i]).reshape(-1, 2)
            xy = {}
            for j, (bx, by) in enumerate(box):
                xy[f"x{j + 1}"] = round(float(bx) / w, decimals)
                xy[f"y{j + 1}"] = round(float(by) / h, decimals)
            rec = {"name": self.names.get(cls_i, str(cls_i)), "class": cls_i,
                   "confidence": conf, "box": xy}
            if data.is_track:
                rec["track_id"] = int(data.id[i])
            if mask_xy is not None and i < len(mask_xy):
                rec["segments"] = {"x": np.round(mask_xy[i][:, 0] / w, decimals).tolist(),
                                   "y": np.round(mask_xy[i][:, 1] / h, decimals).tolist()}
            if self.keypoints is not None and i < len(self.keypoints):
                kp = self.keypoints.data[i]
                rec["keypoints"] = {"x": np.round(kp[:, 0] / w, decimals).tolist(),
                                    "y": np.round(kp[:, 1] / h, decimals).tolist()}
                if self.keypoints.has_visible:
                    rec["keypoints"]["visible"] = np.round(kp[:, 2], decimals).tolist()
            out.append(rec)
        return out

    def to_df(self, normalize: bool = False, decimals: int = 5):
        """The summary as a pandas DataFrame."""
        import pandas as pd

        return pd.DataFrame(self.summary(normalize=normalize, decimals=decimals))

    def to_csv(self, normalize: bool = False, decimals: int = 5, *args, **kwargs):
        return self.to_df(normalize=normalize, decimals=decimals).to_csv(*args, **kwargs)

    def to_xml(self, normalize: bool = False, decimals: int = 5, *args, **kwargs):
        df = self.to_df(normalize=normalize, decimals=decimals)
        if df.empty:
            return '<?xml version="1.0" encoding="utf-8"?>\n<root></root>'
        return df.to_xml(*args, **kwargs)

    def to_json(self, normalize: bool = False, decimals: int = 5) -> str:
        return json.dumps(self.summary(normalize=normalize, decimals=decimals), indent=2)

    def to_sql(self, table_name: str = "results", normalize: bool = False,
               decimals: int = 5, db_path: str = "results.db"):
        """Append the summary to a sqlite table (class name, confidence, and
        the box, segments and keypoints as JSON)."""
        import sqlite3

        data = self.summary(normalize=normalize, decimals=decimals)
        conn = sqlite3.connect(db_path)
        try:
            cur = conn.cursor()
            cur.execute(f"CREATE TABLE IF NOT EXISTS {table_name} (id INTEGER PRIMARY KEY "
                        "AUTOINCREMENT, class_name TEXT, confidence REAL, box TEXT, "
                        "masks TEXT, kpts TEXT)")
            for item in data:
                cur.execute(f"INSERT INTO {table_name} (class_name, confidence, box, masks, "
                            "kpts) VALUES (?, ?, ?, ?, ?)",
                            (item.get("name"), item.get("confidence"),
                             json.dumps(item.get("box", {})),
                             json.dumps(item.get("segments", {})),
                             json.dumps(item.get("keypoints", {}))))
            conn.commit()
        finally:
            conn.close()

    def save_txt(self, txt_file: str, save_conf: bool = False):
        """YOLO-format label lines: a classify result's top-5 ("prob name");
        an OBB's class and normalized corners; else the class and the mask's
        normalized segment, or the normalized (cx, cy, w, h), then the
        keypoints (x, y normalized, visibility); the confidence last with
        ``save_conf``."""
        lines = []
        h, w = self.orig_shape
        if self.probs is not None:
            for c in self.probs.top5:
                lines.append(f"{self.probs.data[c]:.2f} {self.names.get(c, c)}")
        elif self.obb is not None:
            for i in range(len(self.obb)):
                pts = self.obb.xyxyxyxyn[i].reshape(-1).tolist()
                line = f"{int(self.obb.cls[i])} " + " ".join(f"{x:.6f}" for x in pts)
                if save_conf:
                    line += f" {self.obb.conf[i]:.6f}"
                lines.append(line)
        elif self.boxes is not None:
            seg_xyn = self.masks.xyn if self.masks is not None else None
            for i in range(len(self.boxes)):
                if seg_xyn is not None and i < len(seg_xyn) and len(seg_xyn[i]):
                    coords = seg_xyn[i].reshape(-1)
                else:
                    coords = self.boxes.xywhn[i]
                line = f"{int(self.boxes.cls[i])} " + " ".join(f"{x:.6f}" for x in coords)
                if self.keypoints is not None and i < len(self.keypoints):
                    kp = self.keypoints.data[i]
                    kxyn = kp[:, :2] / np.asarray([w, h], np.float32)
                    cols = (np.concatenate([kxyn, kp[:, 2:3]], 1).reshape(-1)
                            if self.keypoints.has_visible else kxyn.reshape(-1))
                    line += " " + " ".join(f"{x:.6f}" for x in cols)
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
