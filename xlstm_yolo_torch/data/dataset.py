"""YOLO-format dataset of the detect, segment, pose and obb tasks, the
classify task's folder-per-class dataset, and their fixed-shape batch
loader.

Port of ``xlstm_yolo_tpu/data/dataset.py`` for those tasks:
``check_det_dataset``, ``img2label_path``, the label scan and its
hash-checked ``.npz`` cache, ``YOLODataset`` (``load_image`` with ``cache``
``ram`` / ``disk``, ``labels_px``, the detect sample, the point tasks'
sample (``_get_sample_points``: mosaic or letterbox, copy-paste, HSV and
the flip carrying polygons, keypoints with ``flip_idx``, and OBB corners,
turned into (cx, cy, w, h, angle) by ``imgproc.min_area_rect`` at the end),
``collate``, ``collate_native``: an eval batch through the native C++
letterbox, ``native``), ``ClassificationDataset``,
``Loader`` (the seeded shuffle, the same batch order and per-sample random
streams as JAX, the threaded prefetch) and ``build_dataloader``; the rect
buckets of eval (``rect_groups``, the image shapes read from the files'
headers and cached beside the label cache). Images are read with
``data.imgproc.imread`` and transformed by ``data.augment``. A batch:

    img:       (B, imgsz, imgsz, 3) uint8 with ``uint8_images`` (normalized
               on the device), else float32 in [0, 1]; (B, h, w, 3) at a
               rect bucket's shape
    cls_boxes: (B, max_labels, 5) = (cls, x1, y1, x2, y2) pixels; obb:
               (B, max_labels, 6) = (cls, cx, cy, w, h, angle in radians)
    mask:      (B, max_labels) bool
    masks:     segment: (B, h / mask_ratio, w / mask_ratio) int32, slot + 1
               of the instance per pixel (``imgproc.fill_poly_cv`` in slot
               order: a later instance covers an earlier one), 0 elsewhere
    keypoints: pose: (B, max_labels, nk, 3) pixels + visibility

and, for an eval batch, ``ori_shape`` and ``im_idx``. With ``pin`` the
loader's thread hands the arrays over as pinned torch tensors, ready for
a non-blocking copy to the card.
"""
from __future__ import annotations

import hashlib
import math
import os
import queue
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import yaml

from . import augment as A
from .imgproc import IMG_FORMATS, fill_poly_cv, image_shape, imread, min_area_rect, resize

DATASETS_DIR = Path(__file__).resolve().parent.parent / "cfg" / "datasets"


def check_det_dataset(data: str | dict) -> dict:
    """A dataset YAML (or dict) -> its dict with absolute split paths,
    ``names`` as {index: name} and ``nc``. A path that does not exist
    resolves by its name against the bundled descriptors (``cfg/datasets``,
    e.g. ``"coco8.yaml"``). No download: paths must exist."""
    if isinstance(data, (str, Path)):
        path = Path(data)
        if not path.exists() and (DATASETS_DIR / path.name).exists():
            path = DATASETS_DIR / path.name
        with open(path, errors="ignore") as f:
            d = yaml.safe_load(f)
        root = Path(d.get("path", path.parent))
        if not root.is_absolute():
            root = (path.parent / root).resolve()
    else:
        d = dict(data)
        root = Path(d.get("path", "."))
    out = dict(d)
    out["path"] = root
    for split in ("train", "val", "test"):
        if d.get(split):
            v = d[split]
            if isinstance(v, (list, tuple)):
                out[split] = [str(Path(p) if Path(p).is_absolute() else root / p) for p in v]
            else:
                p = Path(v)
                out[split] = str(p if p.is_absolute() else root / p)
    names = d.get("names")
    if isinstance(names, list):
        names = dict(enumerate(names))
    out["names"] = names or {}
    out["nc"] = int(d.get("nc", len(out["names"])) or len(out["names"]))
    return out


def img2label_path(img_path: str) -> str:
    """images/xxx.jpg -> labels/xxx.txt."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return sb.join(img_path.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"


# the persistent label cache: one .npz beside the images, no pickle
_CACHE_VERSION = 1


def _files_hash(files: list, stat_of=img2label_path) -> str:
    """Hash over the image paths and the size and mtime of the file
    ``stat_of`` names for each: its label file by default, the image itself
    for the shapes read from it (an image replaced in place must not serve
    stale shapes)."""
    h = hashlib.sha256()
    for f in files:
        h.update(f.encode())
        try:
            st = os.stat(stat_of(f))
            h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
        except OSError:
            h.update(b"-")
    return h.hexdigest()


def _pack_labels(labels: list, task: str = "detect") -> dict:
    """Per-image label dicts -> flat arrays and counts (``np.savez`` without
    pickle)."""
    counts = np.asarray([len(lb["cls"]) for lb in labels], np.int64)
    cat = lambda key, empty: (np.concatenate([lb[key] for lb in labels]) if counts.sum()
                              else np.zeros(empty, np.float32))
    out = {"counts": counts, "cls": cat("cls", 0), "xywhn": cat("xywhn", (0, 4))}
    if task == "segment":
        segs = [s for lb in labels for s in lb["segments"]]
        out["seg_counts"] = np.asarray([len(lb["segments"]) for lb in labels], np.int64)
        out["seg_lens"] = np.asarray([len(s) for s in segs], np.int64)
        out["seg_pts"] = (np.concatenate(segs).astype(np.float32) if segs
                          else np.zeros((0, 2), np.float32))
    elif task == "pose":
        out["keypoints"] = cat("keypoints", (0, 1, 3))
    elif task == "obb":
        out["obb_corners"] = cat("obb_corners", (0, 4, 2))
    return out


def _unpack_labels(z, task: str = "detect") -> list:
    offs = np.concatenate([[0], np.cumsum(z["counts"])])
    if task == "segment":
        seg_offs = np.concatenate([[0], np.cumsum(z["seg_counts"])])
        pt_offs = np.concatenate([[0], np.cumsum(z["seg_lens"])])
    labels = []
    for i, (a, b) in enumerate(zip(offs[:-1], offs[1:])):
        lb = {"cls": z["cls"][a:b].astype(np.float32), "xywhn": z["xywhn"][a:b].astype(np.float32)}
        if task == "segment":
            lb["segments"] = [z["seg_pts"][pt_offs[k]:pt_offs[k + 1]].astype(np.float32)
                              for k in range(seg_offs[i], seg_offs[i + 1])]
        elif task == "pose":
            lb["keypoints"] = z["keypoints"][a:b].astype(np.float32)
        elif task == "obb":
            lb["obb_corners"] = z["obb_corners"][a:b].astype(np.float32)
        labels.append(lb)
    return labels


def rect_groups(shapes: np.ndarray, batch: int, imgsz: int, stride: int = 32,
                pad: float = 0.5) -> list:
    """Images (original (h, w) each) grouped into batches by aspect ratio,
    each with one stride-aligned (h, w) canvas: [(indices, (h, w)), ...],
    as the JAX ``YOLODataset._set_rectangle`` (the reference's
    ``set_rectangle`` with val's pad 0.5). The last group may be short."""
    shapes = np.asarray(shapes, np.float64)
    ar = shapes[:, 0] / np.maximum(shapes[:, 1], 1)  # h / w
    order = np.argsort(ar, kind="stable")
    groups = []
    for b in range(math.ceil(len(shapes) / batch)):
        idx = order[b * batch:(b + 1) * batch]
        mini, maxi = float(ar[idx].min()), float(ar[idx].max())
        shp = [maxi, 1.0] if maxi < 1 else ([1.0, 1.0 / mini] if mini > 1 else [1.0, 1.0])
        hw = np.ceil(np.asarray(shp) * imgsz / stride + pad).astype(int) * stride
        groups.append(([int(i) for i in idx], (int(hw[0]), int(hw[1]))))
    return groups


class YOLODataset:
    """Dataset over a YOLO-format tree (``images/`` beside ``labels/``, one
    line per object, normalized): ``task`` detect ``cls cx cy w h``,
    segment ``cls x1 y1 x2 y2 ...`` (a polygon; its box derived), pose
    ``cls cx cy w h`` + ``kpt_shape[0]`` keypoints of ``kpt_shape[1]``
    values (2: visibility 2 added), obb ``cls`` + 4 corners.
    ``augment`` selects the train pipeline (mosaic of ``mosaic_n`` 3, 4 or
    9 images, perspective, mixup, HSV, flip); without it a sample is
    letterboxed (no upscale). ``cache`` ``"ram"`` (or True) keeps the
    decoded, resized images in memory; ``"disk"`` saves them as ``.npy``
    beside the source. ``rect`` (eval only) letterboxes each batch to its
    aspect-ratio bucket (``rect_batches``; ``stride``, ``pad``)."""

    def __init__(self, img_path: str, imgsz: int = 640, augment: bool = False, hyp=None,
                 max_labels: int = 128, single_cls: bool = False, fraction: float = 1.0,
                 cache: str | bool = False, rect: bool = False, stride: int = 32,
                 pad: float = 0.5, task: str = "detect", kpt_shape: tuple = (17, 3),
                 mask_ratio: int = 4):
        self.imgsz = imgsz
        self.cache = "ram" if cache is True else (cache or "")
        self._im_cache: dict[int, np.ndarray] = {}
        self.augment = augment
        self.hyp = hyp or {}
        self.max_labels = max_labels
        self.single_cls = single_cls
        self.task = task
        self.kpt_shape = tuple(kpt_shape)
        self.mask_ratio = int(mask_ratio)
        self.files = self._scan(img_path)
        if fraction < 1.0:
            self.files = self.files[: max(1, round(len(self.files) * fraction))]
        self.labels = self._load_labels_cached(img_path)
        self.ni = len(self.files)
        # original (h, w) per image, filled by load_image
        self.ori_shapes: dict[int, tuple[int, int]] = {}
        if self.ni == 0:
            raise FileNotFoundError(f"no images found in {img_path}")
        self.uint8_images = False
        self.rect = bool(rect) and not augment
        self.stride, self.pad = int(stride), float(pad)
        self._img_path = img_path
        self._shapes = None

    @staticmethod
    def _scan(img_path) -> list:
        if isinstance(img_path, (list, tuple)):
            return [f for sub in img_path for f in YOLODataset._scan(sub)]
        p = Path(img_path)
        if p.is_dir():
            return sorted(str(f) for f in p.rglob("*") if f.suffix.lower() in IMG_FORMATS)
        if p.is_file() and p.suffix == ".txt":
            files = []
            for line in p.read_text().splitlines():
                if line.strip():
                    fp = Path(line.strip())
                    files.append(str(fp if fp.is_absolute() else p.parent / fp))
            return files
        raise FileNotFoundError(f"invalid dataset path {img_path}")

    def _cache_path(self, img_path) -> Path | None:
        p = Path(img_path[0] if isinstance(img_path, (list, tuple)) else img_path)
        base = p if p.is_dir() else p.parent
        try:
            base.mkdir(parents=True, exist_ok=True)
            return base / f"labels_{self.task}.cache.npz"
        except OSError:
            return None

    def _load_labels_cached(self, img_path) -> list:
        """The label scan, once per dataset state: later runs load one
        hash-checked npz."""
        cp = self._cache_path(img_path)
        want = _files_hash(self.files)
        if cp is not None and cp.exists():
            try:
                with np.load(cp, allow_pickle=False) as z:
                    if (int(z["version"]) == _CACHE_VERSION and str(z["hash"]) == want
                            and int(z["counts"].shape[0]) == len(self.files)):
                        return _unpack_labels(z, self.task)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile):
                pass  # a corrupt or stale cache: rescan below
        labels = [self._load_label(f) for f in self.files]
        if cp is not None:
            try:
                _savez_atomic(cp, version=_CACHE_VERSION, hash=want,
                              **_pack_labels(labels, self.task))
            except OSError:
                pass  # a read-only dataset: scan on every run
        return labels

    def image_shapes(self) -> np.ndarray:
        """(ni, 2) original (h, w) of every image, from the files' headers,
        kept in an ``.npz`` beside the label cache that the images' own
        sizes and mtimes key; an unreadable header counts as square
        ``imgsz``, as in JAX."""
        if self._shapes is not None:
            return self._shapes
        cp = self._cache_path(self._img_path)
        sp = cp.with_name(cp.name + ".shapes.npz") if cp is not None else None
        want = _files_hash(self.files, stat_of=str)
        if sp is not None and sp.exists():
            try:
                with np.load(sp, allow_pickle=False) as z:
                    if str(z["hash"]) == want and z["shapes"].shape[0] == self.ni:
                        self._shapes = z["shapes"]
                        return self._shapes
            except (OSError, ValueError, KeyError, zipfile.BadZipFile):
                pass  # a corrupt or stale cache: read the headers again
        shapes = np.zeros((self.ni, 2), np.int32)
        for i, f in enumerate(self.files):
            try:
                shapes[i] = image_shape(f)
            except (OSError, ValueError, ImportError):
                shapes[i] = (self.imgsz, self.imgsz)
        if sp is not None:
            try:
                _savez_atomic(sp, hash=want, shapes=shapes)
            except OSError:
                pass  # a read-only dataset
        self._shapes = shapes
        return shapes

    def rect_batches(self, batch: int) -> list:
        """The rect buckets of this dataset at ``batch`` images a batch
        (``rect_groups``); computed anew for each caller, so loaders of
        different batch sizes do not disturb each other."""
        return rect_groups(self.image_shapes(), batch, self.imgsz, self.stride, self.pad)

    def _load_label(self, img_file: str) -> dict:
        """{"cls": (n,), "xywhn": (n, 4)} from the image's label file, and
        the task's points: "segments" (a list of (k, 2)), "keypoints" (n,
        nk, 3) or "obb_corners" (n, 4, 2), normalized."""
        lp = img2label_path(img_file)
        rows = []
        if os.path.exists(lp):
            with open(lp) as f:
                for line in f:
                    parts = [float(x) for x in line.split()]
                    if len(parts) >= 5:
                        rows.append(parts)
        n = len(rows)
        out = {"cls": np.zeros(n, np.float32), "xywhn": np.zeros((n, 4), np.float32)}
        nk, nd = self.kpt_shape
        if self.task == "segment":
            out["segments"] = []
        elif self.task == "pose":
            out["keypoints"] = np.zeros((n, nk, 3), np.float32)
        elif self.task == "obb":
            out["obb_corners"] = np.zeros((n, 4, 2), np.float32)
        for i, parts in enumerate(rows):
            out["cls"][i] = 0 if self.single_cls else parts[0]
            pts = None
            if self.task == "segment" and len(parts) > 5:
                pts = np.asarray(parts[1:], np.float32).reshape(-1, 2)
                out["segments"].append(pts)
            elif self.task == "obb" and len(parts) >= 9:
                pts = out["obb_corners"][i] = np.asarray(parts[1:9], np.float32).reshape(4, 2)
            if pts is not None:
                (x1, y1), (x2, y2) = pts.min(0), pts.max(0)
                out["xywhn"][i] = [(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1]
                continue
            out["xywhn"][i] = parts[1:5]
            if self.task == "pose" and len(parts) > 5:
                k = np.asarray(parts[5:5 + nk * nd], np.float32).reshape(nk, nd)
                if nd == 2:
                    k = np.concatenate([k, np.full((nk, 1), 2, np.float32)], -1)
                out["keypoints"][i] = k
            elif self.task == "segment":  # a box line: its rectangle
                cx, cy, w, h = parts[1:5]
                out["segments"].append(np.asarray(
                    [[cx - w / 2, cy - h / 2], [cx + w / 2, cy - h / 2],
                     [cx + w / 2, cy + h / 2], [cx - w / 2, cy + h / 2]], np.float32))
        return out

    def __len__(self):
        return self.ni

    def load_image(self, i: int) -> np.ndarray:
        """Image ``i`` as RGB uint8, its long side resized to ``imgsz``."""
        if self.cache == "ram":
            hit = self._im_cache.get(i)
            if hit is not None:
                return hit
        src = Path(self.files[i])
        if self.cache == "disk":
            npy = src.with_suffix(".cache.npy")
            if npy.exists() and npy.stat().st_mtime >= src.stat().st_mtime:
                img = np.load(npy, mmap_mode="r", allow_pickle=False)
                self.ori_shapes.setdefault(i, tuple(
                    np.load(src.with_suffix(".cache.shape.npy"), allow_pickle=False)))
                return np.asarray(img)
        img = imread(src)
        h, w = img.shape[:2]
        self.ori_shapes[i] = (h, w)
        r = self.imgsz / max(h, w)
        if r != 1:
            img = resize(img, (min(math.ceil(w * r), self.imgsz),
                               min(math.ceil(h * r), self.imgsz)))
        if self.cache == "ram":
            self._im_cache[i] = img
        elif self.cache == "disk":
            try:
                np.save(src.with_suffix(".cache.npy"), img)
                np.save(src.with_suffix(".cache.shape.npy"), np.asarray([h, w]))
            except OSError:
                pass  # a read-only dataset
        return img

    def labels_px(self, i: int, shape) -> np.ndarray:
        """Labels of image ``i`` as (n, 5) = cls, x1, y1, x2, y2 in pixels of
        ``shape`` (h, w)."""
        lb = self.labels[i]
        n = len(lb["cls"])
        out = np.zeros((n, 5), np.float32)
        if n:
            h, w = shape
            xywhn = lb["xywhn"]
            cx, cy, bw, bh = xywhn[:, 0] * w, xywhn[:, 1] * h, xywhn[:, 2] * w, xywhn[:, 3] * h
            out[:, 0] = lb["cls"]
            out[:, 1] = cx - bw / 2
            out[:, 2] = cy - bh / 2
            out[:, 3] = cx + bw / 2
            out[:, 4] = cy + bh / 2
        return out

    def _batch_meta(self, idxs) -> dict:
        """Per-image original (h, w) and dataset index of an eval batch."""
        idxs = [int(i) for i in idxs]
        shapes = np.asarray([self.ori_shapes.get(i, (self.imgsz, self.imgsz)) for i in idxs],
                            np.float32)
        return {"ori_shape": shapes, "im_idx": np.asarray(idxs, np.int32)}

    def collate_native(self, idxs) -> dict | None:
        """The eval batch of ``idxs`` through the native letterbox
        (``native.letterbox_batch``, no upscale): float32 images in [0, 1]
        and the labels moved by each image's gain and padding; None where
        no g++ is found (the loader then assembles the batch in Python)."""
        from .. import native

        if not native.available():
            return None
        imgs = [self.load_image(int(i)) for i in idxs]
        batch_imgs, metas = native.letterbox_batch(imgs, self.imgsz, scaleup=False)
        boxes = np.zeros((len(idxs), self.max_labels, 5), np.float32)
        mask = np.zeros((len(idxs), self.max_labels), bool)
        for bi, i in enumerate(idxs):
            lb = self.labels_px(int(i), imgs[bi].shape[:2])
            r, px, py = metas[bi]
            if len(lb):
                lb[:, 1:5] *= r
                lb[:, [1, 3]] += px
                lb[:, [2, 4]] += py
                wh = lb[:, 3:5] - lb[:, 1:3]
                lb = lb[(wh > 1).all(-1)][: self.max_labels]
            boxes[bi, :len(lb)] = lb
            mask[bi, :len(lb)] = True
        return {"img": batch_imgs, "cls_boxes": boxes, "mask": mask, **self._batch_meta(idxs)}

    def points_px(self, i: int, shape) -> dict:
        """Image ``i``'s point annotations in pixels of ``shape`` (h, w)."""
        lb = self.labels[i]
        h0, w0 = shape
        wh = np.asarray([w0, h0], np.float32)
        if self.task == "segment":
            return {"segments": [p * wh for p in lb["segments"]]}
        if self.task == "pose":
            k = lb["keypoints"].copy()
            k[..., 0] *= w0
            k[..., 1] *= h0
            return {"keypoints": k}
        if self.task == "obb":
            return {"corners": lb["obb_corners"] * wh}
        return {}

    def _get_sample_points(self, i: int, rng: np.random.Generator, shape=None) -> tuple:
        """Sample ``i`` of a point task -> (img, labels, extra): the mosaic
        (of ``mosaic_n`` images, halved to ``imgsz``) or the letterbox,
        copy-paste (segment, ``copy_paste`` of mode ``copy_paste_mode``),
        HSV and the left-right flip (keypoints reordered by the hyp's
        ``flip_idx``); no perspective, as in JAX. OBB corners become
        ``extra["rbox"]`` (n, 5) = (cx, cy, w, h, angle in radians)."""
        hyp = self.hyp
        get = lambda k, d: hyp.get(k, d) if isinstance(hyp, dict) else getattr(hyp, k, d)
        g = lambda k, d: float(get(k, d))
        if self.augment and rng.random() < g("mosaic", 1.0):
            n = int(g("mosaic_n", 4))
            idxs = [i] + [int(rng.integers(self.ni)) for _ in range(max(n, 3) - 1)]
            imgs, lbs, pts = [], [], []
            for j in idxs:
                im = self.load_image(j)
                imgs.append(im)
                lbs.append(self.labels_px(j, im.shape[:2]))
                pts.append(self.points_px(j, im.shape[:2]))
            if n in (3, 9):
                img, labels, extra = (A.mosaic3 if n == 3 else A.mosaic9)(imgs, lbs, self.imgsz,
                                                                         extras=pts)
            else:
                img, labels, extra = A.mosaic4(imgs, lbs, self.imgsz, rng, extras=pts)
            img = resize(img, (self.imgsz, self.imgsz))  # the 2s canvas halved
            labels = labels.copy()
            labels[:, 1:5] *= 0.5
            extra = A.shift_points(extra, 0.5, 0.0, 0.0)
        else:
            img = self.load_image(i)
            labels = self.labels_px(i, img.shape[:2])
            pts = self.points_px(i, img.shape[:2])
            img, labels, (r, px, py) = A.letterbox(img, shape or self.imgsz, labels,
                                                   scaleup=self.augment)
            extra = A.shift_points(pts, r, px, py)

        if self.task == "segment" and self.augment and g("copy_paste", 0.0) > 0:
            if (get("copy_paste_mode", "flip") or "flip") == "mixup":
                j = int(rng.integers(self.ni))
                im2 = self.load_image(j)
                lb2 = self.labels_px(j, im2.shape[:2])
                pts2 = self.points_px(j, im2.shape[:2])
                im2, lb2, (r2, px2, py2) = A.letterbox(im2, self.imgsz, lb2)
                segs2 = A.shift_points(pts2, r2, px2, py2).get("segments", [])
                img, labels, segs = A.copy_paste_mix(img, labels, extra.get("segments", []), im2,
                                                     lb2, segs2, p=g("copy_paste", 0.0))
            else:
                img, labels, segs = A.copy_paste_flip(img, labels, extra.get("segments", []),
                                                      p=g("copy_paste", 0.0), rng=rng)
            extra["segments"] = segs

        if self.augment:
            img = A.random_hsv(img, g("hsv_h", 0.015), g("hsv_s", 0.7), g("hsv_v", 0.4), rng)
            if g("fliplr", 0.5) and rng.random() < g("fliplr", 0.5):
                w = img.shape[1]
                img = np.ascontiguousarray(img[:, ::-1])
                if len(labels):
                    x1 = labels[:, 1].copy()
                    labels[:, 1] = w - labels[:, 3]
                    labels[:, 3] = w - x1
                if "segments" in extra:
                    extra["segments"] = [np.stack([w - p[:, 0], p[:, 1]], -1)
                                         for p in extra["segments"]]
                if "keypoints" in extra:
                    k = extra["keypoints"]
                    k[..., 0] = w - k[..., 0]
                    flip_idx = hyp.get("flip_idx") if isinstance(hyp, dict) else None
                    extra["keypoints"] = k[:, list(flip_idx)] if flip_idx else k
                if "corners" in extra:
                    extra["corners"][..., 0] = w - extra["corners"][..., 0]
        if self.task == "obb":
            # the angle is defined once the geometry is done
            corners = extra.pop("corners", np.zeros((0, 4, 2), np.float32))
            rb = np.zeros((len(corners), 5), np.float32)
            for ci, c in enumerate(corners):
                (cx, cy), (w, h), ang = min_area_rect(c)
                rb[ci] = [cx, cy, w, h, ang * math.pi / 180.0]
            extra["rbox"] = rb
        return img, labels, extra

    def get_sample(self, i: int, rng: np.random.Generator, shape=None) -> tuple:
        """Sample ``i`` -> (img, labels) (a point task's: (img, labels,
        extra), ``_get_sample_points``): the train pipeline (mosaic of
        ``mosaic_n`` images, 3, 9 or else 4, with perspective, or letterbox
        with perspective; mixup; HSV; flip) drawing from ``rng``, or the
        letterbox alone, to ``shape`` (h, w) when given (a rect bucket),
        else square ``imgsz``."""
        if self.task != "detect":
            return self._get_sample_points(i, rng, shape)
        hyp = self.hyp
        g = lambda k, d: float(hyp.get(k, d) if isinstance(hyp, dict) else getattr(hyp, k, d))
        if self.augment and rng.random() < g("mosaic", 1.0):
            n = int(g("mosaic_n", 4))
            idxs = [i] + [int(rng.integers(self.ni)) for _ in range(max(n, 3) - 1)]
            imgs, lbs = [], []
            for j in idxs:
                im = self.load_image(j)
                imgs.append(im)
                lbs.append(self.labels_px(j, im.shape[:2]))
            if n in (3, 9):
                fn = A.mosaic3 if n == 3 else A.mosaic9
                img, labels = fn(imgs, lbs, self.imgsz)
            else:
                img, labels = A.mosaic4(imgs, lbs, self.imgsz, rng)
            border = (-self.imgsz // 2, -self.imgsz // 2)
            img, labels = A.random_perspective(
                img, labels, degrees=g("degrees", 0.0), translate=g("translate", 0.1),
                scale=g("scale", 0.5), shear=g("shear", 0.0), perspective=g("perspective", 0.0),
                border=border, rng=rng)
            if rng.random() < g("mixup", 0.0):
                j = int(rng.integers(self.ni))
                im2 = self.load_image(j)
                lb2 = self.labels_px(j, im2.shape[:2])
                im2, lb2, _ = A.letterbox(im2, self.imgsz, lb2)
                img, labels = A.mixup(img, labels, im2, lb2, rng)
        else:
            img = self.load_image(i)
            labels = self.labels_px(i, img.shape[:2])
            img, labels, _ = A.letterbox(img, shape or self.imgsz, labels,
                                         scaleup=self.augment)
            if self.augment:
                img, labels = A.random_perspective(
                    img, labels, degrees=g("degrees", 0.0), translate=g("translate", 0.1),
                    scale=g("scale", 0.5), shear=g("shear", 0.0), perspective=g("perspective", 0.0),
                    rng=rng)
        if self.augment:
            # the reference's order after mixup: (Albumentations), HSV, flip;
            # Albumentations is inert without its package, which neither
            # the JAX package's machines nor the card's have
            img = A.random_hsv(img, g("hsv_h", 0.015), g("hsv_s", 0.7), g("hsv_v", 0.4), rng)
            img, labels = A.random_flip(img, labels, g("fliplr", 0.5), g("flipud", 0.0), rng)
        return img, labels

    def collate(self, samples: list, idxs=None) -> dict:
        """Samples (of one shape: square ``imgsz`` or a rect bucket's) -> a
        fixed-shape batch: boxes narrower or lower than a pixel dropped,
        the rest in ``max_labels`` padded slots, with the task's ``masks``
        (polygons times 1 / ``mask_ratio``, to int32, filled in slot order)
        or ``keypoints``; an OBB batch's boxes are (cls, rbox)."""
        b = len(samples)
        sh, sw = samples[0][0].shape[:2] if samples else (self.imgsz, self.imgsz)
        imgs = np.zeros((b, sh, sw, 3), np.uint8 if self.uint8_images else np.float32)
        boxes = np.zeros((b, self.max_labels, 6 if self.task == "obb" else 5), np.float32)
        mask = np.zeros((b, self.max_labels), bool)
        extras = {}
        if self.task == "segment":
            extras["masks"] = np.zeros((b, sh // self.mask_ratio, sw // self.mask_ratio), np.int32)
        elif self.task == "pose":
            extras["keypoints"] = np.zeros((b, self.max_labels, self.kpt_shape[0], 3), np.float32)
        for bi, sample in enumerate(samples):
            img, labels = sample[:2]
            extra = sample[2] if len(sample) > 2 else {}
            imgs[bi] = img if self.uint8_images else img.astype(np.float32) / 255.0
            keep = np.arange(len(labels))
            if len(labels):
                wh = labels[:, 3:5] - labels[:, 1:3]
                keep = np.nonzero((wh > 1).all(-1))[0]
            keep = keep[: self.max_labels]
            n = len(keep)
            if not n:
                continue
            mask[bi, :n] = True
            if self.task == "obb":
                boxes[bi, :n, 0] = labels[keep, 0]
                boxes[bi, :n, 1:6] = extra["rbox"][keep]
            else:
                boxes[bi, :n] = labels[keep]
            if self.task == "segment":
                for slot, gi in enumerate(keep):
                    poly = (extra["segments"][gi] * (1.0 / self.mask_ratio)).astype(np.int32)
                    fill_poly_cv(extras["masks"][bi], poly, slot + 1)
            elif self.task == "pose":
                extras["keypoints"][bi, :n] = extra["keypoints"][keep]
        meta = {} if (idxs is None or self.augment) else self._batch_meta(idxs)
        return {"img": imgs, "cls_boxes": boxes, "mask": mask, **extras, **meta}


def _pinned(batch: dict) -> dict:
    """The batch's arrays as pinned tensors; other entries (a world batch's
    ``texts``) as they are."""
    import torch

    return {k: torch.from_numpy(v).pin_memory() if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def _savez_atomic(path: Path, **arrays) -> None:
    """``np.savez`` to a file of this process's, renamed over ``path``: the
    ranks of a data-parallel run scan one dataset at once, and a reader
    never sees half a file."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


class Loader:
    """Epoch iterator with a background prefetch thread. The shuffle of
    epoch e is seeded ``seed + e`` (``epoch`` counts finished passes; set it
    to resume). With ``workers`` > 0 a pool of threads assembles the samples
    of a batch, each from its own generator seeded by the epoch's generator,
    so the stream does not depend on the threads' order; with 0 the samples
    draw one after another from the epoch's generator. ``batch_seconds``
    holds the host's seconds to assemble each batch of the last pass (read,
    augment, collate, pin). An eval batch of a square detect dataset
    without ``uint8_images`` goes through the native letterbox
    (``collate_native``) where g++ is found; ``native_batches`` counts those
    batches over the loader's life. On a ``rect`` dataset the batches are its
    buckets at this loader's batch size, in order (a shuffle is refused);
    with ``drop_last`` the short bucket goes unless it is the only one.
    ``shard_index`` of ``num_shards`` (a data-parallel rank's shard, the
    JAX loader's): the epoch's index order strided, ``[shard_index ::
    num_shards]`` (with ``drop_last`` every shard keeps len // num_shards of
    them, so that all shards give as many batches), or every
    ``num_shards``-th rect bucket; ``batch_size`` is then the shard's."""

    def __init__(self, dataset: YOLODataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2, workers: int = 0,
                 pin: bool = False, shard_index: int = 0, num_shards: int = 1):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        if dataset.rect and shuffle:
            raise ValueError("shuffle=True on a rect dataset: a rect batch is one aspect-ratio "
                             "bucket in order; build the dataset with rect=False to shuffle")
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = max(0, int(workers))
        self.pin = pin
        self.shard_index, self.num_shards = shard_index, num_shards
        self.epoch = 0
        self.batch_seconds: list[float] = []
        self.native_batches = 0
        self._rect = None

    def rect_batches(self) -> list:
        """This loader's rect buckets, [(indices, (h, w)), ...]."""
        if self._rect is None:
            groups = self.ds.rect_batches(self.bs)[self.shard_index::self.num_shards]
            if self.drop_last:
                groups = [g for g in groups if len(g[0]) == self.bs] or groups
            self._rect = groups
        return self._rect

    def __len__(self):
        if self.ds.rect:
            return len(self.rect_batches())
        n = self._shard_len()
        return n // self.bs if self.drop_last else math.ceil(n / self.bs)

    def _shard_len(self) -> int:
        n, k = len(self.ds), self.num_shards
        return n // k if self.drop_last else len(range(self.shard_index, n, k))

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.ds.rect:
            batches = [(np.asarray(idx), hw) for idx, hw in self.rect_batches()]
        else:
            idxs = np.arange(len(self.ds))
            if self.shuffle:
                rng.shuffle(idxs)
            idxs = idxs[self.shard_index::self.num_shards][:self._shard_len()]
            batches = [(idxs[b * self.bs:(b + 1) * self.bs], None) for b in range(len(self))]
        self.batch_seconds = []
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            # a bounded put that re-checks the stop flag, so that an
            # abandoned iterator does not leave this thread blocked
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        pool = None
        if self.workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(self.workers, thread_name_prefix="loader")

        # the native letterbox gives float32 batches: taken where the JAX
        # loader takes it, for an eval detect batch that is square and not uint8
        use_native = (getattr(self.ds, "task", None) == "detect" and not self.ds.augment
                      and not self.ds.rect and not getattr(self.ds, "uint8_images", False))

        def _assemble(batch_idx, shape):
            t0 = time.perf_counter()
            batch = self.ds.collate_native(batch_idx) if use_native else None
            if batch is not None:
                self.native_batches += 1
            else:
                if pool is not None:
                    seeds = rng.integers(0, 2**31 - 1, len(batch_idx))
                    samples = list(pool.map(
                        lambda a: self.ds.get_sample(int(a[0]), np.random.default_rng(int(a[1])),
                                                     shape),
                        zip(batch_idx, seeds)))
                else:
                    samples = [self.ds.get_sample(int(i), rng, shape) for i in batch_idx]
                batch = self.ds.collate(samples, batch_idx)
            batch = _pinned(batch) if self.pin else batch
            self.batch_seconds.append(time.perf_counter() - t0)
            return batch

        def producer():
            # an exception reaches the consumer, which re-raises it
            try:
                for batch_idx, shape in batches:
                    if stop.is_set() or not _put(_assemble(batch_idx, shape)):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                _put(e)
                return
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)
            _put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
            self.epoch += 1
        finally:
            stop.set()


class ClassificationDataset:
    """A folder per class (torchvision's ImageFolder layout): classes are the
    sorted subfolders of ``root``, samples their images (any depth), sorted,
    in class order; ``fraction`` < 1 keeps the first samples of that order
    (so whole classes drop out, as in JAX). ``get_sample`` reads an image
    (RGB uint8) and transforms it: ``augment.classify_train_transform``
    from the hyp keys ``scale`` (the crop's area in (1 - scale, 1)),
    ``fliplr``, ``flipud``, ``auto_augment``, ``hsv_h`` / ``hsv_s`` /
    ``hsv_v`` and ``erasing``, or ``classify_eval_transform`` at
    ``crop_fraction``. A batch: ``img`` (B, imgsz, imgsz, 3) float32 in [0,
    1], ``label`` (B,) int64."""

    rect = False  # the loader's aspect-ratio buckets are a detection dataset's

    def __init__(self, root: str, imgsz: int = 224, augment: bool = False, hyp=None,
                 fraction: float = 1.0):
        self.root = Path(root)
        self.imgsz = imgsz
        self.augment = augment
        self.hyp = hyp or {}
        self.task = "classify"
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.names = dict(enumerate(classes))
        self.samples = [(str(f), self.class_to_idx[c]) for c in classes
                        for f in sorted((self.root / c).rglob("*"))
                        if f.suffix.lower() in IMG_FORMATS]
        if fraction < 1.0:
            self.samples = self.samples[: max(1, round(len(self.samples) * fraction))]
        self.ni = len(self.samples)
        if self.ni == 0:
            raise FileNotFoundError(f"no class folders with images under {root}")
        self.files = [f for f, _ in self.samples]

    def __len__(self):
        return self.ni

    def _hyp(self, key: str, default):
        h = self.hyp
        return h.get(key, default) if isinstance(h, dict) else getattr(h, key, default)

    def get_sample(self, i: int, rng: np.random.Generator, shape=None) -> tuple:
        path, label = self.samples[i]
        img = imread(path)
        g = self._hyp
        if self.augment:
            img = A.classify_train_transform(
                img, self.imgsz, rng, scale=(1.0 - float(g("scale", 0.5)), 1.0),
                hflip=float(g("fliplr", 0.5)), vflip=float(g("flipud", 0.0)),
                auto_augment=g("auto_augment", "randaugment") or None,
                hsv_h=float(g("hsv_h", 0.015)), hsv_s=float(g("hsv_s", 0.4)),
                hsv_v=float(g("hsv_v", 0.4)), erasing=float(g("erasing", 0.4)))
        else:
            img = A.classify_eval_transform(img, self.imgsz,
                                            crop_fraction=float(g("crop_fraction", 1.0)))
        return img, label

    def collate(self, samples: list, idxs=None) -> dict:
        return {"img": np.stack([s[0] for s in samples]).astype(np.float32) / 255.0,
                "label": np.asarray([s[1] for s in samples], np.int64)}

    def collate_native(self, idxs):
        """No native path for classify batches: the loader collates them."""
        return None


def build_dataloader(data_yaml: str | dict, split: str = "train", batch: int = 16,
                     imgsz: int = 640, augment: bool | None = None, hyp=None,
                     max_labels: int = 128, seed: int = 0, fraction: float = 1.0,
                     single_cls: bool = False, cache: str | bool = False,
                     workers: int = 0, rect: bool = False, stride: int = 32,
                     pad: float = 0.5, task: str = "detect",
                     mask_ratio: int = 4, embed_fn=None,
                     text_cfg: dict | None = None, shard: tuple = (0, 1)) -> tuple[Loader, dict]:
    """Dataset YAML (or dict) -> (Loader, dataset dict). The train split
    augments and shuffles and drops the last partial batch; the others keep
    every image in order. ``rect`` (without ``augment``): aspect-ratio
    buckets aligned to ``stride``, padded by ``pad`` strides. ``task``
    selects the labels' format; a pose dataset's ``kpt_shape`` (default
    (17, 3)) comes from its YAML, and its ``flip_idx`` joins a dict
    ``hyp``. ``task="classify"``: ``data_yaml`` is a directory of class
    folders, ``root/{split}`` where it exists, else ``root`` itself; the
    dict is {names, nc, path: root}. ``task="world"``: a
    ``multimodal.MultiModalDataset`` over the detect labels (its batches
    carry ``texts`` and, with ``embed_fn``, ``txt_feats``; ``text_cfg``
    sets its ``RandomLoadText``; ``cache`` and ``rect`` are not read, as in
    JAX). ``shard`` = (index, count): a data-parallel rank's shard of the
    set (``Loader``'s ``shard_index`` / ``num_shards``), ``batch`` its
    share of the global batch."""
    augment = (split == "train") if augment is None else augment
    if task == "classify":
        root = Path(str(data_yaml))
        split_dir = root / split if (root / split).exists() else root
        ds = ClassificationDataset(str(split_dir), imgsz=imgsz, augment=augment, hyp=hyp,
                                   fraction=fraction)
        return (Loader(ds, batch, shuffle=augment, seed=seed, drop_last=augment, workers=workers,
                       shard_index=shard[0], num_shards=shard[1]),
                {"names": ds.names, "nc": len(ds.names), "path": root})
    d = check_det_dataset(data_yaml)
    if isinstance(hyp, dict) and d.get("flip_idx"):
        hyp = {**hyp, "flip_idx": d["flip_idx"]}
    if task == "world":
        from .multimodal import MultiModalDataset

        ds = MultiModalDataset(d[split], d["names"], text_cfg=text_cfg, embed_fn=embed_fn,
                               imgsz=imgsz, augment=augment, hyp=hyp, max_labels=max_labels,
                               single_cls=single_cls, fraction=fraction)
    else:
        ds = YOLODataset(d[split], imgsz=imgsz, augment=augment, hyp=hyp, max_labels=max_labels,
                         single_cls=single_cls, fraction=fraction, cache=cache, rect=rect,
                         stride=stride, pad=pad, task=task,
                         kpt_shape=tuple(d.get("kpt_shape", (17, 3))), mask_ratio=mask_ratio)
    return Loader(ds, batch, shuffle=augment, seed=seed, drop_last=augment, workers=workers,
                  shard_index=shard[0], num_shards=shard[1]), d
