"""YOLO-format detection dataset and its fixed-shape batch loader.

Port of the detect part of ``xlstm_yolo_tpu/data/dataset.py``:
``check_det_dataset``, ``img2label_path``, the label scan and its
hash-checked ``.npz`` cache, ``YOLODataset`` (``load_image`` with ``cache``
``ram`` / ``disk``, ``labels_px``, the detect sample, ``collate``),
``Loader`` (the seeded shuffle, the same batch order and per-sample random
streams as JAX, the threaded prefetch) and ``build_dataloader``. Images are
read with ``data.imgproc.imread`` and transformed by ``data.augment``. A
batch:

    img:       (B, imgsz, imgsz, 3) uint8 with ``uint8_images`` (normalized
               on the device), else float32 in [0, 1]
    cls_boxes: (B, max_labels, 5) = (cls, x1, y1, x2, y2) pixels
    mask:      (B, max_labels) bool

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
from pathlib import Path

import numpy as np
import yaml

from . import augment as A
from .imgproc import IMG_FORMATS, imread, resize


def check_det_dataset(data: str | dict) -> dict:
    """A dataset YAML (or dict) -> its dict with absolute split paths,
    ``names`` as {index: name} and ``nc``. No download: paths must exist."""
    if isinstance(data, (str, Path)):
        path = Path(data)
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


def _labels_hash(files: list) -> str:
    """Hash over the image paths and each label file's size and mtime."""
    h = hashlib.sha256()
    for f in files:
        h.update(f.encode())
        try:
            st = os.stat(img2label_path(f))
            h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
        except OSError:
            h.update(b"-")
    return h.hexdigest()


def _pack_labels(labels: list) -> dict:
    counts = np.asarray([len(lb["cls"]) for lb in labels], np.int64)
    return {"counts": counts,
            "cls": (np.concatenate([lb["cls"] for lb in labels]) if counts.sum()
                    else np.zeros(0, np.float32)),
            "xywhn": (np.concatenate([lb["xywhn"] for lb in labels]) if counts.sum()
                      else np.zeros((0, 4), np.float32))}


def _unpack_labels(z) -> list:
    offs = np.concatenate([[0], np.cumsum(z["counts"])])
    return [{"cls": z["cls"][a:b].astype(np.float32), "xywhn": z["xywhn"][a:b].astype(np.float32)}
            for a, b in zip(offs[:-1], offs[1:])]


class YOLODataset:
    """Detection dataset over a YOLO-format tree (``images/`` beside
    ``labels/``, one ``cls cx cy w h`` line per object, normalized).
    ``augment`` selects the train pipeline (mosaic, perspective, mixup, HSV,
    flip); without it a sample is letterboxed (no upscale). ``cache``
    ``"ram"`` (or True) keeps the decoded, resized images in memory;
    ``"disk"`` saves them as ``.npy`` beside the source."""

    def __init__(self, img_path: str, imgsz: int = 640, augment: bool = False, hyp=None,
                 max_labels: int = 128, single_cls: bool = False, fraction: float = 1.0,
                 cache: str | bool = False):
        self.imgsz = imgsz
        self.cache = "ram" if cache is True else (cache or "")
        self._im_cache: dict[int, np.ndarray] = {}
        self.augment = augment
        self.hyp = hyp or {}
        self.max_labels = max_labels
        self.single_cls = single_cls
        self.task = "detect"
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

    @staticmethod
    def _cache_path(img_path) -> Path | None:
        p = Path(img_path[0] if isinstance(img_path, (list, tuple)) else img_path)
        base = p if p.is_dir() else p.parent
        try:
            base.mkdir(parents=True, exist_ok=True)
            return base / "labels_detect.cache.npz"
        except OSError:
            return None

    def _load_labels_cached(self, img_path) -> list:
        """The label scan, once per dataset state: later runs load one
        hash-checked npz."""
        cp = self._cache_path(img_path)
        want = _labels_hash(self.files)
        if cp is not None and cp.exists():
            try:
                with np.load(cp, allow_pickle=False) as z:
                    if (int(z["version"]) == _CACHE_VERSION and str(z["hash"]) == want
                            and int(z["counts"].shape[0]) == len(self.files)):
                        return _unpack_labels(z)
            except (OSError, ValueError, KeyError):
                pass  # a corrupt or stale cache: rescan below
        labels = [self._load_label(f) for f in self.files]
        if cp is not None:
            try:
                np.savez(cp, version=_CACHE_VERSION, hash=want, **_pack_labels(labels))
            except OSError:
                pass  # a read-only dataset: scan on every run
        return labels

    def _load_label(self, img_file: str) -> dict:
        """{"cls": (n,), "xywhn": (n, 4)} from the image's label file."""
        lp = img2label_path(img_file)
        rows = []
        if os.path.exists(lp):
            with open(lp) as f:
                for line in f:
                    parts = [float(x) for x in line.split()]
                    if len(parts) >= 5:
                        rows.append(parts)
        out = {"cls": np.zeros(len(rows), np.float32),
               "xywhn": np.zeros((len(rows), 4), np.float32)}
        for i, parts in enumerate(rows):
            out["cls"][i] = 0 if self.single_cls else parts[0]
            out["xywhn"][i] = parts[1:5]
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

    def get_sample(self, i: int, rng: np.random.Generator) -> tuple:
        """Sample ``i`` -> (img, labels): the train pipeline (mosaic of four
        with perspective, or letterbox with perspective; mixup; HSV; flip)
        drawing from ``rng``, or the letterbox alone."""
        hyp = self.hyp
        g = lambda k, d: float(hyp.get(k, d) if isinstance(hyp, dict) else getattr(hyp, k, d))
        if self.augment and rng.random() < g("mosaic", 1.0):
            n = int(g("mosaic_n", 4))
            if n != 4:
                raise ValueError(f"mosaic_n={n}: the port's detect pipeline has the 4-image "
                                 f"mosaic only")
            idxs = [i] + [int(rng.integers(self.ni)) for _ in range(n - 1)]
            imgs, lbs = [], []
            for j in idxs:
                im = self.load_image(j)
                imgs.append(im)
                lbs.append(self.labels_px(j, im.shape[:2]))
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
            img, labels, _ = A.letterbox(img, self.imgsz, labels, scaleup=self.augment)
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
        """Samples -> a fixed-shape batch: boxes narrower or lower than a
        pixel dropped, the rest in ``max_labels`` padded slots."""
        b = len(samples)
        imgs = np.zeros((b, self.imgsz, self.imgsz, 3),
                        np.uint8 if self.uint8_images else np.float32)
        boxes = np.zeros((b, self.max_labels, 5), np.float32)
        mask = np.zeros((b, self.max_labels), bool)
        for bi, (img, labels) in enumerate(samples):
            imgs[bi] = img if self.uint8_images else img.astype(np.float32) / 255.0
            keep = np.arange(len(labels))
            if len(labels):
                wh = labels[:, 3:5] - labels[:, 1:3]
                keep = np.nonzero((wh > 1).all(-1))[0]
            keep = keep[: self.max_labels]
            n = len(keep)
            if n:
                mask[bi, :n] = True
                boxes[bi, :n] = labels[keep]
        meta = {} if (idxs is None or self.augment) else self._batch_meta(idxs)
        return {"img": imgs, "cls_boxes": boxes, "mask": mask, **meta}


def _pinned(batch: dict) -> dict:
    import torch

    return {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}


class Loader:
    """Epoch iterator with a background prefetch thread. The shuffle of
    epoch e is seeded ``seed + e`` (``epoch`` counts finished passes; set it
    to resume). With ``workers`` > 0 a pool of threads assembles the samples
    of a batch, each from its own generator seeded by the epoch's generator,
    so the stream does not depend on the threads' order; with 0 the samples
    draw one after another from the epoch's generator. ``batch_seconds``
    holds the host's seconds to assemble each batch of the last pass (read,
    augment, collate, pin)."""

    def __init__(self, dataset: YOLODataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2, workers: int = 0,
                 pin: bool = False):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = max(0, int(workers))
        self.pin = pin
        self.epoch = 0
        self.batch_seconds: list[float] = []

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else math.ceil(n / self.bs)

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        idxs = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(idxs)
        nb = len(self)
        batches = [idxs[b * self.bs:(b + 1) * self.bs] for b in range(nb)]
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

        def _assemble(batch_idx):
            t0 = time.perf_counter()
            if pool is not None:
                seeds = rng.integers(0, 2**31 - 1, len(batch_idx))
                samples = list(pool.map(
                    lambda a: self.ds.get_sample(int(a[0]), np.random.default_rng(int(a[1]))),
                    zip(batch_idx, seeds)))
            else:
                samples = [self.ds.get_sample(int(i), rng) for i in batch_idx]
            batch = self.ds.collate(samples, batch_idx)
            batch = _pinned(batch) if self.pin else batch
            self.batch_seconds.append(time.perf_counter() - t0)
            return batch

        def producer():
            # an exception reaches the consumer, which re-raises it
            try:
                for batch_idx in batches:
                    if stop.is_set() or not _put(_assemble(batch_idx)):
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


def build_dataloader(data_yaml: str | dict, split: str = "train", batch: int = 16,
                     imgsz: int = 640, augment: bool | None = None, hyp=None,
                     max_labels: int = 128, seed: int = 0, fraction: float = 1.0,
                     single_cls: bool = False, cache: str | bool = False,
                     workers: int = 0) -> tuple[Loader, dict]:
    """Dataset YAML (or dict) -> (Loader, dataset dict). The train split
    augments and shuffles and drops the last partial batch; the others keep
    every image in order."""
    augment = (split == "train") if augment is None else augment
    d = check_det_dataset(data_yaml)
    ds = YOLODataset(d[split], imgsz=imgsz, augment=augment, hyp=hyp, max_labels=max_labels,
                     single_cls=single_cls, fraction=fraction, cache=cache)
    return Loader(ds, batch, shuffle=augment, seed=seed, drop_last=augment, workers=workers), d
