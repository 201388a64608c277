"""Inference sources: image files and in-memory arrays.

Port of ``LoadImagesAndVideos`` (images only) and ``LoadPilAndNumpy`` in
``xlstm_yolo_tpu/data/loaders.py``. Both yield ``(path, RGB uint8 (H, W,
3))`` one frame at a time; files are read with ``data.imgproc.imread``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .imgproc import imread


class LoadImagesAndVideos:
    """Lazy iterator over image files, in the order given; a file is decoded
    when its turn comes."""

    def __init__(self, files, vid_stride: int = 1):
        self.files = [Path(f) for f in files]
        self.vid_stride = max(1, int(vid_stride))
        self.mode = "image"

    def __iter__(self):
        for p in self.files:
            yield str(p), imread(p)


class LoadPilAndNumpy:
    """In-memory sources: an ndarray or PIL image, or a list of them."""

    def __init__(self, items):
        self.items = items if isinstance(items, (list, tuple)) else [items]
        self.mode = "image"

    def __iter__(self):
        for i, s in enumerate(self.items):
            if hasattr(s, "convert"):  # a PIL image
                yield f"pil{i}", np.asarray(s.convert("RGB"))
            else:
                yield f"array{i}", np.asarray(s)
