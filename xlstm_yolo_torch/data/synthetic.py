"""A synthetic YOLO-format detection dataset, written to disk as PNG.

Port of ``make_synthetic_dataset`` (detect) in
``xlstm_yolo_tpu/data/synthetic.py``, on ``data.imgproc``: coloured
rectangles, circles and triangles (class = shape) on a noisy background.
It writes PNG, which the port decodes without OpenCV or Pillow, and takes a
width and a height, so that the images need not be square.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import yaml

from . import imgproc as ip

CLASSES = ["rect", "circle", "triangle"]


def make_synthetic_dataset(root: str | Path, n_train: int = 8, n_val: int = 4,
                           imgsz: int = 160, max_objs: int = 3, seed: int = 0,
                           width: int | None = None, height: int | None = None) -> str:
    """Write ``images/{train,val}/*.png`` and ``labels/{train,val}/*.txt``
    (1 to ``max_objs`` objects an image) and ``data.yaml`` under ``root``;
    returns the YAML's path. Images are ``width`` x ``height`` (both
    ``imgsz`` by default)."""
    root = Path(root)
    w, h = int(width or imgsz), int(height or imgsz)
    side = min(w, h)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir, lbl_dir = root / "images" / split, root / "labels" / split
        img_dir.mkdir(parents=True, exist_ok=True)
        lbl_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8) + 60
            lines = []
            for _ in range(int(rng.integers(1, max_objs + 1))):
                cls = int(rng.integers(len(CLASSES)))
                size = int(rng.integers(side // 8, side // 3))
                cx = int(rng.integers(size // 2 + 6, w - size // 2 - 6))
                cy = int(rng.integers(size // 2 + 6, h - size // 2 - 6))
                color = [int(c) for c in rng.integers(150, 256, 3)]
                x1, y1 = cx - size // 2, cy - size // 2
                x2, y2 = cx + size // 2, cy + size // 2
                if cls == 0:
                    ip.fill_rect(img, x1, y1, x2, y2, color)
                elif cls == 1:
                    ip.fill_circle(img, cx, cy, size // 2, color)
                else:
                    ip.fill_poly(img, np.asarray([[cx, y1], [x1, y2], [x2, y2]]), color)
                lines.append(f"{cls} {cx / w:.6f} {cy / h:.6f} {size / w:.6f} {size / h:.6f}")
            ip.imwrite(img_dir / f"{i:04d}.png", img)
            (lbl_dir / f"{i:04d}.txt").write_text("\n".join(lines) + "\n")
    d = {"path": str(root), "train": "images/train", "val": "images/val",
         "names": dict(enumerate(CLASSES)), "nc": len(CLASSES)}
    yaml_path = root / "data.yaml"
    yaml_path.write_text(yaml.safe_dump(d))
    return str(yaml_path)
