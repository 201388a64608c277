"""A synthetic YOLO-format dataset for every task the port has, written to
disk as PNG.

Port of ``make_synthetic_dataset`` in ``xlstm_yolo_tpu/data/synthetic.py``,
on ``data.imgproc``: coloured rectangles, circles and triangles (class =
shape) on a noisy background, drawn from the same seeded draws in the same
order. Labels (``task``): detect ``cls cx cy w h``; segment the shape's
polygon (4, 12 or 3 points); pose one class with 5 keypoints (the box's
corners and centre, visible) and ``kpt_shape: [5, 3]`` in the YAML; obb the
4 corners of a rotated rectangle (``imgproc.box_points``), all normalized.
It writes PNG, which the port decodes without OpenCV or Pillow, and takes a
width and a height, so that the images need not be square.
``make_classify_dataset`` writes the classify task's folder-per-class set
of the same shapes, one an image, at several sizes and aspect ratios.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import yaml

from . import imgproc as ip

CLASSES = ["rect", "circle", "triangle"]


def make_synthetic_dataset(root: str | Path, n_train: int = 8, n_val: int = 4,
                           imgsz: int = 160, max_objs: int = 3, seed: int = 0,
                           width: int | None = None, height: int | None = None,
                           task: str = "detect") -> str:
    """Write ``images/{train,val}/*.png`` and ``labels/{train,val}/*.txt``
    (1 to ``max_objs`` objects an image) and ``data.yaml`` under ``root``;
    returns the YAML's path. Images are ``width`` x ``height`` (both
    ``imgsz`` by default); ``task`` one of detect, segment, pose, obb."""
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
                if task == "obb":
                    corners = ip.box_points(((cx, cy), (size, size * 0.6),
                                             float(rng.uniform(-60, 60))))
                    ip.fill_poly(img, corners, color)
                    lines.append(f"{cls} " + " ".join(
                        f"{x / w:.6f} {y / h:.6f}" for x, y in corners))
                    continue
                if cls == 0:
                    poly = np.asarray([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.float32)
                    ip.fill_rect(img, x1, y1, x2, y2, color)
                elif cls == 1:
                    th = np.linspace(0, 2 * np.pi, 13)[:-1]
                    poly = np.stack([cx + size / 2 * np.cos(th), cy + size / 2 * np.sin(th)],
                                    -1).astype(np.float32)
                    ip.fill_circle(img, cx, cy, size // 2, color)
                else:
                    poly = np.asarray([[cx, y1], [x1, y2], [x2, y2]], np.float32)
                    ip.fill_poly(img, poly, color)
                if task == "segment":
                    lines.append(f"{cls} " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in poly))
                elif task == "pose":
                    kpts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2), (cx, cy)]
                    lines.append(f"0 {cx / w:.6f} {cy / h:.6f} {size / w:.6f} {size / h:.6f} "
                                 + " ".join(f"{x / w:.6f} {y / h:.6f} 2" for x, y in kpts))
                else:
                    lines.append(f"{cls} {cx / w:.6f} {cy / h:.6f} {size / w:.6f} {size / h:.6f}")
            ip.imwrite(img_dir / f"{i:04d}.png", img)
            (lbl_dir / f"{i:04d}.txt").write_text("\n".join(lines) + "\n")
    pose = task == "pose"
    d = {"path": str(root), "train": "images/train", "val": "images/val",
         "names": {0: "person"} if pose else dict(enumerate(CLASSES)),
         "nc": 1 if pose else len(CLASSES)}
    if pose:
        d["kpt_shape"] = [5, 3]
    yaml_path = root / "data.yaml"
    yaml_path.write_text(yaml.safe_dump(d))
    return str(yaml_path)


# (width, height) of the classify set's images: square, wide and tall, none
# of them the training size
CLASSIFY_SIZES = ((72, 72), (96, 64), (56, 88), (120, 80))


def make_classify_dataset(root: str | Path, n_train: int = 8, n_val: int = 4,
                          sizes=CLASSIFY_SIZES, seed: int = 0) -> str:
    """Write a folder-per-class classify set as PNG, ``root/{train,val}/
    {rect,circle,triangle}/*.png``: each image one shape of its class
    (coloured, at a drawn size and place) on a noisy background, its size
    drawn from ``sizes`` (width, height). Returns ``root`` (what
    ``build_dataloader(task="classify")`` and ``YOLO(...).train(data=)``
    take)."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for cls, name in enumerate(CLASSES):
            d = root / split / name
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                w, h = sizes[int(rng.integers(len(sizes)))]
                img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8) + 60
                size = int(rng.integers(min(w, h) // 3, min(w, h) * 3 // 4))
                cx = int(rng.integers(size // 2 + 2, w - size // 2 - 2))
                cy = int(rng.integers(size // 2 + 2, h - size // 2 - 2))
                color = [int(c) for c in rng.integers(150, 256, 3)]
                x1, y1, x2, y2 = cx - size // 2, cy - size // 2, cx + size // 2, cy + size // 2
                if cls == 0:
                    ip.fill_rect(img, x1, y1, x2, y2, color)
                elif cls == 1:
                    ip.fill_circle(img, cx, cy, size // 2, color)
                else:
                    ip.fill_poly(img, np.asarray([[cx, y1], [x1, y2], [x2, y2]], np.float32), color)
                ip.imwrite(d / f"{i:04d}.png", img)
    return str(root)
