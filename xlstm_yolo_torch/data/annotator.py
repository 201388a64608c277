"""Auto-annotation: a detector proposes boxes, SAM turns each into a mask
and the mask's largest contour into a YOLO segment label.

Port of ``_mask_to_polygon`` and ``auto_annotate`` in
``xlstm_yolo_tpu/data/annotator.py``: the contours are ``ops.contours``'
(what ``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` gives, the
largest by ``cv2.contourArea``), the images are read by
``data.imgproc.imread`` (JPEG, PNG and BMP without OpenCV), and SAM is the
port's ``models_sam.SAMPredictor``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.contours import mask_to_polygon as _mask_to_polygon
from .imgproc import imread

__all__ = ("_mask_to_polygon", "auto_annotate")


def auto_annotate(source, det_model, sam_predictor, output_dir: str | Path | None = None,
                  conf: float = 0.25, max_det: int = 32) -> list:
    """Write a YOLO segment label file (``cls x1 y1 x2 y2 ...``, normalized)
    per image of ``source`` (an image path, a directory or a list of paths)
    into ``output_dir`` (default ``auto_annotate_labels`` beside the first
    image) and return the paths. ``det_model`` is anything with
    ``.predict`` (an ``engine.model.Model``); ``sam_predictor`` a
    ``models_sam.SAMPredictor``. Each of the first ``max_det`` boxes is a
    box prompt; a polygon of fewer than 3 points is dropped."""
    p = Path(source) if isinstance(source, (str, Path)) else None
    if p is not None and p.is_dir():
        paths = sorted(q for q in p.iterdir()
                       if q.suffix.lower() in (".jpg", ".jpeg", ".png", ".bmp"))
    elif p is not None:
        paths = [p]
    else:
        paths = [Path(s) for s in source]
    out_dir = Path(output_dir) if output_dir else (paths[0].parent / "auto_annotate_labels")
    out_dir.mkdir(parents=True, exist_ok=True)

    written = []
    for img_path in paths:
        img = imread(img_path)
        r = det_model.predict(img, conf=conf, verbose=False)[0]
        boxes = np.asarray(r.boxes.xyxy) if len(r.boxes) else np.zeros((0, 4))
        clses = np.asarray(r.boxes.cls).astype(int) if len(r.boxes) else np.zeros(0, int)
        lines = []
        sam_predictor.set_image(img)
        for box, c in zip(boxes[:max_det], clses[:max_det]):
            masks, _ = sam_predictor.predict(boxes=box, multimask_output=False)
            poly = _mask_to_polygon(masks[0])
            if len(poly) >= 3:
                lines.append(f"{int(c)} " + " ".join(f"{v:.6f}" for v in poly.reshape(-1)))
        out = out_dir / f"{img_path.stem}.txt"
        out.write_text("\n".join(lines) + ("\n" if lines else ""))
        written.append(out)
    return written
