"""COCO category ids for COCO-format predictions.

The port's copy of ``coco80_to_coco91_class`` in
``xlstm_yolo_tpu/data/converter.py`` (the rest of that module, the dataset
converters, is not ported).
"""
from __future__ import annotations

# the 11 ids of the paper's 91 categories that the 80-class dataset leaves out (0-based)
_SKIPPED_91 = {11, 25, 28, 29, 44, 65, 67, 68, 70, 82, 90}


def coco80_to_coco91_class() -> list:
    """80-index (dataset) -> the paper's 1-based category ids, the map
    COCO scoring expects."""
    return [i + 1 for i in range(91) if i not in _SKIPPED_91]
