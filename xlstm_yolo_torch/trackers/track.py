"""Trackers by name or tracker YAML, and tracks attached to a stream of
``Results``.

Port of ``xlstm_yolo_tpu/trackers/track.py``: ``create_tracker`` (``"bytetrack"``
or ``"botsort"``, by name or the stem of a path, or a YAML file whose
``tracker_type`` picks one; its keys over ``DEFAULT_CFG``) and
``track_results``, which ``Model.track`` runs over the predictor's stream.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import yaml

from .bot_sort import BOTSORT
from .byte_tracker import BYTETracker

TRACKER_MAP = {"bytetrack": BYTETracker, "botsort": BOTSORT}

DEFAULT_CFG = {
    "bytetrack": dict(track_high_thresh=0.25, track_low_thresh=0.1, new_track_thresh=0.25,
                      track_buffer=30, match_thresh=0.8),
    "botsort": dict(track_high_thresh=0.25, track_low_thresh=0.1, new_track_thresh=0.25,
                    track_buffer=30, match_thresh=0.8, proximity_thresh=0.5,
                    appearance_thresh=0.25, with_reid=False, gmc_method="sparseOptFlow"),
}


def create_tracker(name_or_yaml: str = "bytetrack.yaml"):
    """A tracker from a name (``"bytetrack"``, ``"botsort.yaml"``) or an
    existing tracker YAML."""
    stem = Path(str(name_or_yaml)).stem
    cfg = {}
    if Path(str(name_or_yaml)).exists():
        cfg = yaml.safe_load(Path(name_or_yaml).read_text()) or {}
        stem = cfg.pop("tracker_type", stem)
    if stem not in TRACKER_MAP:
        raise ValueError(f"unknown tracker {stem!r}; choose from {list(TRACKER_MAP)}")
    return TRACKER_MAP[stem](**{**DEFAULT_CFG[stem], **cfg})


def trackable(dets: np.ndarray) -> np.ndarray:
    """The detections a tracker can take: those of positive width and
    height. A box clipped to nothing at the frame's edge has height or
    width 0, its (cx, cy, aspect, h) state divides by it, and the next
    frame's assignment fails on the NaNs (in the JAX package too, which
    passes every detection)."""
    return dets[(dets[:, 2] > dets[:, 0]) & (dets[:, 3] > dets[:, 1])]


def track_results(tracker, results_iter):
    """A generator: each ``Results`` of ``results_iter`` through
    ``tracker.update`` (its ``trackable`` boxes and its image). Where
    tracks come out, the boxes become the tracks' (x1, y1, x2, y2, conf,
    cls) and ``r.track_ids`` their ids; a frame without tracks keeps its
    detections, with no ids. The boxes keep their 6-column form, so
    ``r.boxes.id`` stays None, as in JAX: the ids are ``r.track_ids``."""
    for r in results_iter:
        dets = r.boxes.data if r.boxes is not None else np.zeros((0, 6), np.float32)
        tracks = tracker.update(trackable(dets), r.orig_img)
        if len(tracks):
            r.boxes.data = np.concatenate([tracks[:, :4], tracks[:, 5:6], tracks[:, 6:7]], 1)
            r.track_ids = tracks[:, 4].astype(int)
        else:
            r.track_ids = np.zeros((0,), int)
        yield r
