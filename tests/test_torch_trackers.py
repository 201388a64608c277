"""Port parity: multi-object tracking (``xlstm_yolo_torch.trackers`` and
``Model.track``) against the JAX package on the CPU.

* The Kalman filters, and ``BYTETracker`` and ``BOTSORT(gmc_method="none")``
  over seeded detection sequences (6 objects on random walks, low-confidence
  frames, an occlusion of 5 frames, births and deaths, 40 frames), both id
  counters reset: ids equal and boxes within 1e-9 (the same float64 numpy).
* ``GMC("sparseOptFlow")`` in numpy against the JAX ``GMC`` on cv2, at
  ``downscale`` 1 and 2, on seeded textured frame pairs (shifts of up to 8
  px at the working size, whole and sub-pixel, a 1 degree rotation, a 1.02
  scale): the translation within 0.25 px and the 2 x 2 part within 5e-3 of
  cv2's, the known motion within 1.5 px (``tests/test_trackers.py``'s
  bound), at least 90% of ``cv2.goodFeaturesToTrack``'s corners found within
  0.5 px, the working gray frame equal to cv2's.
* ``BOTSORT`` with ``sparseOptFlow`` on a panned sequence: ids equal to
  JAX's, boxes within 0.5 px; a run in a fresh process imports no cv2.
* ``orb``, ``sift`` and ``ecc`` (cv2 in both) equal to JAX's, and an
  ``ImportError`` naming cv2 without it; ``create_tracker``; the track
  columns of ``Boxes`` and ``OBB``; a detection of zero height, which the
  JAX tracker fails on and ``track_results`` leaves out.
* ``Model.track`` on ViL-YOLO-n at 64 px (the port's seeded weights as the
  JAX tree, seeded noise, the head shaped as ``test_torch_val``'s with its
  class biases raised by 3, ``load_jax_variables``) over 6 frames, as an
  array list and as a PNG folder: each frame's detections within 1e-4 of
  JAX's (relative to the largest value), no score within 1e-4 of a tracker
  threshold, then track ids equal and boxes within 1e-3 px.

cv2 runs here only on the JAX side, as its reference.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import yaml

from test_torch_detect_zoo import jax_task_model
from test_torch_model import _perturb
from test_torch_val import shape_head
from test_torch_val_rect import jax_variables_of, lift_class_biases
from torch_tracker_frames import panned_sequence, texture
from xlstm_yolo_tpu.cfg import load_model_yaml as jax_load_model_yaml
from xlstm_yolo_tpu.engine.model import Model as JaxModel
from xlstm_yolo_tpu.engine.predictor import Predictor as JaxPredictor
from xlstm_yolo_tpu.engine.results import OBB as JaxOBB
from xlstm_yolo_tpu.engine.results import Boxes as JaxBoxes
from xlstm_yolo_tpu.trackers import BOTSORT as JaxBOTSORT
from xlstm_yolo_tpu.trackers import BYTETracker as JaxBYTETracker
from xlstm_yolo_tpu.trackers import create_tracker as jax_create_tracker
from xlstm_yolo_tpu.trackers.bot_sort import GMC as JaxGMC
from xlstm_yolo_tpu.trackers.byte_tracker import STrack as JaxSTrack
from xlstm_yolo_tpu.trackers.kalman import KalmanFilterXYAH as JaxXYAH
from xlstm_yolo_tpu.trackers.kalman import KalmanFilterXYWH as JaxXYWH
from xlstm_yolo_tpu.utils.callbacks import default_callbacks as jax_callbacks
from xlstm_yolo_torch import YOLO
from xlstm_yolo_torch.data.imgproc import imwrite, warp_affine
from xlstm_yolo_torch.engine.predictor import Predictor
from xlstm_yolo_torch.engine.results import OBB, Boxes
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.trackers import BOTSORT, BYTETracker, create_tracker
from xlstm_yolo_torch.trackers.bot_sort import GMC, good_features
from xlstm_yolo_torch.trackers.byte_tracker import STrack
from xlstm_yolo_torch.trackers.kalman import KalmanFilterXYAH, KalmanFilterXYWH
from xlstm_yolo_torch.utils.checkpoint import save_checkpoint
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

REPO = Path(__file__).resolve().parents[1]
THRESHOLDS = (0.1, 0.25)  # conf and track_low_thresh; track_high / new_track_thresh
NEAR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- detection sequences ------------------------------------------------------

def detection_sequence(seed: int, n_frames: int = 40) -> list:
    """(n, 6) x1 y1 x2 y2 conf cls per frame: 6 objects on random walks, two
    born late and two dying early, object 1 occluded for frames 12-16,
    object 2 at low confidence for frames 20-24, every object at low
    confidence in frame 33, and a low-confidence clutter box now and then.
    No score lies near a threshold."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(60, 540, (6, 2))
    vel = rng.normal(0, 3, (6, 2))
    size = rng.uniform(25, 70, (6, 2))
    born, dies = (0, 0, 0, 0, 8, 15), (40, 40, 31, 40, 40, 26)
    frames = []
    for f in range(n_frames):
        vel += rng.normal(0, 0.6, vel.shape)
        pos += vel
        rows = []
        for i in range(6):
            if not born[i] <= f < dies[i] or (i == 1 and 12 <= f <= 16):
                continue
            c = pos[i] + rng.normal(0, 1.0, 2)
            wh = size[i] * rng.uniform(0.95, 1.05, 2)
            low = (i == 2 and 20 <= f <= 24) or f == 33
            conf = rng.uniform(0.13, 0.22) if low else rng.uniform(0.4, 0.95)
            rows.append([*(c - wh / 2), *(c + wh / 2), conf, i % 3])
        if rng.random() < 0.3:
            c = rng.uniform(0, 600, 2)
            rows.append([*(c - 15), *(c + 15), rng.uniform(0.11, 0.2), 1])
        frames.append(np.asarray(rows, np.float32).reshape(-1, 6))
    scores = np.concatenate([d[:, 4] for d in frames])
    assert min(np.abs(scores - t).min() for t in THRESHOLDS) > NEAR
    return frames


def run_tracker(tracker, frames, images=None) -> list:
    return [tracker.update(d, None if images is None else images[i]).copy()
            for i, d in enumerate(frames)]


def assert_tracks_equal(got, want, atol):
    assert len(got) == len(want)
    n = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 4], w[:, 4])
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
        n += len(g)
    assert n > 0


@pytest.mark.parametrize("name", ["bytetrack", "botsort_none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_trackers_match_jax_on_detection_sequences(name, seed):
    frames = detection_sequence(seed)
    JaxSTrack.reset_id()
    STrack.reset_id()
    if name == "bytetrack":
        theirs, ours = JaxBYTETracker(), BYTETracker()
    else:
        theirs, ours = JaxBOTSORT(gmc_method="none"), BOTSORT(gmc_method="none")
    want = run_tracker(theirs, frames)
    got = run_tracker(ours, frames)
    assert_tracks_equal(got, want, atol=1e-9)
    ids = {int(i) for g in got for i in g[:, 4]}
    assert len(ids) >= 6  # births and re-identifications made new ids
    for a, b in (("tracked_stracks", "tracked_stracks"), ("lost_stracks", "lost_stracks"),
                 ("removed_stracks", "removed_stracks")):
        assert ([t.track_id for t in getattr(ours, a)]
                == [t.track_id for t in getattr(theirs, b)]), a


def test_kalman_filters_match_jax():
    rng = np.random.default_rng(4)
    for ours, theirs, z0 in ((KalmanFilterXYAH(), JaxXYAH(), [50.0, 60.0, 0.7, 30.0]),
                             (KalmanFilterXYWH(), JaxXYWH(), [50.0, 60.0, 21.0, 30.0])):
        m1, c1 = ours.initiate(np.asarray(z0))
        m2, c2 = theirs.initiate(np.asarray(z0))
        for t in range(12):
            m1, c1 = ours.predict(m1, c1)
            m2, c2 = theirs.predict(m2, c2)
            z = np.asarray(z0) + [3 * t, -t, 0, 0] + rng.normal(0, 0.5, 4)
            m1, c1 = ours.update(m1, c1, z)
            m2, c2 = theirs.update(m2, c2, z)
            np.testing.assert_array_equal(m1, m2)
            np.testing.assert_array_equal(c1, c2)
        pm1, pc1 = ours.project(m1, c1)
        pm2, pc2 = theirs.project(m2, c2)
        np.testing.assert_array_equal(pm1, pm2)
        np.testing.assert_array_equal(pc1, pc2)


# -- camera motion ------------------------------------------------------------

def motion(kind: str, value, center) -> np.ndarray:
    """The 2 x 3 affine of a frame's coordinates into the next frame's."""
    cx, cy = center
    if kind == "shift":
        return np.asarray([[1.0, 0.0, value[0]], [0.0, 1.0, value[1]]])
    a = np.deg2rad(value) if kind == "rotate" else 0.0
    s = value if kind == "scale" else 1.0
    A = s * np.asarray([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return np.concatenate([A, (np.asarray([cx, cy]) - A @ [cx, cy])[:, None]], 1)


def frame_pair(M: np.ndarray, h: int, w: int, seed: int = 0) -> tuple:
    """(frame, the frame moved by ``M``) cut from the middle of a larger
    texture; the move is the port's exact ``warp_affine``."""
    canvas = texture(h + 80, w + 80, seed)
    o = np.asarray([40.0, 40.0])
    Mc = np.concatenate([M[:, :2], (M[:, 2] + o - M[:, :2] @ o)[:, None]], 1)
    moved = warp_affine(canvas, Mc, (w + 80, h + 80))
    return canvas[40:40 + h, 40:40 + w], moved[40:40 + h, 40:40 + w]


MOTIONS = [("shift", (8, -5)), ("shift", (-3, 7)), ("shift", (2.5, -6.25)),
           ("shift", (-7.75, 1.5)), ("rotate", 1.0), ("scale", 1.02)]


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("kind,value", MOTIONS)
def test_gmc_sparse_flow_matches_cv2(kind, value, downscale):
    import cv2

    h, w = 240 * downscale, 320 * downscale
    if kind == "shift":
        value = tuple(v * downscale for v in value)  # the shift at the working size
    M = motion(kind, value, ((w - 1) / 2, (h - 1) / 2))
    f1, f2 = frame_pair(M, h, w, seed=3)
    ours, theirs = GMC("sparseOptFlow", downscale=downscale), JaxGMC("sparseOptFlow",
                                                                     downscale=downscale)
    np.testing.assert_array_equal(ours.apply(f1), theirs.apply(f1))  # the identity
    np.testing.assert_array_equal(ours.prev_gray, theirs.prev_gray)
    gray = ours.prev_gray
    want_pts = cv2.goodFeaturesToTrack(gray, maxCorners=200, qualityLevel=0.01,
                                       minDistance=10).reshape(-1, 2)
    got_pts = good_features(gray).reshape(-1, 2)
    dist = np.sqrt(((want_pts[:, None] - got_pts[None]) ** 2).sum(-1)).min(1)
    assert (dist <= 0.5).mean() >= 0.9, (dist <= 0.5).mean()
    got, want = ours.apply(f2), theirs.apply(f2)
    assert np.abs(got[:, 2] - want[:, 2]).max() <= 0.25, (got, want)
    assert np.abs(got[:, :2] - want[:, :2]).max() <= 5e-3, (got, want)
    assert np.abs(got[:, 2] - M[:, 2]).max() <= 1.5 and np.abs(want[:, 2] - M[:, 2]).max() <= 1.5
    assert np.abs(got[:, :2] - M[:, :2]).max() <= 5e-3


@pytest.mark.parametrize("method", ["orb", "sift", "ecc"])
def test_gmc_cv2_methods_match_jax(method):
    f1, f2 = frame_pair(motion("shift", (6, -4), (0, 0)), 200, 300, seed=1)
    ours, theirs = GMC(method, downscale=2), JaxGMC(method, downscale=2)
    for f in (f1, f2):
        got, want = ours.apply(f), theirs.apply(f)
        np.testing.assert_array_equal(got, want)
    assert abs(got[0, 2] - 6) < 1.5 and abs(got[1, 2] + 4) < 1.5
    np.testing.assert_array_equal(GMC("none").apply(f1), np.eye(2, 3))
    with pytest.raises(ValueError):
        GMC("bogus")


def test_gmc_cv2_methods_name_cv2_when_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # an import of cv2 fails
    for method in ("orb", "sift", "ecc"):
        with pytest.raises(ImportError, match="cv2"):
            GMC(method)
    assert GMC("sparseOptFlow").method == "sparseOptFlow"


def test_botsort_sparse_flow_on_a_pan_matches_jax():
    frames, dets = panned_sequence()
    JaxSTrack.reset_id()
    STrack.reset_id()
    want = run_tracker(JaxBOTSORT(), dets, frames)
    got = run_tracker(BOTSORT(), dets, frames)
    assert_tracks_equal(got, want, atol=0.5)
    assert sorted(got[-1][:, 4].astype(int).tolist()) == [1, 2, 3, 4]  # ids persist


def test_botsort_sparse_flow_imports_no_cv2():
    code = ("import sys\n"
            "from torch_tracker_frames import run\n"
            "out = run()\n"
            "assert len(out) == 4, out\n"
            "assert 'cv2' not in sys.modules, 'cv2 was imported'\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": f"{REPO}:{REPO / 'tests'}",
                               "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-2000:]


def test_track_results_skips_zero_area_detections():
    """A box clipped to nothing at the frame's edge (height 0): the JAX
    tracker takes it and fails on the next frame's assignment (NaN costs);
    the port's ``track_results`` passes the tracker only boxes of positive
    area, so its tracks equal JAX's tracker on the other boxes."""
    from xlstm_yolo_tpu.engine.results import Results as JaxResults
    from xlstm_yolo_tpu.trackers import track_results as jax_track_results
    from xlstm_yolo_torch.engine.results import Results
    from xlstm_yolo_torch.trackers import track_results
    from xlstm_yolo_torch.trackers.track import trackable

    img = np.zeros((60, 80, 3), np.uint8)
    frames = [np.asarray([[10, 0, 30, 0, 0.9, 0], [40, 20, 60, 45, 0.8, 1]],
                         np.float32) + [f, 0, f, 0, 0, 0] for f in range(4)]
    assert all(len(trackable(d)) == 1 for d in frames)
    got = list(track_results(BYTETracker(), (Results(img, boxes=d) for d in frames)))
    want = run_tracker(JaxBYTETracker(), [trackable(d) for d in frames])
    for r, w in zip(got, want):
        np.testing.assert_array_equal(r.track_ids, w[:, 4].astype(int))
        np.testing.assert_allclose(r.boxes.data, np.concatenate([w[:, :4], w[:, 5:]], 1),
                                   rtol=0, atol=1e-9)
    with pytest.raises(ValueError), np.errstate(all="ignore"):
        list(jax_track_results(JaxBYTETracker(), (JaxResults(img, boxes=d) for d in frames)))


def test_create_tracker_matches_jax(tmp_path):
    for name in ("bytetrack.yaml", "botsort", "bytetrack"):
        ours, theirs = create_tracker(name), jax_create_tracker(name)
        assert type(ours).__name__ == type(theirs).__name__
        assert {k: v for k, v in vars(ours).items() if isinstance(v, (int, float, str, bool))} \
            == {k: v for k, v in vars(theirs).items() if isinstance(v, (int, float, str, bool))}
    cfg = tmp_path / "mine.yaml"
    cfg.write_text(yaml.safe_dump({"tracker_type": "botsort", "track_buffer": 60,
                                   "gmc_method": "none", "match_thresh": 0.7}))
    ours, theirs = create_tracker(str(cfg)), jax_create_tracker(str(cfg))
    assert isinstance(ours, BOTSORT) and ours.max_time_lost == theirs.max_time_lost == 60
    assert ours.match_thresh == 0.7 and ours.gmc.method is None
    for fn in (create_tracker, jax_create_tracker):
        with pytest.raises(ValueError):
            fn("nope")


def test_track_columns_of_boxes_and_obb_match_jax():
    rng = np.random.default_rng(0)
    for cols, ours_t, theirs_t in ((6, Boxes, JaxBoxes), (7, Boxes, JaxBoxes),
                                   (7, OBB, JaxOBB), (8, OBB, JaxOBB)):
        data = rng.uniform(1, 50, (5, cols)).astype(np.float32)
        for d in (data, data[:0]):
            ours, theirs = ours_t(d, (60, 80)), theirs_t(d, (60, 80))
            assert ours.is_track == theirs.is_track and ours.data.shape == theirs.data.shape
            for attr in ("conf", "cls", "id"):
                g, w = getattr(ours, attr), getattr(theirs, attr)
                assert (g is None) == (w is None)
                if w is not None:
                    np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        Boxes(np.zeros((2, 5)), (10, 10))
    with pytest.raises(ValueError):
        OBB(np.zeros((2, 9)), (10, 10))


# -- Model.track --------------------------------------------------------------

TRACK_IMGSZ, TRACK_NC = 64, 3


class _LowOptJit:
    """The JAX predictor's ``_device_fn`` compiled at XLA's lowest backend
    optimization level, once per (settings, image shape) in this module."""

    cache = {}

    def __init__(self, pred):
        self.pred = pred

    def __call__(self, variables, x):
        p = self.pred
        key = (p.conf, p.iou, p.max_det, p.half, p.agnostic, x.shape)
        if key not in self.cache:
            self.cache[key] = jax.jit(p._device_fn).lower(variables, x).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return self.cache[key](variables, x)


@pytest.fixture
def low_opt_predictor(monkeypatch):
    init = JaxPredictor.__init__

    def patched(self, *a, **k):
        init(self, *a, **k)
        self._jit = _LowOptJit(self)

    monkeypatch.setattr(JaxPredictor, "__init__", patched)


def scene_frames(n: int = 6, h: int = 48, w: int = 64, seed: int = 2) -> list:
    """RGB frames of a texture with three bright squares moving across it."""
    base = texture(h, w, seed)
    frames = []
    for f in range(n):
        img = base.copy()
        for k, (x, y) in enumerate([(4 + 3 * f, 6), (40 - 2 * f, 20 + f), (20, 30 - f)]):
            img[y:y + 12, x:x + 12] = (240 - 40 * k, 60 + 70 * k, 200)
        frames.append(img)
    return frames


@pytest.fixture(scope="module")
def track_models(tmp_path_factory):
    """(JAX Model, port YOLO, JAX variables, port model, frames, PNG folder)
    on the same weights."""
    root = tmp_path_factory.mktemp("track")
    tm = TaskModel("vil_yolon.yaml", nc=TRACK_NC, device="cpu")
    jm = jax_task_model(*jax_load_model_yaml("vil_yolon.yaml"), tm.strides, nc=TRACK_NC)
    v = lift_class_biases(shape_head(_perturb(jax_variables_of(jm, tm, TRACK_IMGSZ), seed=7),
                                     seed=5), 3.0)
    load_jax_variables(tm, flatten_variables(v))
    tm.eval()
    ours = YOLO(save_checkpoint(root / "w.pt", tm), device="cpu")
    theirs = JaxModel.__new__(JaxModel)
    theirs.model, theirs.variables, theirs.predictor = jm, v, None
    theirs.callbacks, theirs.task = jax_callbacks(), "detect"
    frames = scene_frames()
    folder = root / "frames"
    folder.mkdir()
    for i, f in enumerate(frames):
        imwrite(folder / f"{i:03d}.png", f)
    return theirs, ours, v, tm, frames, folder


@pytest.mark.parametrize("source", ["arrays", "folder"])
def test_model_track_matches_jax(track_models, low_opt_predictor, source):
    theirs, ours, v, tm, frames, folder = track_models
    src = frames if source == "arrays" else folder
    want_det = JaxPredictor(theirs.model, v, imgsz=TRACK_IMGSZ, conf=0.1, verbose=False)(
        src if source == "arrays" else str(folder))
    got_det = Predictor(tm, imgsz=TRACK_IMGSZ, conf=0.1, verbose=False)(src)
    n = 0
    for g, w in zip(got_det, want_det, strict=True):
        gd, wd = g.boxes.data, np.asarray(w.boxes.data)
        assert gd.shape == wd.shape
        np.testing.assert_allclose(gd, wd, rtol=0, atol=NEAR * np.abs(wd).max(initial=1.0))
        for t in THRESHOLDS:
            assert (np.abs(wd[:, 4] - t) > NEAR).all(), f"a score within {NEAR} of {t}"
        n += len(gd)
    assert n > 0
    JaxSTrack.reset_id()
    want = theirs.track(src if source == "arrays" else str(folder), imgsz=TRACK_IMGSZ,
                        verbose=False)
    got = ours.track(src, imgsz=TRACK_IMGSZ, stream=source == "folder", verbose=False)
    got = list(got)
    assert len(got) == len(want) == len(frames)
    n_ids = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.track_ids, w.track_ids)
        np.testing.assert_allclose(g.boxes.data, np.asarray(w.boxes.data), rtol=0, atol=1e-3)
        assert g.boxes.id is None and w.boxes.id is None  # the ids are r.track_ids, as in JAX
        n_ids += len(g.track_ids)
    assert n_ids > 0
