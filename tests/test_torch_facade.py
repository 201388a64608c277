"""Port parity: the inference facade (``YOLO(...).predict``: sources, the
host letterbox, forward, decode, NMS, boxes mapped back, ``Results``)
against the JAX ``Model.predict`` on the CPU.

vil_yolon with 3 classes at 96 px, the same weights on both sides (JAX
init, seeded noise, the head shaped as in ``test_torch_val``), the port's
model written as a checkpoint and read back by ``YOLO(path)`` (and
``Model.save`` of that gives the same weights again). Sources:
the JAX synthetic set's val directory (JPEG, read through cv2 on both
sides) and an RGB ndarray that is not square. Each image's boxes, scores
and classes (as a set: many scores saturate at 1, so their order is not
defined) within 1e-3 of JAX's (fp32; the letterbox does not resize at
these sizes, so the inputs are equal), ``Boxes.xywhn`` / ``xyxyn`` within
1e-5 of JAX's ``Boxes``; the boxes lie inside the image.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from test_torch_model import _perturb
from test_torch_val import NC, shape_head
from xlstm_yolo_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from xlstm_yolo_tpu.engine.model import Model as JaxModel
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_tpu.utils.callbacks import default_callbacks as jax_callbacks
from xlstm_yolo_torch import YOLO
from xlstm_yolo_torch.data.imgproc import imread
from xlstm_yolo_torch.engine.results import Results
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.checkpoint import save_checkpoint
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

IMGSZ = 96
NAMES = {0: "rect", 1: "circle", 2: "triangle"}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX Model, port YOLO, val image directory) on the same weights."""
    root = tmp_path_factory.mktemp("facade")
    jax_synthetic(root, n_train=1, n_val=3, imgsz=IMGSZ)
    jm = JaxTaskModel("vil_yolon.yaml", nc=NC, verbose=False)
    v = shape_head(_perturb(jax.jit(lambda: jm.init(0, imgsz=IMGSZ))(), seed=1), seed=5)
    tm = load_jax_variables(TaskModel("vil_yolon.yaml", nc=NC, device="cpu"), flatten_variables(v))
    tm.names = dict(NAMES)
    ours = YOLO(save_checkpoint(root / "w.pt", tm), device="cpu")
    again = YOLO(ours.save(root / "w2.pt"), device="cpu")
    for a, b in zip(again.model.state_dict().values(), tm.state_dict().values()):
        assert torch.equal(a, b)
    # the JAX facade around the same variables (its constructor would also
    # initialize an 80-class model eagerly, which the CPU takes a minute for)
    theirs = JaxModel.__new__(JaxModel)
    jm.names = dict(NAMES)
    theirs.model, theirs.variables, theirs.predictor = jm, v, None
    theirs.callbacks, theirs.task = jax_callbacks(), "detect"
    return theirs, ours, root / "images" / "val"


def _check(got, want):
    assert len(got) == len(want) and all(isinstance(r, Results) for r in got)
    n_boxes = 0
    for g, w in zip(got, want):
        assert g.orig_shape == tuple(w.orig_shape) and g.path == w.path
        # the same detections, as sets: many scores saturate at 1, so the
        # order among them is not defined; each row pairs with its nearest
        dist = np.abs(g.boxes.data[:, None] - w.boxes.data[None]).max(-1)
        pair = dist.argmin(1)
        assert len(g) == len(w) and sorted(pair) == list(range(len(w)))
        np.testing.assert_allclose(g.boxes.data, w.boxes.data[pair], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g.boxes.xywhn, w.boxes.xywhn[pair], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g.boxes.xyxyn, w.boxes.xyxyn[pair], rtol=0, atol=1e-5)
        h, wd = g.orig_shape
        xyxy = g.boxes.xyxy
        assert (xyxy >= 0).all() and (xyxy[:, [0, 2]] <= wd).all() and (xyxy[:, [1, 3]] <= h).all()
        assert g.names == NAMES and g.verbose()
        n_boxes += len(g)
    assert n_boxes > 0


def test_predict_directory_matches_jax(models):
    theirs, ours, val_dir = models
    want = theirs.predict(str(val_dir), imgsz=IMGSZ, verbose=False)
    got = ours.predict(val_dir, imgsz=IMGSZ)
    _check(got, want)
    assert len(got) == 3


def test_results_summaries_match_jax(models, tmp_path):
    """``summary`` / ``to_json`` and ``save_txt`` (YOLO-format lines) of a
    ``Results`` against JAX's on the same detections."""
    from xlstm_yolo_tpu.engine.results import Results as JaxResults

    _, ours, val_dir = models
    got = ours.predict(val_dir, imgsz=IMGSZ)[0]
    want = JaxResults(got.orig_img, path=got.path, names=NAMES, boxes=got.boxes.data)
    assert got.summary(normalize=True) == want.summary(normalize=True)
    assert got.to_json() == want.to_json() and got.verbose() == want.verbose()
    got.save_txt(tmp_path / "a.txt", save_conf=True)
    want.save_txt(tmp_path / "b.txt", save_conf=True)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text() != ""


def test_predict_array_matches_jax(models):
    theirs, ours, val_dir = models
    img = imread(sorted(Path(val_dir).iterdir())[0])[8:88]  # 80 x 96, padded to 96
    want = theirs.predict(img, imgsz=IMGSZ, verbose=False)
    got = ours(img, imgsz=IMGSZ)
    _check(got, want)
    assert got[0].orig_shape == (80, 96) and got[0].path == "array0"
