"""Port parity: the rest of the detect task's surface against the JAX
package on the CPU, on vil_yolon with 3 classes at 64 px (the port's
seeded init as a JAX tree, seeded noise, the head shaped as in
``test_torch_val``, ``load_jax_variables``):

* ``Validator(rect=True, save_json=True)`` with the default suppression
  on wide and tall PNGs written as in ``test_torch_val_rect`` (P3 8 x 12 /
  12 x 8 tokens: grids that are not square and no multiple of the
  chunk), against the JAX
  ``Validator``, with that file's tolerances (the PNGs are that file's)
  but the scores' in ``predictions.json``: within 1e-4, not 1e-5 (the two
  CPU forwards of the ViL layers sum in other orders: 2e-5 seen);
* ``Predictor(classes=, agnostic_nms=)`` through ``Model.predict(stream=True)``
  against the JAX ``Predictor``: each image's boxes within 1e-3 px, scores
  within 1e-4, the classes kept only after NMS;
* ``Model.info`` equal to JAX's string; ``Model.fuse`` against JAX's fused
  variables (the folded weights to 1e-6, the candidates within 1e-4 of
  their scale) and against the unfused model's boxes (1e-3 px); ``Model.embed`` against JAX's (1e-4 of
  each vector's scale); ``load`` and ``reset_weights`` round trips
  (exactly);
* ``mosaic_n`` 3 and 9: ``mosaic3`` / ``mosaic9`` against JAX's
  ``mosaic3_points`` / ``mosaic9_points`` on the same images (labels to
  1e-4 px, images within the resize's tolerance of ``test_torch_data``:
  a level, on at most 0.5% of the values) and the train batches through
  the dataset against JAX's (``test_torch_data``'s tolerances for the
  augmented batches);
* ``profile=True``: a trace with exactly three ``train_step`` spans (two
  when the run has two steps), and the same losses and weights as
  without it; ``plots=True`` writes the last validation's PNGs; the
  ``box`` / ``cls`` / ``dfl`` gains weight the loss.
"""
import csv
import types

import numpy as np
import pytest
import torch

import jax

from test_torch_model import _perturb
from test_torch_val import shape_head
from test_torch_val_rect import (NC, NAMES, PNGS, check_validations, jax_variables_of,
                                 mixed_ar_dataset, validate_both, write_own_labels)
from xlstm_yolo_tpu.cfg import get_cfg as jax_get_cfg
from xlstm_yolo_tpu.data import augment as JA
from xlstm_yolo_tpu.data.dataset import build_dataloader as jax_build_dataloader
from xlstm_yolo_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from xlstm_yolo_tpu.engine.model import Model as JaxModel
from xlstm_yolo_tpu.engine.predictor import Predictor as JaxPredictor
from xlstm_yolo_tpu.nn.fuse import fuse_conv_bn as jax_fuse
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_tpu.utils.callbacks import default_callbacks as jax_callbacks
from xlstm_yolo_torch import YOLO
from xlstm_yolo_torch.data import augment as A
from xlstm_yolo_torch.data.dataset import build_dataloader
from xlstm_yolo_torch.engine.predictor import Predictor
from xlstm_yolo_torch.engine.trainer import Trainer, read_step_trace
from xlstm_yolo_torch.nn.modules import ConvBN
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.checkpoint import save_checkpoint
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables
from xlstm_yolo_torch.utils.loss import detection_loss

IMGSZ = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work while it runs (the
    suite runs test files in parallel processes), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(JAX Model facade, port YOLO, dataset YAML, dataset root) on the same
    weights, the val labels the model's own jittered detections."""
    root = tmp_path_factory.mktemp("keys")
    data = mixed_ar_dataset(root, IMGSZ, n_wide=4, n_tall=4, n_square=0)  # two buckets
    jm = JaxTaskModel("vil_yolon.yaml", nc=NC, verbose=False)
    v0 = jax_variables_of(jm, TaskModel("vil_yolon.yaml", nc=NC, device="cpu"), IMGSZ)
    v = shape_head(_perturb(v0, seed=2), seed=7)
    tm = load_jax_variables(TaskModel("vil_yolon.yaml", nc=NC, device="cpu"), flatten_variables(v))
    jm.names = tm.names = dict(enumerate(NAMES))
    write_own_labels(tm, data, IMGSZ, root)
    ours = YOLO(save_checkpoint(root / "w.pt", tm), device="cpu")
    # the JAX facade around the same variables (its constructor would
    # initialize an 80-class model eagerly, a minute on the CPU)
    theirs = JaxModel.__new__(JaxModel)
    theirs.model, theirs.variables, theirs.predictor = jm, v, None
    theirs.callbacks, theirs.task = jax_callbacks(), "detect"
    return theirs, ours, data, root


def test_rect_validation_matches_jax(case, tmp_path):
    theirs, ours, data, _ = case
    check_validations(*validate_both(theirs.model, theirs.variables, ours.model, data, IMGSZ,
                                     tmp_path, plots=False), pngs=set(), score_tol=1e-4)


def _pair_boxes(got, want):
    """Each port row against its nearest JAX row (max over box px and
    score / 1e-1): the same rows, as sets."""
    assert got.shape == want.shape
    if not len(got):
        return
    d = np.abs(got[:, None, :5] - want[None, :, :5]).max(-1)
    pair = d.argmin(1)
    assert sorted(pair) == list(range(len(want)))
    np.testing.assert_allclose(got[:, :4], want[pair, :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:, 4], want[pair, 4], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[:, 5], want[pair, 5])


def test_predict_classes_agnostic_stream_match_jax(case):
    theirs, ours, _, root = case
    files = [root / "images" / "val" / f"{i}.png" for i in (0, 2, 5, 7)]
    kw = dict(imgsz=IMGSZ, conf=0.05, classes=[0, 2], agnostic_nms=True, verbose=False)
    want = JaxPredictor(theirs.model, theirs.variables, **kw)([str(f) for f in files])
    gen = ours.predict(files, stream=True, **kw)
    assert isinstance(gen, types.GeneratorType)
    got = list(gen)
    assert [r.path for r in got] == [r.path for r in want] and len(got) == 4
    n = 0
    for g, w in zip(got, want):
        _pair_boxes(g.boxes.data, np.asarray(w.boxes.data))
        assert set(g.boxes.cls.astype(int)) <= {0, 2}
        n += len(g)
    assert n > 0
    # the same images without the class filter hold class-1 boxes: it filters
    everything = ours.predict(files, **{**kw, "classes": None})
    assert any((r.boxes.cls == 1).any() for r in everything)
    # the save flags are ported; what stays unported is named
    with pytest.raises(ValueError, match="video, stream and screen"):
        Predictor(ours.model, vid_stride=2)


def test_info_matches_jax(case):
    theirs, ours, _, _ = case
    assert ours.info() == theirs.info()
    assert "detect model" in ours.info() and "nc=3" in ours.info()


def test_fuse_matches_jax_fused(case):
    """The folded weights equal the JAX ``fuse_conv_bn``'s (read through a
    port model loaded with the JAX fused variables, whose BatchNorms are
    then identities), and so do the candidates; the boxes of a prediction
    stay within 1e-3 px of the unfused model's."""
    theirs, _, _, root = case
    ours = YOLO(root / "w.pt", device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3))
                         .astype(np.float32))
    with torch.no_grad():
        unfused = ours.model.eval().predictions(x)
    files = [root / "images" / "val" / f"{i}.png" for i in (1, 6)]
    before = ours.predict(files, imgsz=IMGSZ, conf=0.05, verbose=False)
    assert ours.predictor is not None and ours.fuse() is ours and ours.predictor is None
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in ours.model.modules())
    folded = load_jax_variables(TaskModel("vil_yolon.yaml", nc=NC, device="cpu"),
                                flatten_variables(jax_fuse(theirs.variables))).eval()
    mine = dict(ours.model.named_modules())
    n = 0
    for name, m in folded.named_modules():
        if isinstance(m, ConvBN):
            f = mine[name]
            for got, want in ((f.conv.weight, m.conv.weight), (f.conv.bias, m.bn.bias)):
                assert (got - want).abs().max() <= 1e-6 * want.abs().max(), name
            n += 1
    assert n == sum(isinstance(m, ConvBN) for m in ours.model.modules()) > 30
    with torch.no_grad():
        got, want = ours.model.predictions(x), folded.predictions(x)
    for sl in (np.s_[..., :4], np.s_[..., 4:]):
        assert (got[sl] - want[sl]).abs().max() <= 1e-4 * want[sl].abs().max()
    assert (got - unfused)[..., :4].abs().max() <= 1e-3
    after = ours.predict(files, imgsz=IMGSZ, conf=0.05, verbose=False)
    for a, b in zip(after, before):
        _pair_boxes(a.boxes.data, b.boxes.data)


def test_load_and_reset_weights_round_trip(case, tmp_path):
    _, ours, _, root = case
    m = YOLO(root / "w.pt", device="cpu")
    saved = {k: v.clone() for k, v in m.model.state_dict().items()}
    m.predict(root / "images" / "val" / "0.png", imgsz=IMGSZ, verbose=False)
    assert m.reset_weights() is m and m.predictor is None and m.model.names == ours.model.names
    fresh = TaskModel("vil_yolon.yaml", nc=NC, device="cpu", seed=0).state_dict()
    for k, v in m.model.state_dict().items():
        assert torch.equal(v, fresh[k]), k
    assert not all(torch.equal(v, saved[k]) for k, v in m.model.state_dict().items())
    m.model.names = {}
    assert m.load(root / "w.pt") is m and m.model.names == dict(enumerate(NAMES))
    for k, v in m.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    other = YOLO("vil_yolon.yaml", device="cpu")  # 80 classes: the graph does not match
    with pytest.raises(RuntimeError):
        other.load(root / "w.pt")
    with pytest.raises(ValueError, match=".pt"):
        other.load(root / "w.ckpt")


def test_embed_matches_jax(case):
    theirs, ours, _, root = case
    src = [root / "images" / "val" / f"{i}.png" for i in (0, 5, 7)]
    want = theirs.embed([str(s) for s in src], imgsz=IMGSZ)
    got = ours.embed(src, imgsz=IMGSZ)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.ndim == 1
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


# --- mosaic 3 and 9 -------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 9])
def test_mosaic_3_and_9_match_jax(n):
    rng = np.random.default_rng(n)
    imgs, lbs = [], []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(20, 90, 2))
        imgs.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        m = int(rng.integers(0, 4))
        x1, y1 = rng.uniform(0, w / 2, m), rng.uniform(0, h / 2, m)
        lbs.append(np.stack([rng.integers(0, 3, m), x1, y1, x1 + rng.uniform(2, w / 2, m),
                             y1 + rng.uniform(2, h / 2, m)], 1).astype(np.float32))
    fn = JA.mosaic3_points if n == 3 else JA.mosaic9_points
    want_img, want_lb, _ = fn([(im, lb, {}) for im, lb in zip(imgs, lbs)], IMGSZ, None)
    got_img, got_lb = (A.mosaic3 if n == 3 else A.mosaic9)(imgs, lbs, IMGSZ)
    assert got_img.shape == want_img.shape == (2 * IMGSZ, 2 * IMGSZ, 3) and len(want_lb)
    np.testing.assert_allclose(got_lb, want_lb, rtol=0, atol=1e-4)
    d = np.abs(got_img.astype(np.int64) - want_img)
    assert d.max() <= 1 and (d > 0).mean() <= 5e-3


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return jax_synthetic(tmp_path_factory.mktemp("mosaicds"), n_train=8, n_val=2, imgsz=96)


@pytest.mark.parametrize("n", [3, 9])
def test_mosaic_n_train_batches_match_jax(synthetic, n):
    hyp = {**vars(jax_get_cfg()), "mosaic_n": n}
    kw = dict(batch=4, imgsz=96, hyp=hyp, max_labels=16, seed=3)
    jl, _ = jax_build_dataloader(synthetic, "train", **kw)
    tl, _ = build_dataloader(synthetic, "train", **kw)
    jl.ds.uint8_images = tl.ds.uint8_images = True
    n_boxes, levels = 0, []
    for jb, tb in zip(list(jl), list(tl)):
        np.testing.assert_array_equal(tb["mask"], jb["mask"])
        np.testing.assert_allclose(tb["cls_boxes"], jb["cls_boxes"], rtol=0, atol=1e-3)
        levels.append(np.abs(tb["img"].astype(np.int64) - jb["img"]).reshape(-1))
        n_boxes += int(tb["mask"].sum())
    assert n_boxes > 8
    levels = np.concatenate(levels)
    assert levels.max() <= 2 and (levels > 1).mean() <= 1e-4 and (levels > 0).mean() <= 1e-3


# --- profile, plots and the loss gains in the trainer ----------------------------

def _train(data, project, name, **kw):
    model = TaskModel("yolov8n.yaml", nc=NC, device="cpu")
    tr = Trainer(model, overrides={"data": data, "epochs": 1, "batch": 2, "imgsz": IMGSZ,
                                   "device": "cpu", "project": str(project), "name": name,
                                   "seed": 0, "workers": 0, "close_mosaic": 0, **kw})
    tr.train()
    with open(tr.save_dir / "results.csv") as f:
        return tr, list(csv.DictReader(f))


def test_profile_traces_three_steps_and_plots_write(synthetic, tmp_path):
    """8 images at batch 2: 4 steps, the first 3 traced; the losses and the
    final weights as without the trace; the last validation's plots."""
    traced, rows = _train(synthetic, tmp_path, "traced", profile=True, plots=True)
    plain, rows0 = _train(synthetic, tmp_path, "plain", profile=False, plots=False)
    assert traced.trace.path == traced.save_dir / "profile" / "trace.json"
    assert read_step_trace(traced.trace.path)["spans"] == 3 and plain.trace.path is None
    assert not (plain.save_dir / "profile").exists()
    for k in ("train/box", "train/cls", "train/dfl", "train/loss", "metrics/mAP50"):
        assert rows[0][k] == rows0[0][k], k
    for a, b in zip(traced.model.state_dict().values(), plain.model.state_dict().values()):
        assert torch.equal(a, b)
    assert PNGS <= {p.name for p in traced.save_dir.glob("*.png")}
    assert not list(plain.save_dir.glob("*.png"))
    assert traced.step.gains == (7.5, 0.5, 1.5)  # the keys' defaults, to the loss


def test_profile_of_a_shorter_run_ends_with_it(tmp_path):
    data = jax_synthetic(tmp_path / "ds", n_train=4, n_val=1, imgsz=96)
    tr, _ = _train(data, tmp_path, "short", profile=True, val=False)
    assert read_step_trace(tr.trace.path)["spans"] == 2


def test_loss_gains_weight_the_terms():
    """The ``box`` / ``cls`` / ``dfl`` keys reach the loss (the JAX step
    reads them from its hyp)."""
    g = torch.Generator().manual_seed(0)
    maps = [(torch.randn(2, 64, s, s, generator=g), torch.randn(2, NC, s, s, generator=g))
            for s in (8, 4, 2)]
    cb = torch.tensor([[[1.0, 4, 6, 30, 40], [2, 20, 10, 60, 50]]] * 2)
    mask = torch.ones(2, 2, dtype=torch.bool)
    base = detection_loss(maps, cb, mask, (8, 16, 32))
    other = detection_loss(maps, cb, mask, (8, 16, 32), gains=(1.0, 2.0, 3.0))
    torch.testing.assert_close(other.box, base.box / 7.5, rtol=1e-6, atol=0)
    torch.testing.assert_close(other.cls, base.cls * 4.0, rtol=1e-6, atol=0)
    torch.testing.assert_close(other.dfl, base.dfl * 2.0, rtol=1e-6, atol=0)
