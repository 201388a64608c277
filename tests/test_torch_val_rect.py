"""Port parity: rect validation (aspect-ratio buckets), ``save_json``,
``plots`` and ``exact_nms`` of the ``Validator``, and the data path under
them, against the JAX package on the CPU.

A YOLO-format set of PNGs written with the port's ``imwrite``: wide (h =
w / 2), tall and square images whose long side is the validation size, so
that neither side resizes and the letterboxed inputs are equal (as in
``tests/test_rect.py``). Held, each with its tolerance:

* the image shapes read from the headers equal Pillow's (exactly) and are
  cached beside the label cache; the rect buckets (``rect_groups``) equal
  the JAX ``_set_rectangle``'s at several batch sizes (exactly); two
  ``Loader``s of different batch sizes on one dataset each keep their own
  buckets; a rect batch equals the JAX rect loader's (images exactly,
  boxes to 1e-4 px); a shuffled rect loader is refused;
* ``Validator(rect=True, save_json=True, plots=True)`` on yolov8n with 3
  classes at 96 px (buckets of 4, 4 and a short 3), the same weights on
  both sides (the port's seeded init as a JAX tree, seeded noise,
  ``load_jax_variables``)
  and the model's own jittered detections as labels, against the JAX
  ``Validator``: mAP50 and mAP50-95 to 1e-6 (precision and recall, read
  off a confidence grid by interpolation, to 1e-4), the confusion matrix equal,
  ``predictions.json`` the same records (boxes within 1e-3 px, scores
  within 1e-5), the same PNG names; with ``exact_nms``;
* ``_pred_to_json`` at a bucket longer than the load size, the COCO class
  map, ``smooth`` and the plotted curves (to 1e-6 of JAX's), and a missing
  matplotlib: one warning that names the files, no PNG written.
"""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from test_torch_model import _perturb
from test_torch_val import shape_head
from xlstm_yolo_tpu.data.converter import coco80_to_coco91_class as jax_coco91
from xlstm_yolo_tpu.data.dataset import YOLODataset as JaxDataset
from xlstm_yolo_tpu.data.dataset import build_dataloader as jax_build_dataloader
from xlstm_yolo_tpu.engine.validator import Validator as JaxValidator
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_tpu.utils import metrics as JMET
from xlstm_yolo_tpu.utils import plotting as JPLT
from xlstm_yolo_torch.data.converter import coco80_to_coco91_class
from xlstm_yolo_torch.data.dataset import Loader, YOLODataset, build_dataloader, check_det_dataset
from xlstm_yolo_torch.data.imgproc import imwrite
from xlstm_yolo_torch.engine.validator import Validator
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils import metrics as MET
from xlstm_yolo_torch.utils import plotting as PLT
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables, torch_name

NC, IMGSZ = 3, 96
NAMES = ["a", "b", "c"]
PNGS = {"PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png", "confusion_matrix.png",
        "confusion_matrix_normalized.png"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work while it runs (the
    suite runs test files in parallel processes), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mixed_ar_dataset(root: Path, base: int, n_wide=5, n_tall=5, n_square=2, seed=0) -> str:
    """Wide (base/2 x base), tall and square PNGs with one bright box each,
    labelled, as ``tests/test_rect.py`` writes them; returns the YAML."""
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        shapes = ([(base // 2, base)] * n_wide + [(base, base // 2)] * n_tall
                  + [(base, base)] * n_square)
        for i, (h, w) in enumerate(shapes):
            img = rng.integers(0, 40, (h, w, 3)).astype(np.uint8) + 40
            bw, bh = w // 3, h // 3
            cx = int(rng.integers(bw // 2 + 2, w - bw // 2 - 2))
            cy = int(rng.integers(bh // 2 + 2, h - bh // 2 - 2))
            img[cy - bh // 2:cy + bh // 2, cx - bw // 2:cx + bw // 2] = 220
            imwrite(root / "images" / split / f"{i}.png", img)
            (root / "labels" / split / f"{i}.txt").write_text(
                f"0 {cx / w:.6f} {cy / h:.6f} {bw / w:.6f} {bh / h:.6f}\n")
    yml = root / "data.yaml"
    yml.write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnc: {NC}\n"
                   f"names: {NAMES}\n")
    return str(yml)


def write_own_labels(model, data: str, imgsz: int, root: Path, seed: int = 3) -> None:
    """The model's own detections (conf 0.05, up to 16 an image), in each
    image's pixels through the port's ``save_json``, jittered (5% of the
    size and a pixel at 96 px), as the val labels."""
    out = Validator(model, imgsz=imgsz, batch=4, rect=True, save_json=True, conf=0.05,
                    max_det=16, save_dir=root / "own")(data)
    recs = json.loads(Path(out["save_json_path"]).read_text())
    rng = np.random.default_rng(seed)
    lbl_dir = root / "labels" / "val"
    for lbl in lbl_dir.glob("*.txt"):
        w0, h0 = Image.open(root / "images" / "val" / f"{lbl.stem}.png").size
        lines = []
        for r in (r for r in recs if str(r["image_id"]) == lbl.stem):
            x, y, bw, bh = r["bbox"]
            box = np.array([x, y, x + bw, y + bh]) + np.array([bw, bh, bw, bh]) * rng.uniform(
                -0.05, 0.05, 4) * [-1, -1, 1, 1] + rng.uniform(-1, 1, 4) * imgsz / 96
            box = np.clip(box, 0, [w0, h0, w0, h0])
            if box[2] - box[0] >= 2 and box[3] - box[1] >= 2:
                lines.append(f"{r['category_id'] - 1} {(box[0] + box[2]) / 2 / w0:.6f} "
                             f"{(box[1] + box[3]) / 2 / h0:.6f} {(box[2] - box[0]) / w0:.6f} "
                             f"{(box[3] - box[1]) / h0:.6f}")
        lbl.write_text("\n".join(lines or ["1 0.5 0.5 0.25 0.25"]) + "\n")
    for cache in lbl_dir.parent.parent.rglob("labels_*.cache.npz"):
        cache.unlink()


def jax_variables_of(jm, tm, imgsz: int):
    """The JAX variable tree of ``jm`` holding the port model ``tm``'s
    seeded init (the JAX init scheme), through ``torch_name``'s layouts run
    backwards: the tree's structure from ``jax.eval_shape`` (a jitted JAX
    init costs ten seconds on the CPU)."""
    state = tm.state_dict()

    def leaf(path, sds):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        idx = np.arange(int(np.prod(sds.shape))).reshape(sds.shape)
        name, where = torch_name(key, idx)
        out = np.empty(idx.size, np.float32)
        out[where.reshape(-1)] = state[name].numpy().reshape(-1)
        return out.reshape(sds.shape)

    abstract = jax.eval_shape(lambda: jm.init(0, imgsz=imgsz))
    return jax.tree_util.tree_map_with_path(leaf, abstract)


def lift_class_biases(variables, by: float):
    """``shape_head``'s class biases raised by ``by`` (its -9 leaves
    yolov8n's scores below 0.011 here)."""
    def leaf(path, x):
        keys = [getattr(k, "key", "") for k in path]
        cls_bias = keys[-1] == "bias" and keys[-2].startswith("cv3_") and keys[-2].endswith("_2")
        return x + by if cls_bias else x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def validate_both(jm, v, tm, data, imgsz, tmp: Path, plots: bool = True, **kw):
    """(JAX result, JAX validator, port result, port validator) of one
    rect validation with ``save_json`` (and ``plots``), each in its own
    directory."""
    jv = JaxValidator(jm, imgsz=imgsz, batch=4, rect=True, save_json=True, plots=plots,
                      save_dir=str(tmp / "jax"), **kw)
    want = jv(v, data)
    tv = Validator(tm, imgsz=imgsz, batch=4, rect=True, save_json=True, plots=plots,
                   save_dir=tmp / "port", **kw)
    got = tv(data)
    return want, jv, got, tv


def check_validations(want, jv, got, tv, pngs=PNGS, score_tol: float = 1e-5):
    """The contract of the module docstring: metrics, matrix (counted with
    ``plots``), records (scores within ``score_tol``), PNGs."""
    assert set(got) == set(want)
    assert got["images"] == want["images"]
    for k in ("mAP50", "mAP50-95", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    # read off the confidence grid by interpolation: the scores' last bits move them
    for k in ("precision", "recall"):
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    # not degenerate: the seeded heads' boxes spill past the small images,
    # whose labels are clipped to them, so the IoUs and the mAPs stay low
    assert got["mAP50"] >= 0.1 and 0.03 <= got["mAP50-95"] < got["mAP50"], got
    if jv.cm is not None:
        np.testing.assert_array_equal(tv.cm.matrix, jv.cm.matrix)
    g = json.loads(Path(got["save_json_path"]).read_text())
    w = json.loads(Path(want["save_json_path"]).read_text())
    assert len(g) == len(w) > 0

    # records pair by image, class and nearest (box, score) in units of the
    # tolerances (near-equal scores have no defined order; boxes in the
    # padding clip to the same zero-area box)
    groups = {}
    for side, recs in enumerate((g, w)):
        for r in recs:
            groups.setdefault((str(r["image_id"]), r["category_id"]), ([], []))[side].append(
                [*r["bbox"], r["score"]])
    for a, b in groups.values():
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        scale = np.array([1e-3] * 4 + [score_tol])
        pair = (np.abs(a[:, None] - b[None]) / scale).max(-1).argmin(1)
        assert sorted(pair) == list(range(len(b)))
        # one step of the records' rounding (3 decimals for boxes, 5 for scores)
        np.testing.assert_allclose(a[:, :4], b[pair, :4], rtol=0, atol=1e-3 + 1e-9)
        np.testing.assert_allclose(a[:, 4], b[pair, 4], rtol=0, atol=score_tol + 1e-9)
    assert pngs == {p.name for p in Path(got["save_json_path"]).parent.glob("*.png")}
    assert pngs == {p.name for p in Path(want["save_json_path"]).parent.glob("*.png")}


@pytest.fixture(scope="module")
def rect_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("rect")
    return root, mixed_ar_dataset(root, IMGSZ)


# --- shapes, buckets, loaders ------------------------------------------------

def test_image_shapes_from_headers_are_cached(rect_data):
    root, data = rect_data
    d = check_det_dataset(data)
    ds = YOLODataset(d["val"], imgsz=IMGSZ, rect=True)
    want = np.array([Image.open(f).size[::-1] for f in ds.files])
    np.testing.assert_array_equal(ds.image_shapes(), want)
    cache = Path(d["val"]) / "labels_detect.cache.npz.shapes.npz"
    assert cache.exists()
    np.testing.assert_array_equal(YOLODataset(d["val"], imgsz=IMGSZ).image_shapes(), want)
    # the JAX dataset reads the same shapes (its own cache, the same file)
    jds = JaxDataset(d["val"], imgsz=IMGSZ, rect=True, batch=4)
    np.testing.assert_array_equal(jds._image_shapes(d["val"]), want)
    # an image replaced in place is read again
    other = root / "other"
    for sub in ("images", "labels"):
        (other / sub / "val").mkdir(parents=True)
    for f in ds.files[:2]:
        imwrite(other / "images" / "val" / Path(f).name, np.zeros((40, 24, 3), np.uint8))
    assert YOLODataset(str(other / "images" / "val"), imgsz=IMGSZ).image_shapes().tolist() == [
        [40, 24]] * 2
    imwrite(other / "images" / "val" / Path(ds.files[0]).name, np.zeros((8, 24, 3), np.uint8))
    assert YOLODataset(str(other / "images" / "val"), imgsz=IMGSZ).image_shapes().tolist() == [
        [8, 24], [40, 24]]


@pytest.mark.parametrize("batch", [2, 4, 5, 12])
def test_rect_buckets_match_jax(rect_data, batch):
    _, data = rect_data
    d = check_det_dataset(data)
    want = JaxDataset(d["val"], imgsz=IMGSZ, rect=True, batch=batch, stride=32).rect_batches
    got = YOLODataset(d["val"], imgsz=IMGSZ, rect=True, stride=32).rect_batches(batch)
    assert got == want
    assert sum(len(g) for g, _ in got) == 12
    assert all(h % 32 == 0 and w % 32 == 0 for _, (h, w) in got)


def test_two_loaders_keep_their_own_buckets(rect_data):
    """The JAX ``Loader`` re-buckets the shared dataset when its batch size
    differs; the port's keep theirs."""
    _, data = rect_data
    d = check_det_dataset(data)
    ds = YOLODataset(d["val"], imgsz=IMGSZ, rect=True)
    a = Loader(ds, 4, shuffle=False, drop_last=False)
    b = Loader(ds, 5, shuffle=False, drop_last=False)
    first = [(x["im_idx"].tolist(), x["img"].shape[1:3]) for x in a]
    other = [(x["im_idx"].tolist(), x["img"].shape[1:3]) for x in b]
    again = [(x["im_idx"].tolist(), x["img"].shape[1:3]) for x in a]
    assert first == again == [(i, hw) for i, hw in ds.rect_batches(4)]
    assert other == [(i, hw) for i, hw in ds.rect_batches(5)] and len(b) == 3
    with pytest.raises(ValueError, match="shuffle"):
        Loader(ds, 4, shuffle=True)


def test_rect_batches_match_jax_loader(rect_data):
    _, data = rect_data
    jl, _ = jax_build_dataloader(data, "val", batch=4, imgsz=IMGSZ, max_labels=8, rect=True)
    tl, _ = build_dataloader(data, "val", batch=4, imgsz=IMGSZ, max_labels=8, rect=True)
    jl.ds.uint8_images = tl.ds.uint8_images = True
    n = 0
    for jb, tb in zip(jl, tl):
        np.testing.assert_array_equal(tb["img"], jb["img"])
        np.testing.assert_array_equal(tb["mask"], jb["mask"])
        np.testing.assert_allclose(tb["cls_boxes"], jb["cls_boxes"], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tb["im_idx"], jb["im_idx"])
        np.testing.assert_array_equal(tb["ori_shape"], jb["ori_shape"])
        n += 1
    assert n == len(tl) == len(jl) == 3


# --- the Validator against JAX ----------------------------------------------------

@pytest.fixture(scope="module")
def yolo_case(tmp_path_factory):
    """(JAX model, its variables, port model, dataset YAML) with the val
    labels taken from the model."""
    root = tmp_path_factory.mktemp("rectval")
    data = mixed_ar_dataset(root, IMGSZ, n_tall=4)  # buckets of 4, 4 and a short 3
    jm = JaxTaskModel("yolov8n.yaml", nc=NC, verbose=False)
    v0 = jax_variables_of(jm, TaskModel("yolov8n.yaml", nc=NC, device="cpu"), IMGSZ)
    v = lift_class_biases(shape_head(_perturb(v0, seed=0), seed=7), 4.0)
    tm = load_jax_variables(TaskModel("yolov8n.yaml", nc=NC, device="cpu"), flatten_variables(v))
    jm.names = tm.names = dict(enumerate(NAMES))
    write_own_labels(tm, data, IMGSZ, root)
    return jm, v, tm, data


def test_rect_validation_with_json_plots_and_exact_nms_matches_jax(yolo_case, tmp_path):
    """yolov8n with the greedy suppression (``exact_nms``); the default
    suppression is held on vil_yolon in ``tests/test_torch_detect_keys.py``."""
    jm, v, tm, data = yolo_case
    check_validations(*validate_both(jm, v, tm, data, IMGSZ, tmp_path, exact_nms=True))


def test_pred_to_json_at_a_bucket_longer_than_the_load():
    """A 672-long bucket against a 640 load: the gain is the load's, and
    the records equal JAX's."""
    rng = np.random.default_rng(0)
    dets = np.concatenate([rng.uniform(0, 600, (6, 2)), rng.uniform(10, 60, (6, 2)),
                           rng.uniform(0, 1, (6, 1)), rng.integers(0, 80, (6, 1))], 1)
    dets[:, 2:4] += dets[:, :2]
    args = (dets, ["000000000139.jpg"], 0, (427, 640), (448, 672), coco80_to_coco91_class())
    got, want = [], []
    Validator._pred_to_json(got, *args, load_sz=640)
    JaxValidator._pred_to_json(want, *args, load_sz=640)
    assert got == want and got[0]["image_id"] == 139
    assert coco80_to_coco91_class() == jax_coco91()


def test_class_map_follows_jax():
    model = SimpleNamespace(nc=NC)  # all ``_class_map`` reads of the model
    for val in ("/d/coco/val2017.txt", "/d/images/val"):
        got = Validator(model)._class_map({"val": val})
        assert got == JaxValidator(model)._class_map({"val": val})
    assert len(Validator(model)._class_map({"val": "coco/val2017.txt"})) == 80


# --- plots ---------------------------------------------------------------------

def test_plotted_arrays_match_jax():
    """``smooth`` and the curves the validator plots, against JAX's."""
    rng = np.random.default_rng(0)
    for n in (7, 100, 1000):
        y = rng.uniform(0, 1, n)
        np.testing.assert_allclose(PLT.smooth(y), JPLT.smooth(y), rtol=0, atol=1e-6)
    tp = rng.random((60, 10)) < 0.6
    conf, pred = rng.uniform(0.05, 0.99, 60), rng.integers(0, 3, 60).astype(float)
    target = rng.integers(0, 3, 40).astype(float)
    got, want = MET.ap_per_class(tp, conf, pred, target), JMET.ap_per_class(tp, conf, pred, target)
    for k in ("px", "prec_values", "f1_curve", "p_curve", "r_curve", "ap50"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_plots_without_matplotlib_warn_once_and_write_nothing(yolo_case, tmp_path,
                                                              monkeypatch, capsys):
    """A missing matplotlib (its import blocked): the confusion matrix is
    still counted, no PNG is written and one warning names the files; with
    ``plots=False`` neither."""
    _, _, tm, data = yolo_case
    ref = Validator(tm, imgsz=IMGSZ, batch=4, rect=True, plots=True, save_dir=tmp_path / "a")
    ref(data)
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not PLT.have_matplotlib()
    v = Validator(tm, imgsz=IMGSZ, batch=4, rect=True, plots=True, save_dir=tmp_path / "b")
    v(data)
    out = capsys.readouterr().out
    assert out.count("WARNING") == 1 and "matplotlib" in out
    assert all(name in out for name in PNGS)
    np.testing.assert_array_equal(v.cm.matrix, ref.cm.matrix)
    assert not list(tmp_path.glob("b/*.png"))
    v(data)  # a validator called again plots again: here, warns again, once
    assert capsys.readouterr().out.count("WARNING") == 1
    with pytest.raises(ImportError, match="PR_curve.png"):
        PLT.plot_pr_curve(np.zeros(3), np.zeros((1, 3)), np.zeros(1), fname=tmp_path / "PR_curve.png")
    Validator(tm, imgsz=IMGSZ, batch=4, plots=False, save_dir=tmp_path / "c")(data)
    assert "WARNING" not in capsys.readouterr().out and not (tmp_path / "c").exists()


def test_results_and_labels_plots(tmp_path):
    """The two host-only plots write their files."""
    csv = tmp_path / "results.csv"
    csv.write_text("epoch,train/loss,metrics/mAP50,note\n0,3.5,0.1,x\n1,3.1,0.2,y\n")
    assert PLT.plot_results(csv) == tmp_path / "results.png" and (tmp_path / "results.png").exists()
    rng = np.random.default_rng(0)
    out = PLT.plot_labels(rng.integers(0, 3, 20).astype(float), rng.uniform(0, 1, (20, 4)),
                          fname=tmp_path / "labels.png")
    assert out.exists() and out.stat().st_size > 0
