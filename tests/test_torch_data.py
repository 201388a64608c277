"""Port parity: the data path on the host, against cv2 and the JAX package.

* ``data.imgproc`` against ``cv2`` (5.0 here), per op: ``resize``
  (INTER_LINEAR, up and down) within one level, equal on every pixel when
  shrinking and on all but 0.5% when enlarging (cv2's vectorized
  enlargement rounds a few sums the other way); ``warp_affine`` with
  border 114 equal on every pixel (OpenCV 5 computes it in fp32, as the
  port); ``warp_perspective`` within one level on all but 0.01%;
  ``rgb2hsv`` equal on every colour; ``hsv2rgb`` within one level on all
  but 0.05% (cv2's fp32 sector formula, truncated as its vectorized loop
  does; that loop takes rows in blocks of 32 pixels and converts the rest
  of a row with a scalar formula that rounds instead, so the tests use
  widths that are multiples of 32, as the data path's canvases are); the
  HSV gains through their LUTs within one level on all but 0.05%; the
  letterbox (the JAX one, on cv2) within one level and its labels and meta equal; PNG and BMP
  decoding equal to ``cv2.imread``; PNG and BMP written then read back
  equal; a JPEG read (by the port's native decoder) as ``cv2`` reads it for
  the JAX package.
* ``utils.metrics`` against ``xlstm_yolo_tpu.utils.metrics`` on seeded
  random detections: within 1e-12.
* The dataset on the JAX synthetic set (JPEG, 96 px), the same seed:
  - the no-augment val batches (the JAX loader's native C++ letterbox):
    images within one level, ``cls_boxes`` within 1e-4 px, ``mask``,
    ``ori_shape`` and ``im_idx`` equal;
  - the augment train batches (mosaic, perspective, HSV, flip; threads
    with per-sample generators as the JAX trainer's ``workers``, and one
    shared generator; two epochs): ``cls_boxes`` within 1e-3 px, ``mask``
    equal, and images within two levels, within one on all but 0.01% of
    the values and equal on all but 0.1% (the ops that are not equal are
    ``hsv2rgb`` at one level and the rare warp position that fp32 rounds
    the other way at one level, which the HSV gains can stretch to two).
"""
import cv2
import numpy as np
import pytest

from xlstm_yolo_tpu.cfg import get_cfg as jax_get_cfg
from xlstm_yolo_tpu.data import augment as JA
from xlstm_yolo_tpu.data.dataset import build_dataloader as jax_build_dataloader
from xlstm_yolo_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from xlstm_yolo_tpu.utils import metrics as JM
from xlstm_yolo_torch.data import augment as TA
from xlstm_yolo_torch.data import imgproc as ip
from xlstm_yolo_torch.data.dataset import build_dataloader
from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset
from xlstm_yolo_torch.utils import metrics as TM


def _image(h, w, seed=0):
    """A smooth seeded RGB image (noise blurred): interpolation differences
    stay in the low bits, as on real images."""
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 2)


def _levels(got, want):
    """(largest difference in levels, share of values that differ)."""
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("size,share", [((64, 48), 0.0), ((45, 33), 0.0), ((200, 150), 5e-3),
                                        ((262, 194), 5e-3), ((131, 97), 0.0), ((65, 48), 0.0)])
def test_resize_matches_cv2(size, share):
    img = _image(97, 131)
    want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    worst, differ = _levels(ip.resize(img, size), want)
    assert worst <= 1 and differ <= share, (worst, differ)


def test_resize_exact_halving_is_cv2_area_mean():
    img = np.random.default_rng(1).integers(0, 256, (100, 120, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ip.resize(img, (60, 50)),
                                  cv2.resize(img, (60, 50), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("angle,scale,tx,ty", [(0.0, 0.73, 12.3, -7.1), (17.0, 1.2, -20.5, 30.25),
                                               (-40.0, 0.5, 60.0, 10.0)])
def test_warp_affine_matches_cv2(angle, scale, tx, ty):
    img = _image(97, 131, seed=2)
    M = TA.rotation_matrix(angle, scale)
    M[:, 2] = tx, ty
    np.testing.assert_array_equal(M[:, :2], cv2.getRotationMatrix2D((0, 0), angle, scale)[:, :2])
    want = cv2.warpAffine(img, M, (150, 110), borderValue=(114, 114, 114))
    np.testing.assert_array_equal(ip.warp_affine(img, M, (150, 110)), want)


def test_warp_perspective_matches_cv2():
    img = _image(97, 131, seed=3)
    M = np.array([[0.9, 0.05, 3.0], [0.02, 1.1, -4.0], [1e-4, -2e-4, 1.0]])
    want = cv2.warpPerspective(img, M, (150, 110), borderValue=(114, 114, 114))
    worst, differ = _levels(ip.warp_perspective(img, M, (150, 110)), want)
    assert worst <= 1 and differ <= 1e-4, (worst, differ)


def _all_colours(step=5):
    """Every RGB colour (blue in steps of ``step``) as a 256-wide image:
    cv2 converts images wider than a pixel in its vectorized loop."""
    g = np.meshgrid(np.arange(256), np.arange(0, 256, step), np.arange(256), indexing="ij")
    return np.ascontiguousarray(np.stack(g, -1).reshape(-1, 256, 3).astype(np.uint8))


def test_hsv_round_trip_matches_cv2():
    rgb = _all_colours()
    hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
    np.testing.assert_array_equal(ip.rgb2hsv(rgb), hsv)
    worst, differ = _levels(ip.hsv2rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    assert worst <= 1 and differ <= 5e-4, (worst, differ)
    every = np.stack(np.meshgrid(np.arange(180), np.arange(0, 256, 3), np.arange(256),
                                 indexing="ij"), -1).reshape(-1, 256, 3).astype(np.uint8)
    worst, differ = _levels(ip.hsv2rgb(every), cv2.cvtColor(every, cv2.COLOR_HSV2RGB))
    assert worst <= 1 and differ <= 5e-4, (worst, differ)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_hsv_gains_match_jax(seed):
    img = _image(64, 96, seed=seed)
    want = JA.random_hsv(img, 0.015, 0.7, 0.4, np.random.default_rng(seed))
    got = TA.random_hsv(img, 0.015, 0.7, 0.4, np.random.default_rng(seed))
    worst, differ = _levels(got, want)
    assert worst <= 1 and differ <= 5e-4, (worst, differ)


@pytest.mark.parametrize("shape,new,scaleup", [((54, 81), 64, True), ((96, 70), 64, False),
                                               ((40, 30), 96, True), ((60, 80), (64, 96), True)])
def test_letterbox_matches_jax(shape, new, scaleup):
    img = _image(*shape, seed=4)
    labels = np.array([[1, 3.5, 4.0, 20.0, 30.5], [0, 10.0, 2.0, 25.0, 40.0]], np.float32)
    want_img, want_lb, want_meta = JA.letterbox(img, new, labels, scaleup=scaleup)
    got_img, got_lb, got_meta = TA.letterbox(img, new, labels, scaleup=scaleup)
    worst, _ = _levels(got_img, want_img)
    assert worst <= 1 and got_img.shape == want_img.shape
    np.testing.assert_array_equal(got_lb, want_lb)
    assert got_meta == want_meta


def _png_variants(tmp_path):
    img = _image(37, 53, seed=5)
    out = {"rgb": img[..., ::-1], "gray": img[..., 0],
           "rgba": np.concatenate([img[..., ::-1], img[..., :1]], -1)}
    paths = []
    for name, arr in out.items():
        for level in (0, 9):
            p = tmp_path / f"{name}{level}.png"
            cv2.imwrite(str(p), arr, [cv2.IMWRITE_PNG_COMPRESSION, level])
            paths.append(p)
    from PIL import Image

    pal = tmp_path / "palette.png"
    Image.fromarray(img).convert("P").save(pal)
    return paths + [pal]


def test_png_and_bmp_reader_match_cv2(tmp_path):
    paths = _png_variants(tmp_path)
    img = _image(37, 53, seed=5)
    for name, arr in (("c.bmp", img[..., ::-1]), ("g.bmp", img[..., 0])):
        cv2.imwrite(str(tmp_path / name), arr)
        paths.append(tmp_path / name)
    for p in paths:
        np.testing.assert_array_equal(ip.imread(p), cv2.imread(str(p))[..., ::-1], err_msg=str(p))


def test_png_and_bmp_write_then_read(tmp_path):
    img = _image(41, 29, seed=6)
    for suffix in (".png", ".bmp"):
        p = ip.imwrite(tmp_path / f"x{suffix}", img)
        np.testing.assert_array_equal(ip.imread(p), img)
        np.testing.assert_array_equal(cv2.imread(str(p))[..., ::-1], img)
    gray = img[..., 1]
    np.testing.assert_array_equal(ip.imread(ip.imwrite(tmp_path / "g.png", gray)),
                                  np.repeat(gray[..., None], 3, axis=2))


def test_jpeg_goes_through_cv2_and_missing_files_raise(tmp_path):
    img = _image(30, 40, seed=7)
    p = tmp_path / "a.jpg"
    cv2.imwrite(str(p), img[..., ::-1])
    np.testing.assert_array_equal(ip.imread(p), cv2.imread(str(p))[..., ::-1])
    with pytest.raises(FileNotFoundError):
        ip.imread(tmp_path / "missing.png")


def test_synthetic_dataset_writes_non_square_png(tmp_path):
    y = make_synthetic_dataset(tmp_path, n_train=3, n_val=2, imgsz=64, width=80, height=60)
    files = sorted((tmp_path / "images" / "train").glob("*.png"))
    assert len(files) == 3 and ip.imread(files[0]).shape == (60, 80, 3)
    loader, d = build_dataloader(y, "val", batch=2, imgsz=64, augment=False)
    batch = next(iter(loader))
    assert d["nc"] == 3 and batch["img"].shape == (2, 64, 64, 3)
    assert batch["mask"].any() and (batch["ori_shape"] == [60, 80]).all()


def _detections(rng, n_img=6, nc=4):
    """Seeded detections and ground truth with IoU-diverse overlaps."""
    out = []
    for _ in range(n_img):
        gt = rng.uniform(0, 60, (rng.integers(1, 6), 2))
        gt = np.concatenate([gt, gt + rng.uniform(5, 30, gt.shape)], 1)
        gt_cls = rng.integers(0, nc, len(gt)).astype(np.float64)
        n = rng.integers(0, 12)
        pick = rng.integers(0, len(gt), n)
        det = gt[pick] + rng.normal(0, 3, (n, 4))
        cls = np.where(rng.random(n) < 0.8, gt_cls[pick], rng.integers(0, nc, n))
        out.append((np.concatenate([det, rng.random((n, 1)), cls[:, None]], 1), gt, gt_cls))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
    cm_t, cm_j = TM.ConfusionMatrix(4), JM.ConfusionMatrix(4)
    for det, gt, gt_cls in _detections(rng):
        iou_t, iou_j = TM.box_iou_np(gt, det[:, :4]), JM.box_iou_np(gt, det[:, :4])
        np.testing.assert_allclose(iou_t, iou_j, rtol=0, atol=1e-12)
        tp = TM.match_predictions(det[:, 5], gt_cls, iou_t)
        np.testing.assert_array_equal(tp, JM.match_predictions(det[:, 5], gt_cls, iou_j))
        cm_t.process_batch(det, gt, gt_cls)
        cm_j.process_batch(det, gt, gt_cls)
        for k, v in zip(stats, (tp, det[:, 4], det[:, 5], gt_cls)):
            stats[k].append(v)
    np.testing.assert_array_equal(cm_t.matrix, cm_j.matrix)
    args = [np.concatenate(stats[k]) for k in stats]
    got, want = TM.ap_per_class(*args), JM.ap_per_class(*args)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)
    assert got["map50"] > 0.1
    assert TM.fitness(got["map50"], got["map"]) == JM.fitness(want["map50"], want["map"])


@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
    return jax_synthetic(tmp_path_factory.mktemp("jaxds"), n_train=8, n_val=6, imgsz=96)


def test_val_batches_match_jax(jax_dataset):
    kw = dict(batch=4, imgsz=96, augment=False, max_labels=16)
    jl, _ = jax_build_dataloader(jax_dataset, "val", **kw)
    tl, _ = build_dataloader(jax_dataset, "val", **kw)
    tl.ds.uint8_images = True
    pairs = list(zip(jl, tl))
    assert len(pairs) == 2 and len(pairs[1][1]["img"]) == 2  # the tail batch is kept
    for jb, tb in pairs:
        worst, _ = _levels(tb["img"], np.rint(np.asarray(jb["img"]) * 255.0))
        assert worst <= 1
        np.testing.assert_allclose(tb["cls_boxes"], jb["cls_boxes"], rtol=0, atol=1e-4)
        for k in ("mask", "ori_shape", "im_idx"):
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("workers", [0, 2])
def test_augmented_train_batches_match_jax(jax_dataset, workers):
    hyp = dict(vars(jax_get_cfg()))
    kw = dict(batch=4, imgsz=96, hyp=hyp, max_labels=16, seed=3, workers=workers)
    jl, _ = jax_build_dataloader(jax_dataset, "train", **kw)
    tl, _ = build_dataloader(jax_dataset, "train", **kw)
    jl.ds.uint8_images = tl.ds.uint8_images = True
    n_boxes, levels = 0, []
    for epoch in range(2):  # the shuffle is seeded per epoch
        for jb, tb in zip(list(jl), list(tl)):
            np.testing.assert_array_equal(tb["mask"], jb["mask"])
            np.testing.assert_allclose(tb["cls_boxes"], jb["cls_boxes"], rtol=0, atol=1e-3)
            levels.append(np.abs(tb["img"].astype(np.int64) - jb["img"]).reshape(-1))
            n_boxes += int(tb["mask"].sum())
    assert jl.epoch == tl.epoch == 2 and n_boxes > 8
    levels = np.concatenate(levels)
    assert levels.max() <= 2 and (levels > 1).mean() <= 1e-4 and (levels > 0).mean() <= 1e-3
