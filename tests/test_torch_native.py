"""Port parity: the native image path (``xlstm_yolo_torch.native``), the
val loader's native batches and the bundled dataset descriptors, against
the JAX package on the CPU.

* ``letterbox_batch`` equal to the JAX library's bit for bit on seeded
  images of several shapes, with ``scaleup`` on and off and 1 and 4
  threads; ``hsv_inplace`` equal too; the JAX test's bound against cv2's
  letterbox (``tests/test_native.py``: metas within 0.51, mean difference
  under 5e-3) and its ``scaleup`` gains.
* The port's non-rect val ``Loader`` on the JAX synthetic set (JPEG, 96 px)
  against the JAX loader, which takes its native path there: ``img`` equal
  bit for bit, ``cls_boxes`` within 1e-6 px, ``mask``, ``ori_shape`` and
  ``im_idx`` equal, ``native_batches`` > 0; a world dataset's native batch
  carries the same texts as JAX's; without g++ the loader assembles the
  batches in Python (within one level of the native ones) and counts
  none; a failed build raises with g++'s output.
* Each of the 30 bundled dataset names through both ``check_det_dataset``:
  the same ``names`` and ``nc``.
"""
import ctypes
from pathlib import Path

import numpy as np
import pytest

from xlstm_yolo_tpu import native as jax_native
from xlstm_yolo_tpu.data.augment import letterbox as jax_letterbox
from xlstm_yolo_tpu.data.dataset import build_dataloader as jax_build_dataloader
from xlstm_yolo_tpu.data.dataset import check_det_dataset as jax_check_det_dataset
from xlstm_yolo_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from xlstm_yolo_torch import native
from xlstm_yolo_torch.data.dataset import DATASETS_DIR, build_dataloader, check_det_dataset

SHAPES = [(60, 80), (97, 31), (200, 150), (64, 64), (411, 633), (1, 5)]
NAMES = sorted(p.name for p in (Path(__file__).resolve().parents[1] / "xlstm_yolo_tpu" / "cfg"
                                / "datasets").glob("*.yaml"))


def seeded_images(seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SHAPES]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("scaleup", [True, False])
def test_letterbox_batch_equals_the_jax_library(scaleup, threads):
    imgs = seeded_images()
    for imgsz in (96, 320):
        got, got_m = native.letterbox_batch(imgs, imgsz, n_threads=threads, scaleup=scaleup)
        want, want_m = jax_native.letterbox_batch(imgs, imgsz, n_threads=threads,
                                                  scaleup=scaleup)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_m, want_m)


def test_hsv_inplace_equals_the_jax_library():
    lib = jax_native.get_lib()
    for i, img in enumerate(seeded_images(1)):
        gains = (0.5 + 0.2 * i, 1.4 - 0.1 * i, 0.8 + 0.05 * i)
        got, want = img.copy(), img.copy()
        native.hsv_inplace(got, *gains)
        lib.hsv_inplace(want.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), want.shape[0],
                        want.shape[1], *gains)
        np.testing.assert_array_equal(got, want)
        assert (got != img).any()
    with pytest.raises(ValueError):
        native.hsv_inplace(np.zeros((4, 4, 3), np.float32), 1, 1, 1)


def test_letterbox_batch_near_cv2():
    yy, xx = np.mgrid[0:411, 0:633]
    img = np.stack([xx % 256, yy % 256, (xx + yy) % 256], -1).astype(np.uint8)
    out, metas = native.letterbox_batch([img], 320)
    ref, _, (r, px, py) = jax_letterbox(img, 320)
    np.testing.assert_allclose(metas[0], [r, px, py], atol=0.51)
    assert np.abs(out[0] - ref.astype(np.float32) / 255.0).mean() < 5e-3
    small = np.zeros((100, 200, 3), np.uint8)
    assert native.letterbox_batch([small], 320, scaleup=False)[1][0, 0] == 1.0
    assert native.letterbox_batch([small], 320, scaleup=True)[1][0, 0] == pytest.approx(1.6)


@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
    return jax_synthetic(tmp_path_factory.mktemp("nativeds"), n_train=2, n_val=7, imgsz=96)


@pytest.mark.parametrize("batch", [3, 4])
def test_val_loader_native_batches_equal_jax(jax_dataset, batch):
    kw = dict(batch=batch, imgsz=96, augment=False, max_labels=16)
    jl, _ = jax_build_dataloader(jax_dataset, "val", **kw)
    tl, _ = build_dataloader(jax_dataset, "val", **kw)
    pairs = list(zip(jl, tl, strict=True))
    assert tl.native_batches == len(pairs) == -(-7 // batch)
    for jb, tb in pairs:
        assert tb["img"].dtype == np.float32
        np.testing.assert_array_equal(tb["img"], jb["img"])
        np.testing.assert_allclose(tb["cls_boxes"], jb["cls_boxes"], rtol=0, atol=1e-6)
        for k in ("mask", "ori_shape", "im_idx"):
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert sum(int(tb["mask"].sum()) for _, tb in pairs) > 0


def test_world_native_batch_carries_texts(jax_dataset):
    kw = dict(batch=4, imgsz=96, max_labels=16, task="world",
              text_cfg=dict(seed=3, neg_samples=(1, 2), max_samples=4))
    jl, _ = jax_build_dataloader(jax_dataset, "val", **kw)
    tl, _ = build_dataloader(jax_dataset, "val", **kw)
    for jb, tb in zip(jl, tl, strict=True):
        assert tb["texts"] == jb["texts"] and all(tb["texts"])
        np.testing.assert_array_equal(tb["img"], jb["img"])
        np.testing.assert_array_equal(tb["mask"], jb["mask"])
        np.testing.assert_allclose(tb["cls_boxes"], jb["cls_boxes"], rtol=0, atol=1e-6)
    assert tl.native_batches == 2


def test_without_gxx_the_loader_collates_in_python(jax_dataset, monkeypatch):
    kw = dict(batch=4, imgsz=96, augment=False, max_labels=16)
    want = list(build_dataloader(jax_dataset, "val", **kw)[0])
    monkeypatch.setenv("PATH", "")
    assert not native.available()
    tl, _ = build_dataloader(jax_dataset, "val", **kw)
    got = list(tl)
    assert tl.native_batches == 0 and len(got) == len(want)
    for g, w in zip(got, want):
        assert np.abs(g["img"] - w["img"]).max() <= 1.0 / 255 + 1e-6
        np.testing.assert_allclose(g["cls_boxes"], w["cls_boxes"], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(g["mask"], w["mask"])


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build_library(bad, tmp_path / "out")
    assert "error" in str(e.value)
    assert not list((tmp_path / "out").glob("*.so"))


@pytest.mark.parametrize("name", NAMES)
def test_bundled_dataset_names_match_jax(name):
    assert (DATASETS_DIR / name).exists()
    got, want = check_det_dataset(name), jax_check_det_dataset(name)
    assert got["names"] == want["names"] and got["nc"] == want["nc"]
