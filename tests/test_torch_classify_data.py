"""Port parity: the classify task's data path, against cv2 and the JAX package.

Every comparison here is exact, on uint8:

* the image ops the classify transforms add to ``data.imgproc``, against
  ``cv2`` (5.0 here): ``rgb2gray`` (OpenCV 5's 15-bit fixed point) on every
  colour, ``gaussian_blur3`` (1- and 2-pixel edges included, gray and RGB),
  ``equalize_hist`` (flat images, one value, two values), and
  ``rotation_matrix_2d``; and the ops the transforms share with the
  detect path, made exact for them: ``warp_affine`` (shears, translations
  and rotations, any width: OpenCV 5's vectorized and scalar loops),
  ``resize`` enlarging along both axes (cv2 keeps the row weights at the
  top and bottom edges) and ``hsv2rgb`` on every HSV triple, in both of
  cv2's loops;
* every classify transform of ``data.augment`` against the JAX function
  (on cv2) under one seed: each RandAugment op at two magnitudes,
  ``rand_augment``, ``augmix``, ``autoaugment_imagenet``,
  ``random_erasing``, ``color_jitter``, ``random_resized_crop``,
  ``classify_eval_transform`` and ``classify_train_transform`` with each
  ``auto_augment``;
* ``build_dataloader(task="classify")`` of both packages on a PNG class
  folder set the port writes (``make_classify_dataset``): the class names
  and ``nc``, then two epochs of batches, ``img`` and ``label`` equal, with
  augmentation off and on, on one generator and on threads; and the first
  augmented batch at the default keys pinned by its SHA-256
  (``CLASSIFY_BATCH_SHA256``, which ``chip_smoke.py`` holds the card's
  machine to).
"""
import cv2
import numpy as np
import pytest

from xlstm_yolo_tpu.data import augment as JA
from xlstm_yolo_tpu.data.dataset import ClassificationDataset as JaxClassificationDataset
from xlstm_yolo_tpu.data.dataset import build_dataloader as jax_build_dataloader
from xlstm_yolo_torch.data import augment as TA
from xlstm_yolo_torch.data import imgproc as ip
from xlstm_yolo_torch.data.dataset import ClassificationDataset, build_dataloader
from xlstm_yolo_torch.data.synthetic import make_classify_dataset


def _image(h, w, seed=0, c=3):
    """Seeded noise with a few flat blocks (edges and plateaus)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    for _ in range(3):
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y:y + h // 3, x:x + w // 3] = rng.integers(0, 256, c)
    return img


def _all_colours():
    g = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    return np.ascontiguousarray(np.stack(g, -1).reshape(4096, 4096, 3).astype(np.uint8))


# ---------------------------------------------------------------------------
# image ops against cv2
# ---------------------------------------------------------------------------

def test_rgb2gray_matches_cv2_on_every_colour():
    rgb = _all_colours()
    np.testing.assert_array_equal(ip.rgb2gray(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    for h, w in ((1, 1), (1, 5), (3, 1), (37, 53)):
        img = _image(h, w, seed=h + w)
        np.testing.assert_array_equal(ip.rgb2gray(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("hw", [(1, 1), (1, 2), (2, 1), (2, 2), (1, 7), (7, 1), (2, 9), (37, 53)])
@pytest.mark.parametrize("channels", [1, 3])
def test_gaussian_blur3_matches_cv2(hw, channels):
    img = _image(*hw, seed=hw[0] * 7 + hw[1], c=channels)
    if channels == 1:
        img = img[..., 0]
    np.testing.assert_array_equal(ip.gaussian_blur3(img), cv2.GaussianBlur(img, (3, 3), 0))


def test_equalize_hist_matches_cv2():
    rng = np.random.default_rng(5)
    cases = [np.full((9, 11), 200, np.uint8), np.zeros((1, 1), np.uint8),
             np.full((1, 1), 77, np.uint8)]
    two = np.full((16, 16), 7, np.uint8)
    two[0, 0] = 9
    cases.append(two)
    for h, w in ((2, 2), (17, 29), (64, 96)):
        cases += [rng.integers(0, 256, (h, w), dtype=np.uint8),
                  rng.integers(100, 110, (h, w), dtype=np.uint8),
                  (rng.random((h, w)) * rng.random() * 255).astype(np.uint8)]
    for img in cases:
        np.testing.assert_array_equal(ip.equalize_hist(img), cv2.equalizeHist(img))


def test_rotation_matrix_2d_matches_cv2():
    for center, angle, scale in (((32.0, 24.0), 8.1, 1.0), ((50.5, 11.0), -27.0, 1.0),
                                 ((10, 10), 0.0, 1.0), ((3, 4), 90.0, 0.7), ((0, 0), 200.0, 1.3)):
        np.testing.assert_array_equal(ip.rotation_matrix_2d(center, angle, scale),
                                      cv2.getRotationMatrix2D(center, angle, scale))


@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_matches_cv2_exactly(seed):
    """Shears, translations and rotations (fp32 and fp64 matrices) into
    outputs of every width class: a multiple of the vectorized loop's 16
    pixels, and a scalar tail."""
    for t in range(12):
        r = np.random.default_rng(100 * seed + t)
        h, w = int(r.integers(1, 90)), int(r.integers(1, 150))
        img = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if t % 3 == 0:
            M = cv2.getRotationMatrix2D((w / 2, h / 2), float(r.uniform(-45, 45)),
                                        float(r.uniform(0.5, 1.5)))
        else:
            M = np.float32([[1 + r.normal() * 0.2, r.normal() * 0.3, r.normal() * 10],
                            [r.normal() * 0.3, 1 + r.normal() * 0.2, r.normal() * 10]])
        size = (16 * int(r.integers(1, 9)) + (t % 2) * int(r.integers(1, 16)),
                int(r.integers(1, 100)))
        np.testing.assert_array_equal(ip.warp_affine(img, M, size),
                                      cv2.warpAffine(img, M, size, borderValue=(114,) * 3))


@pytest.mark.parametrize("seed", range(3))
def test_resize_matches_cv2_exactly(seed):
    """INTER_LINEAR on uint8 at random sizes, both axes enlarged, shrunk or
    mixed (the crops of ``random_resized_crop`` and the short-edge resize
    of ``classify_eval_transform``)."""
    for t in range(40):
        r = np.random.default_rng(1000 * seed + t)
        h, w = int(r.integers(1, 80)), int(r.integers(1, 80))
        img = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        size = (int(r.integers(1, 120)), int(r.integers(1, 120)))
        np.testing.assert_array_equal(ip.resize(img, size), cv2.resize(img, size))


@pytest.mark.parametrize("width", [32, 31, 45])
def test_hsv2rgb_matches_cv2_on_every_hsv(width):
    """Every HSV triple in rows of ``width`` pixels: 32 is one step of cv2's
    vectorized loop (truncating), 31 its scalar loop alone (rounding), 45
    both."""
    g = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    every = np.stack(g, -1).reshape(-1, 3).astype(np.uint8)
    every = np.ascontiguousarray(every[: len(every) // width * width].reshape(-1, width, 3))
    np.testing.assert_array_equal(ip.hsv2rgb(every), cv2.cvtColor(every, cv2.COLOR_HSV2RGB))


# ---------------------------------------------------------------------------
# the transforms against the JAX package
# ---------------------------------------------------------------------------

IMG_HW = [(48, 64), (53, 37)]


@pytest.mark.parametrize("op", list(JA._RA_OPS))
@pytest.mark.parametrize("mag", [0.3, 0.9])
def test_rand_augment_op_matches_jax(op, mag):
    assert TA.RA_OPS == JA._RA_OPS
    for seed, hw in enumerate(IMG_HW):
        img = _image(*hw, seed=seed)
        want = JA._rand_augment_op(img, op, mag, np.random.default_rng(seed))
        got = TA._rand_augment_op(img, op, mag, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.uint8


@pytest.mark.parametrize("name", ["rand_augment", "augmix", "autoaugment_imagenet",
                                  "random_erasing", "color_jitter"])
def test_policy_matches_jax(name):
    """Each policy on a few images and seeds; the generators end in step."""
    for seed in range(6):
        img = _image(*IMG_HW[seed % 2], seed=seed + 10)
        kw = {"p": 0.9} if name == "random_erasing" else {}
        g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
        want = getattr(JA, name)(img, rng=g1, **kw)
        got = getattr(TA, name)(img, rng=g2, **kw)
        np.testing.assert_array_equal(got, want)
        assert g1.random() == g2.random()


def test_crops_match_jax():
    """``random_resized_crop`` (crops enlarged and shrunk, the fallback
    crop) and ``classify_eval_transform`` at two crop fractions."""
    for seed in range(8):
        h, w = (48 + 9 * seed, 64 + 5 * seed) if seed % 2 else (90, 20)
        img = _image(h, w, seed=seed)
        for size in (32, 64):
            scale = (0.08, 1.0) if seed % 3 else (1.5, 2.0)  # the last: only the fallback fits
            want = JA.random_resized_crop(img, size, scale=scale, rng=np.random.default_rng(seed))
            got = TA.random_resized_crop(img, size, scale=scale, rng=np.random.default_rng(seed))
            np.testing.assert_array_equal(got, want)
            for frac in (1.0, 0.875):
                np.testing.assert_array_equal(TA.classify_eval_transform(img, size, frac),
                                              JA.classify_eval_transform(img, size, frac))


@pytest.mark.parametrize("auto_augment", ["randaugment", "augmix", "autoaugment", None])
def test_classify_train_transform_matches_jax(auto_augment):
    kw = dict(scale=(0.5, 1.0), hflip=0.5, vflip=0.5, auto_augment=auto_augment, hsv_h=0.015,
              hsv_s=0.4, hsv_v=0.4, erasing=0.4)
    for seed in range(10):
        img = _image(40 + 3 * seed, 70 - 2 * seed, seed=seed)
        want = JA.classify_train_transform(img, 64, np.random.default_rng(seed), **kw)
        got = TA.classify_train_transform(img, 64, np.random.default_rng(seed), **kw)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the dataset and its loader against the JAX package
# ---------------------------------------------------------------------------

HYP = {"scale": 0.5, "fliplr": 0.5, "flipud": 0.5, "auto_augment": "randaugment",
       "hsv_h": 0.015, "hsv_s": 0.4, "hsv_v": 0.4, "erasing": 0.4, "crop_fraction": 0.875}


@pytest.fixture(scope="module")
def classify_set(tmp_path_factory):
    return make_classify_dataset(tmp_path_factory.mktemp("cls") / "set", n_train=8, n_val=4)


def test_classification_dataset_matches_jax(classify_set):
    """Class names and samples in the same order; ``fraction`` keeps the
    first samples of that order (whole classes drop out, as in JAX)."""
    for fraction in (1.0, 0.3):
        ours = ClassificationDataset(f"{classify_set}/train", imgsz=64, fraction=fraction)
        theirs = JaxClassificationDataset(f"{classify_set}/train", imgsz=64, fraction=fraction)
        assert ours.names == theirs.names and ours.samples == theirs.samples
    assert sorted({label for _, label in ours.samples}) == [0]  # 7 of 24: the first class
    for i in (0, 5):  # an eval sample, through the PNG decoder, at a crop fraction
        ours = ClassificationDataset(f"{classify_set}/val", imgsz=48, hyp={"crop_fraction": 0.875})
        theirs = JaxClassificationDataset(f"{classify_set}/val", imgsz=48,
                                          hyp={"crop_fraction": 0.875})
        g, w = ours.get_sample(i, None), theirs.get_sample(i, None)
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1] == w[1]


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("workers", [0, 2])
def test_build_dataloader_classify_matches_jax(classify_set, augment, workers):
    loaders = [fn(classify_set, "train", batch=5, imgsz=64, augment=augment, hyp=dict(HYP),
                  task="classify", seed=3, workers=workers)
               for fn in (build_dataloader, jax_build_dataloader)]
    (ours, d), (theirs, jd) = loaders
    assert d["names"] == jd["names"] and d["nc"] == jd["nc"] == 3
    assert len(ours) == len(theirs) == (4 if augment else 5)
    for _ in range(2):  # each loader run to its end: the epoch counts on
        got, want = list(ours), list(theirs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["img"].dtype == w["img"].dtype == np.float32
            np.testing.assert_array_equal(g["img"], w["img"])
            np.testing.assert_array_equal(g["label"], w["label"])


# The first train batch of ``make_classify_dataset(seed=0)`` (8 + 4 images a
# class) through ``build_dataloader(task="classify", batch=8, imgsz=64,
# seed=0)`` at the default keys (RandAugment, erasing 0.4): the SHA-256 of its
# float32 ``img`` bytes then its int64 ``label`` bytes. chip_smoke.py builds
# the same batch on the card's machine and holds it to this value.
CLASSIFY_BATCH_SHA256 = "4a2b4809f6b44db067772a0796d301ceecf4e60cfa2223cca993eb95683e22e2"


def test_classify_batch_is_pinned(tmp_path):
    import hashlib

    from xlstm_yolo_torch.cfg import DEFAULT_CFG_DICT

    root = make_classify_dataset(tmp_path / "set", n_train=8, n_val=4, seed=0)
    digests = []
    for fn in (build_dataloader, jax_build_dataloader):
        loader, _ = fn(root, "train", batch=8, imgsz=64, hyp=dict(DEFAULT_CFG_DICT),
                       task="classify", seed=0)
        batch = list(loader)[0]
        digests.append(hashlib.sha256(batch["img"].tobytes()
                                      + batch["label"].tobytes()).hexdigest())
    assert digests == [CLASSIFY_BATCH_SHA256] * 2
