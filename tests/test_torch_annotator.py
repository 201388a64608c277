"""Port parity: the annotator (``xlstm_yolo_torch/utils/annotator.py``), the
drawing and writing of ``Results`` and ``plot_images`` /
``feature_visualization`` against the JAX package, which draws with
OpenCV 5.

* Exact: the palette, ``text_size`` against ``cv2.getTextSize`` (font 0,
  thickness 1 and 2-4, scales 0.1-5), one-pixel LINE_8 lines (clipped) and
  rectangles, filled rectangles, the mask blend (at the frame's size and
  from mask space).
* Measured against JAX's drawing on the same frames (``_measure``): no
  pixel changes more than 1 px away from a pixel JAX's changes, and on the
  box-and-label frames the share of the pixels inside the box outlines and
  label boxes that differ by more than 8 levels stays under ``MAX_OFF``,
  2%, at each frame size (measured: 0.51% at 640 x 480, 0.84% at
  1280 x 720, 1.10% at 1920 x 1080, where the same boxes carry larger
  labels in the bold weight; the glyphs are the outlines of cv2's face
  filled with their coverage, and the rest is where cv2 flattens the
  face's curves otherwise). Anti-aliased edges follow a fitted falloff.
* ``Results.save_txt``, ``summary`` and ``to_json`` equal JAX's text for
  text on segment, pose, OBB, classify and tracked results built from the
  same arrays (the port wrote box lines only, and its summary left out the
  OBB corners, ``track_id``, ``segments`` and ``keypoints``);
  ``to_df`` / ``to_csv`` / ``to_sql``; ``save`` writes the port's encoder
  on ``plot()``; ``save_crop`` writes JAX's bytes.
"""
import sqlite3

import cv2
import numpy as np
import pytest
from scipy import ndimage as ndi

from xlstm_yolo_tpu.engine.results import Results as JaxResults
from xlstm_yolo_tpu.utils import annotator as J
from xlstm_yolo_tpu.utils import plotting as JP
from xlstm_yolo_torch import native
from xlstm_yolo_torch.data.imgproc import imread
from xlstm_yolo_torch.engine.results import Results
from xlstm_yolo_torch.utils import annotator as T
from xlstm_yolo_torch.utils import plotting as TP

MAX_OFF = 0.02
NAMES = {0: "person", 1: "car", 2: "traffic light", 3: "dog"}


def _frame(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 / w, y * 255 / h, (x + y) * 128 / (h + w) + 60], -1)
    return np.clip(img + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


def _measure(ours, theirs, orig, regions=()):
    """(pixels changed more than 1 px from a JAX change, share of the
    ``regions`` (x1, y1, x2, y2 inclusive) differing by more than 8)."""
    a, b = np.asarray(theirs, int), np.asarray(ours, int)
    near = ndi.binary_dilation((a != orig).any(-1), np.ones((3, 3), bool))
    stray = int(((b != orig).any(-1) & ~near).sum())
    inside = np.zeros(a.shape[:2], bool)
    for x1, y1, x2, y2 in regions:
        inside[max(y1, 0):y2 + 1, max(x1, 0):x2 + 1] = True
    off = (np.abs(a - b).max(-1) > 8)[inside].mean() if inside.any() else 0.0
    return stray, off


def test_palette_matches_jax():
    assert T.colors.palette == J.colors.palette
    np.testing.assert_array_equal(T.colors.pose_palette, J.colors.pose_palette)
    assert T.colors(3, bgr=True) == J.colors(3, bgr=True)


def test_text_size_equals_cv2():
    rng = np.random.default_rng(0)
    chars = [chr(c) for c in range(32, 127)]
    for i in range(600):
        text = "".join(rng.choice(chars, int(rng.integers(1, 16))))
        scale = float(rng.choice([0.4, 2 / 3, 1.0, 4 / 3, 0.45])) if i % 2 else \
            float(rng.uniform(0.1, 5.0))
        th = int(rng.integers(1, 5))
        assert T.text_size(text, scale, th) == cv2.getTextSize(text, 0, scale, th)[0], \
            (text, scale, th)
    assert T.text_size("", 1.0, 1) == cv2.getTextSize("", 0, 1.0, 1)[0]


def test_line8_strokes_equal_cv2():
    rng = np.random.default_rng(1)
    for _ in range(400):
        p0, p1 = (tuple(int(v) for v in rng.integers(-30, 90, 2)) for _ in range(2))
        for draw in ("line", "rect", "fill"):
            a = np.zeros((60, 50, 3), np.uint8)
            b = a.copy()
            if draw == "line":
                cv2.line(a, p0, p1, (255, 9, 3), 1)
                T._line1(b, p0, p1, (255, 9, 3))
            else:
                th = 1 if draw == "rect" else -1
                cv2.rectangle(a, p0, p1, (255, 9, 3), th)
                T._rectangle(b, p0, p1, (255, 9, 3), th)
            np.testing.assert_array_equal(b, a, err_msg=f"{draw} {p0} {p1}")


@pytest.mark.parametrize("space", ["frame", "mask"])
def test_masks_blend_equals_jax(space):
    h, w = (120, 160) if space == "frame" else (30, 40)
    m = np.zeros((3, h, w), np.float32)
    m[0, h // 10:h // 2, w // 8:w // 2] = 1
    m[1, h // 3:h - 2, w // 3:w - 3] = 0.8
    m[2, :h // 4, w // 2:] = 0.4
    cols = [T.colors(i) for i in range(3)]
    im = _frame(120, 160)
    a, b = J.Annotator(im), T.Annotator(im)
    a.masks(m, cols)
    b.masks(m, cols)
    np.testing.assert_array_equal(b.result(), a.result())


def _boxes(which, ann):
    mod = T if which == "T" else J
    regions = []
    for i, (box, label) in enumerate([((50, 60, 250, 300), "person 0.91"),
                                      ((300, 100, 600, 400), "car 0.55"),
                                      ((10, 5, 120, 90), "dog 0.33"),
                                      ((400, 380, 630, 470), "traffic light 0.87")]):
        ann.box_label(box, label, color=mod.colors(i))
        tw, th = T.text_size(label, ann.fs, ann.tf)
        outside = box[1] - th - 3 >= 0
        regions += [box, (box[0], box[1] - th - 3 if outside else box[1], box[0] + tw,
                          box[1] if outside else box[1] + th + 3)]
    return regions


def _rotated(which, ann):
    pts = np.asarray([[140, 120], [400, 160], [360, 390], [100, 350]], np.float32)
    ann.box_label(pts, "plane 0.77", color=(0, 200, 0), rotated=True)
    tw, th = T.text_size("plane 0.77", ann.fs, ann.tf)
    return [(100, 120, 400, 390), (100, 120 - th - 3, 100 + tw, 120)]


def _kpts(which, ann):
    rng = np.random.default_rng(1)
    ann.kpts(np.stack([rng.uniform(50, 600, 17), rng.uniform(50, 450, 17),
                       rng.uniform(0.2, 1, 17)], 1))
    return []


def _labels(which, ann):
    ann.text((30, 60), "hello world", box_style=True)
    ann.circle_label((200, 200, 260, 260), "12", color=(200, 0, 0))
    ann.text_label((300, 300, 420, 360), "queue 3", color=(0, 0, 200))
    ann.rectangle((400, 50, 500, 120), fill=(10, 200, 10), outline=(255, 255, 0), width=3)
    return []


def _solutions(which, ann):
    ann.draw_region([(20, 400), (300, 380), (320, 460), (30, 470)], thickness=5)
    ann.draw_region([(400, 20), (600, 200)], thickness=3)
    ann.draw_centroid_and_tracks([(100, 100), (120, 130), (160, 150), (200, 140)])
    ann.display_analytics({"in": 3, "out": 5})
    ann.plot_distance_and_line(3.14159, [(50, 300), (250, 250)])
    ann.visioneye((300, 100, 400, 200), (600, 450))
    ann.sweep_annotator(500, 0, label="sweep")
    ann.seg_bbox([(350, 300), (450, 320), (420, 420), (340, 400)], label="seg")
    ann.plot_angle_and_count_and_stage(45.0, 3, "up", (100, 200))
    ann.queue_counts_display("Queue: 4", [(400, 300), (600, 300), (600, 450), (400, 450)])
    return []


@pytest.mark.parametrize("case,hw", [("boxes", (480, 640)), ("boxes", (720, 1280)),
                                     ("boxes", (1080, 1920)), ("rotated", (480, 640)),
                                     ("kpts", (480, 640)), ("labels", (480, 640)),
                                     ("solutions", (480, 640))])
def test_drawing_within_measure_of_jax(case, hw):
    draw = {"boxes": _boxes, "rotated": _rotated, "kpts": _kpts, "labels": _labels,
            "solutions": _solutions}[case]
    im = _frame(*hw)
    a, b = J.Annotator(im), T.Annotator(im)
    regions = draw("J", a)
    draw("T", b)
    assert (b.result() != im).any()
    stray, off = _measure(b.result(), a.result(), im, regions)
    assert stray == 0
    assert off <= MAX_OFF, off


# --------------------------------------------------------------------------
# Results: the same arrays in both packages
# --------------------------------------------------------------------------


def _pair(kind):
    rng = np.random.default_rng({"seg": 1, "pose": 2, "obb": 3, "cls": 4, "track": 5,
                                 "track_obb": 6}[kind])
    img = _frame(96, 128, seed=7)
    xy = np.sort(rng.uniform(0, [128, 96], (4, 2, 2)), axis=1).reshape(4, 4)[:, [0, 1, 2, 3]]
    boxes = np.concatenate([xy, rng.uniform(0.3, 1, (4, 1)), rng.integers(0, 4, (4, 1))], 1)
    kw = {}
    if kind == "seg":
        masks = np.zeros((4, 96, 128), bool)
        for i, (x1, y1, x2, y2) in enumerate(xy.astype(int)):
            masks[i, y1:y2 + 1, x1:x2 + 1] = True
            masks[i, (y1 + y2) // 2, x1:x2 + 1] = False
        kw = {"boxes": boxes, "masks": masks}
    elif kind == "pose":
        k = np.concatenate([rng.uniform(0, [128, 96], (4, 17, 2)), rng.random((4, 17, 1))], -1)
        kw = {"boxes": boxes, "keypoints": k}
    elif kind == "obb":
        kw = {"obb": np.concatenate([rng.uniform(20, 80, (4, 4)), rng.uniform(-1, 1, (4, 1)),
                                     boxes[:, 4:]], 1), "boxes": boxes}
    elif kind == "cls":
        kw = {"probs": rng.dirichlet(np.ones(6))}
    elif kind == "track":
        kw = {"boxes": np.concatenate([boxes[:, :4], np.arange(1, 5)[:, None], boxes[:, 4:]], 1)}
    elif kind == "track_obb":
        kw = {"obb": np.concatenate([rng.uniform(20, 80, (4, 4)), rng.uniform(-1, 1, (4, 1)),
                                     np.arange(7, 11)[:, None], boxes[:, 4:]], 1)}
    names = {i: f"c{i}" for i in range(6)} if kind == "cls" else NAMES
    return (Results(img, path="x.jpg", names=names, **kw),
            JaxResults(img, path="x.jpg", names=names, **kw))


KINDS = ["seg", "pose", "obb", "cls", "track", "track_obb"]


@pytest.mark.parametrize("kind", KINDS)
def test_save_txt_equals_jax(kind, tmp_path):
    ours, theirs = _pair(kind)
    for conf in (False, True):
        ours.save_txt(tmp_path / "a.txt", save_conf=conf)
        theirs.save_txt(tmp_path / "b.txt", save_conf=conf)
        assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text() != ""


@pytest.mark.parametrize("kind", KINDS)
def test_summary_and_json_equal_jax(kind):
    ours, theirs = _pair(kind)
    for normalize in (False, True):
        assert ours.summary(normalize=normalize) == theirs.summary(normalize=normalize)
        assert ours.to_json(normalize=normalize) == theirs.to_json(normalize=normalize)
    if kind == "seg":
        for a, b in zip(ours.masks.xyn, theirs.masks.xyn):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["seg", "pose", "track"])
def test_tables_equal_jax(kind, tmp_path):
    ours, theirs = _pair(kind)
    assert ours.to_df(normalize=True).equals(theirs.to_df(normalize=True))
    assert ours.to_csv() == theirs.to_csv()
    ours.to_sql(db_path=str(tmp_path / "a.db"))
    theirs.to_sql(db_path=str(tmp_path / "b.db"))
    rows = [sqlite3.connect(tmp_path / f).execute("SELECT * FROM results").fetchall()
            for f in ("a.db", "b.db")]
    assert rows[0] == rows[1] and len(rows[0]) == 4
    empty = Results(ours.orig_img, boxes=np.zeros((0, 6)))
    assert empty.to_xml() == JaxResults(ours.orig_img, boxes=np.zeros((0, 6))).to_xml()


@pytest.mark.parametrize("kind", ["seg", "pose", "obb", "cls", "track"])
def test_plot_within_measure_and_save(kind, tmp_path):
    ours, theirs = _pair(kind)
    a, b = theirs.plot(), ours.plot()
    stray, _ = _measure(b, a, ours.orig_img)
    assert stray == 0
    ours.save(tmp_path / "p.jpg")
    assert (tmp_path / "p.jpg").read_bytes() == native.jpeg_encode(b)


@pytest.mark.parametrize("kind", ["seg", "track"])
def test_save_crop_bytes_equal_jax(kind, tmp_path):
    ours, theirs = _pair(kind)
    ours.save_crop(tmp_path / "a", "im.jpg")
    theirs.save_crop(tmp_path / "b", "im.jpg")
    fa = sorted(p.relative_to(tmp_path / "a") for p in (tmp_path / "a").rglob("*.jpg"))
    fb = sorted(p.relative_to(tmp_path / "b") for p in (tmp_path / "b").rglob("*.jpg"))
    assert fa == fb and len(fa) == 4
    for f in fa:
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes()


def test_save_one_box_equals_jax(tmp_path):
    im = _frame(96, 128)
    for sq in (False, True):
        a = T.save_one_box([10, 20, 70, 50], im, tmp_path / "a.jpg", square=sq)
        b = J.save_one_box([10, 20, 70, 50], im, tmp_path / "b.jpg", square=sq)
        np.testing.assert_array_equal(a, b)
        assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()


def test_plot_images_and_features(tmp_path):
    rng = np.random.default_rng(0)
    b, s = 5, 96
    x = np.sort(rng.uniform(0, s, (b, 4, 2)), -1)
    y = np.sort(rng.uniform(0, s, (b, 4, 2)), -1)
    batch = {"img": rng.random((b, s, s, 3)).astype(np.float32),
             "cls_boxes": np.concatenate([rng.integers(0, 3, (b, 4, 1)), x[..., :1], y[..., :1],
                                          x[..., 1:], y[..., 1:]], -1),
             "mask": rng.random((b, 4)) > 0.3}
    names = {0: "a", 1: "bb", 2: "person"}
    TP.plot_images(batch, names, fname=tmp_path / "t.jpg")
    JP.plot_images(batch, names, fname=tmp_path / "j.png")
    TP.plot_images(batch, names, fname=tmp_path / "t.png")
    ours, theirs = imread(tmp_path / "t.png"), imread(tmp_path / "j.png")
    canvas = np.full_like(ours, 255)
    for i in range(b):
        r, c = divmod(i, 3)
        canvas[r * s:(r + 1) * s, c * s:(c + 1) * s] = (batch["img"][i] * 255).astype(np.uint8)
    stray, _ = _measure(ours, theirs, canvas)
    assert stray == 0 and ours.shape == theirs.shape == (192, 288, 3)
    assert (tmp_path / "t.jpg").read_bytes() == native.jpeg_encode(ours)
    f = TP.feature_visualization(rng.random((1, 20, 24, 9)), tmp_path / "f.png", n=7)
    grid = imread(f)
    assert grid.shape == (3 * 22 + 2, 3 * 26 + 2, 3)
    assert (grid[:2] == 255).all() and tuple(grid[2, 2]) != (255, 255, 255)
