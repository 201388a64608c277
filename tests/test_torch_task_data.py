"""Port parity: the segment, pose and OBB tasks' data path against cv2 and
the JAX package.

On the CPU:

* ``imgproc.fill_poly_cv`` equal to ``cv2.fillPoly`` on 240 seeded
  polygons (convex, concave, self-crossing, degenerate, on the border and
  across it) of 3 to 24 vertices, and on a row of later slots covering
  earlier ones (the collate's overlap encoding);
* ``imgproc.min_area_rect`` against ``cv2.minAreaRect``: centre and size
  within 1e-4, angle within 1e-4 degrees on axis-aligned boxes (either
  orientation, any corner first) and integer quadrilaterals (the labels of
  DOTA-style data); on rotated float rectangles (``cv2.boxPoints``) the
  angle within 5e-4 degrees, the float32 corners' two long sides' angles
  differing by that much; where two different rectangles tie in area (a
  rectangle with its corners rounded to 0.01), the same area within 1e-5,
  each rectangle holding every point; ``box_points`` equal to
  ``cv2.boxPoints``;
* on a PNG set the port writes (``make_synthetic_dataset(task=...)``),
  both packages' ``build_dataloader`` for each task with augmentation off
  and with mosaic, flip and copy-paste (segment) on, under one seed: the
  collated ``cls_boxes``, ``mask``, ``masks`` and ``keypoints`` equal (the
  OBB rbox within 1e-5 of its largest), the images within one level (the
  port's HSV gains, ``tests/test_torch_data.py``);
* ``device_augment`` of a segment and pose batch (masks and keypoints, the
  COCO ``flip_idx``) against ``_device_augment_jit`` on the same draws.
"""
import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from test_torch_device_augment import jax_draws
from xlstm_yolo_tpu.data import device_augment as J
from xlstm_yolo_tpu.data.dataset import build_dataloader as jax_build_dataloader
from xlstm_yolo_torch.data import device_augment as P
from xlstm_yolo_torch.data import imgproc as ip
from xlstm_yolo_torch.data.dataset import build_dataloader
from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset


def _polygons(n=240, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(8, 96, 2))
        k = int(rng.integers(3, 25))
        kind = i % 6
        if kind == 0:  # convex: points on a circle
            c, r = rng.uniform([0, 0], [w, h]), rng.uniform(2, 40)
            th = np.sort(rng.uniform(0, 2 * np.pi, k))
            pts = np.round(c + r * np.stack([np.cos(th), np.sin(th)], -1))
        elif kind == 1:  # concave: a star
            c, th = rng.uniform([0, 0], [w, h]), np.linspace(0, 2 * np.pi, 2 * k, endpoint=False)
            r = np.where(np.arange(2 * k) % 2, 4.0, rng.uniform(8, 30))
            pts = np.round(c + r[:, None] * np.stack([np.cos(th), np.sin(th)], -1))
        elif kind == 2:  # any order: self-crossing
            pts = rng.integers(0, [w, h], (k, 2))
        elif kind == 3:  # degenerate: a segment, a point, repeated vertices
            pts = np.repeat(rng.integers(0, [w, h], (2, 2)), [1, 2], axis=0)
        elif kind == 4:  # on the border
            pts = rng.integers(0, [w, h], (k, 2))
            pts[rng.random(k) < 0.5, 0] = rng.choice([0, w - 1])
            pts[rng.random(k) < 0.5, 1] = rng.choice([0, h - 1])
        else:  # across the border
            pts = rng.integers([-20, -20], [w + 20, h + 20], (k, 2))
        out.append(((h, w), pts.astype(np.int32)))
    return out


def test_fill_poly_matches_cv2():
    for (h, w), pts in _polygons():
        want = np.full((h, w), 3, np.int32)
        cv2.fillPoly(want, [pts], 7)
        got = np.full((h, w), 3, np.int32)
        ip.fill_poly_cv(got, pts, 7)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


def test_fill_poly_later_slots_cover_earlier_ones():
    rng = np.random.default_rng(1)
    want, got = np.zeros((40, 40), np.int32), np.zeros((40, 40), np.int32)
    for slot in range(6):
        pts = rng.integers(-5, 45, (5, 2)).astype(np.int32)
        cv2.fillPoly(want, [pts], slot + 1)
        ip.fill_poly_cv(got, pts, slot + 1)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 3


def _rect_close(got, want, angle_tol):
    (gx, gy), (gw, gh), ga = got
    (wx, wy), (ww, wh), wa = want
    scale = max(1.0, ww, wh)
    return (max(abs(gx - wx), abs(gy - wy), abs(gw - ww), abs(gh - wh)) <= 1e-4 * scale
            and abs(ga - wa) <= angle_tol)


def test_min_area_rect_matches_cv2():
    rng = np.random.default_rng(2)
    for i in range(300):
        x1, y1 = rng.integers(0, 60, 2)
        bw, bh = rng.integers(1, 40, 2)
        box = np.array([[x1, y1], [x1 + bw, y1], [x1 + bw, y1 + bh], [x1, y1 + bh]])
        box = np.roll(box, int(rng.integers(4)), 0)[::1 if i % 2 else -1]
        quad = rng.integers(0, 100, (4, 2))
        for pts in (box, quad):
            pts = pts.astype(np.float32)
            assert _rect_close(ip.min_area_rect(pts), cv2.minAreaRect(pts), 1e-4), pts.tolist()
    assert ip.min_area_rect(np.float32([[0, 0], [10, 0], [10, 4], [0, 4]])) == (
        (5.0, 2.0), (4.0, 10.0), -90.0)
    for i in range(300):
        rect = (tuple(rng.uniform(10, 90, 2)), tuple(rng.uniform(2, 40, 2)), rng.uniform(-90, 90))
        corners = cv2.boxPoints(rect)
        np.testing.assert_allclose(ip.box_points(rect), corners, atol=1e-4)
        assert _rect_close(ip.min_area_rect(corners), cv2.minAreaRect(corners), 5e-4)
        rounded = np.round(corners, 2).astype(np.float32)
        got, want = ip.min_area_rect(rounded), cv2.minAreaRect(rounded)
        area = want[1][0] * want[1][1]
        assert abs(got[1][0] * got[1][1] - area) <= 1e-5 * area
        for p in rounded:  # every point inside (or on) the port's rectangle
            assert cv2.pointPolygonTest(cv2.boxPoints(got), tuple(map(float, p)), True) >= -1e-3


@pytest.fixture(scope="module")
def task_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("task_sets")
    return {task: make_synthetic_dataset(root / task, n_train=8, n_val=2, imgsz=64, task=task,
                                         seed=5)
            for task in ("segment", "pose", "obb")}


@pytest.mark.parametrize("augment", [False, True], ids=["letterbox", "augment"])
@pytest.mark.parametrize("task", ["segment", "pose", "obb"])
def test_collated_batches_match_jax(task_sets, task, augment):
    hyp = {"mosaic": 1.0 if augment else 0.0, "fliplr": 0.5, "hsv_h": 0.015, "hsv_s": 0.7,
           "hsv_v": 0.4, "copy_paste": 0.5 if augment and task == "segment" else 0.0}
    kw = dict(batch=4, imgsz=64, augment=augment, seed=3, max_labels=16, task=task)
    ours, _ = build_dataloader(task_sets[task], "train", hyp=dict(hyp), **kw)
    theirs, _ = jax_build_dataloader(task_sets[task], "train", hyp=dict(hyp), **kw)
    n = 0
    for got, want in zip(ours, theirs):
        assert set(got) == set(want)
        for key in want:
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.shape == w.shape and g.dtype == w.dtype, key
            if key == "img":
                assert np.abs(g - w).max() <= 1.5 / 255
            elif key == "cls_boxes" and task == "obb":
                assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
            else:
                np.testing.assert_array_equal(g, w, err_msg=key)
        assert want["mask"].any() and (task != "segment" or want["masks"].any())
        n += 1
    assert n == 2


COCO_FLIP = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)


@pytest.mark.parametrize("mosaic", [1.0, 0.0], ids=["mosaic", "no_mosaic"])
def test_device_augment_masks_and_keypoints_match_jax(mosaic):
    """A segment batch's slot masks and a pose batch's keypoints (17, the
    COCO flip_idx) through the port's ``apply`` on the JAX module's draws
    and through ``_device_augment_jit``: equal masks, keypoints within 1e-3
    px, boxes and slots as the detect path's."""
    rng = np.random.default_rng(6)
    B, S, M, ms = 4, 64, 6, 16
    imgs = rng.integers(0, 255, (B, S, S, 3)).astype(np.uint8)
    cb = np.zeros((B, M, 5), np.float32)
    mk = np.zeros((B, M), bool)
    masks = np.zeros((B, ms, ms), np.int32)
    kp = np.zeros((B, M, 17, 3), np.float32)
    for b in range(B):
        for j in range(int(rng.integers(1, M))):
            x1, y1 = rng.uniform(0, S - 16, 2)
            w, h = rng.uniform(10, S / 2, 2)
            cb[b, j] = [rng.integers(3), x1, y1, min(S, x1 + w), min(S, y1 + h)]
            mk[b, j] = True
            q = (cb[b, j, 1:5] * ms / S).astype(int)
            masks[b, q[1]:q[3], q[0]:q[2]] = j + 1
            kp[b, j, :, :2] = cb[b, j, None, 1:3] + rng.uniform(0, 10, (17, 2))
            kp[b, j, :, 2] = rng.integers(0, 3, 17)
    hyp = dict(mosaic=mosaic, degrees=10.0, translate=0.2, scale=0.5, shear=5.0, hsv_h=0.015,
               hsv_s=0.7, hsv_v=0.4, fliplr=0.5)
    h = P.aug_hyp(hyp)
    # the first key whose draws flip some image, so that flip_idx is exercised
    key = next(k for k in (jax.random.PRNGKey(i) for i in range(11, 40))
               if jax_draws(k, B, S, h, mosaic).flip.any())
    want = J._device_augment_jit(jnp.asarray(imgs), jnp.asarray(cb), jnp.asarray(mk), key,
                                 jnp.float32(mosaic), tuple(sorted(hyp.items())),
                                 seg_masks=jnp.asarray(masks), kpts=jnp.asarray(kp),
                                 flip_idx=COCO_FLIP)
    _, want_cb, want_mk, want_masks, want_kp = (np.asarray(w) for w in want)
    d = jax_draws(key, B, S, h, mosaic)
    got = P.apply(*(torch.from_numpy(a) for a in (imgs, cb, mk)), d, h,
                  masks=torch.from_numpy(masks), keypoints=torch.from_numpy(kp),
                  flip_idx=COCO_FLIP)
    _, got_cb, got_mk, got_masks, got_kp = (t.numpy() for t in got)
    np.testing.assert_array_equal(got_mk, want_mk)
    np.testing.assert_allclose(got_cb[want_mk], want_cb[want_mk], rtol=0, atol=1e-3)
    assert want_masks.any() and d.flip.any() and (d.mosaic.all() if mosaic else True)
    np.testing.assert_array_equal(got_masks, want_masks)
    np.testing.assert_allclose(got_kp, want_kp, rtol=0, atol=1e-3)
