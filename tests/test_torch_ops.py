"""Port parity: anchors, DFL decode, box ops, letterbox and NMS against JAX.

Seeded numpy inputs go through the JAX functions and the port's on the CPU.
Candidate scores are distinct (even after the bfloat16 rounding of the
predict path's selection), so no tie can reorder the kept detections.
Tolerance 1e-5 for fp32 arithmetic, exact for indices and masks; the CIoU
gradient (its alpha carries none) at 1e-5 as well.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.ops import anchors as JA, boxes as JB, letterbox as JL, nms as JN
from xlstm_yolo_torch.ops import anchors as TA, boxes as TB, letterbox as TL, nms as TN

TOL = dict(rtol=1e-5, atol=1e-5)


def test_make_anchors_matches_jax():
    shapes, strides = [(8, 6), (4, 3), (2, 2)], [8, 16, 32]
    ja, js = JA.make_anchors(shapes, strides)
    ta, ts = TA.make_anchors(shapes, strides)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("xywh", [True, False])
def test_dist2bbox_matches_jax(xywh):
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 10, size=(2, 30, 4)).astype(np.float32)
    a = rng.uniform(0, 40, size=(30, 2)).astype(np.float32)
    want = JA.dist2bbox(jnp.asarray(d), jnp.asarray(a), xywh=xywh)
    got = TA.dist2bbox(torch.from_numpy(d), torch.from_numpy(a), xywh=xywh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dfl_decode_matches_jax():
    x = (np.random.default_rng(1).normal(size=(2, 50, 64)) * 3).astype(np.float32)
    np.testing.assert_allclose(TA.dfl_decode(torch.from_numpy(x)).numpy(),
                               np.asarray(JA.dfl_decode(jnp.asarray(x))), **TOL)


def test_box_ops_match_jax():
    rng = np.random.default_rng(2)
    xywh = np.concatenate([rng.uniform(0, 60, (3, 20, 2)), rng.uniform(1, 20, (3, 20, 2))],
                          -1).astype(np.float32)
    jx, tx = JB.xywh2xyxy(jnp.asarray(xywh)), TB.xywh2xyxy(torch.from_numpy(xywh))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(TB.box_iou(tx, tx).numpy(), np.asarray(JB.box_iou(jx, jx)), **TOL)
    np.testing.assert_allclose(TB.scale_boxes(tx, (64, 64), (54, 81)).numpy(),
                               np.asarray(JB.scale_boxes(jx, (64, 64), (54, 81))), **TOL)


def test_bbox_iou_and_its_gradient_match_jax():
    rng = np.random.default_rng(5)
    lt = rng.uniform(0, 40, (2, 30, 2))
    b1 = np.concatenate([lt, lt + rng.uniform(1, 20, (2, 30, 2))], -1).astype(np.float32)
    b2 = (b1 + rng.normal(size=b1.shape) * 3).astype(np.float32)
    b2[..., 2:] = np.maximum(b2[..., 2:], b2[..., :2] + 0.5)
    jfn = lambda a: JB.bbox_iou(a, jnp.asarray(b2), xywh=False, CIoU=True)
    want, jgrad = jfn(jnp.asarray(b1)), jax.grad(lambda a: jnp.sum(jfn(a)))(jnp.asarray(b1))
    t1 = torch.from_numpy(b1).requires_grad_()
    got = TB.bbox_iou(t1, torch.from_numpy(b2))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(jgrad), **TOL)


def test_bbox2dist_matches_jax():
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 8, (40, 2)).astype(np.float32)
    b = np.concatenate([a - rng.uniform(-1, 20, (2, 40, 2)), a + rng.uniform(-1, 20, (2, 40, 2))],
                       -1).astype(np.float32)
    np.testing.assert_allclose(TA.bbox2dist(torch.from_numpy(a), torch.from_numpy(b), 15).numpy(),
                               np.asarray(JA.bbox2dist(jnp.asarray(a), jnp.asarray(b), 15)), **TOL)


@pytest.mark.parametrize("hw,imgsz", [((54, 81), 64), ((70, 40), 48)])
def test_letterbox_matches_jax(hw, imgsz):
    img = np.random.default_rng(3).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    jx, jmeta = JL.letterbox_device(jnp.asarray(img), imgsz=imgsz, dtype_name="float32")
    tx, tmeta = TL.letterbox_device(torch.from_numpy(img), imgsz=imgsz)
    assert tmeta == pytest.approx(tuple(float(m) for m in jmeta), rel=1e-6)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


def _candidates(seed, b=2, n=200, nc=3):
    """(B, N, 4 + nc) clustered boxes; each box's best score is distinct and
    exactly representable in bfloat16 (k / 256)."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(8, 56, (b, n, 2))
    wh = rng.uniform(4, 20, (b, n, 2))
    best = np.stack([rng.permutation(np.arange(20, 20 + n)) / 256.0 for _ in range(b)])
    scores = rng.uniform(0.0, 0.05, (b, n, nc))
    cls = rng.integers(0, nc, (b, n))
    np.put_along_axis(scores, cls[..., None], best[..., None], axis=-1)
    return np.concatenate([ctr, wh, scores], -1).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(fast_sel=True, pre_topk=128, iou_thres=0.7),
    dict(exact=True),
    dict(multi_label=True, conf_thres=0.03),
    dict(class_agnostic=True, max_det=20),
    dict(max_det=300, pre_topk=150),
], ids=["default", "fast_sel", "exact", "multi_label", "agnostic", "padded"])
def test_nms_matches_jax(kw):
    p = _candidates(4)
    jd, jv, js = JN.non_max_suppression(jnp.asarray(p), return_idx=True, **kw)
    td, tv, ts = TN.non_max_suppression(torch.from_numpy(p), return_idx=True, **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    assert int(tv.sum()) > 0
