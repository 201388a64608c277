"""Port parity: the segment, pose and OBB tasks' ops, heads and losses
against the JAX package.

On the CPU, fp32, torch on one thread, seeded numpy inputs:

* ``probiou``, ``batch_probiou``, ``dist2rbox``, ``rbox_corners``,
  ``select_candidates_in_rotated_gts``, ``assign_rotated``, ``nms_rotated``,
  ``decode_obb`` and ``decode_keypoints``: within 1e-5 of each output's max,
  masks and indices exact;
* the ``Segment``, ``Pose`` and ``OBB`` heads at small widths in eval mode
  within 1e-4 of each output's max; ``proto_up`` maps npr to npr channels,
  so a transposed-conv kernel loaded without flax's flip shows;
* ``segmentation_loss``, ``pose_loss`` (17 keypoints with visibility, and 5
  without) and ``obb_loss`` on seeded head outputs and padded batches: the
  loss within 1e-4 (rtol) and the gradient of every head output within 1e-3
  of its largest.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_yolo11 import nchw, one_thread, seeded_variables  # noqa: F401
from xlstm_yolo_tpu.nn import heads as JH
from xlstm_yolo_tpu.ops import anchors as JA
from xlstm_yolo_tpu.ops import boxes as JB
from xlstm_yolo_tpu.ops import nms as JN
from xlstm_yolo_tpu.utils import loss as JL
from xlstm_yolo_tpu.utils import tal as JT
from xlstm_yolo_torch.nn import heads as TH
from xlstm_yolo_torch.ops import anchors as TA
from xlstm_yolo_torch.ops import boxes as TB
from xlstm_yolo_torch.ops import nms as TN
from xlstm_yolo_torch.utils import loss as TL
from xlstm_yolo_torch.utils import tal as TT
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

TOL_OPS = 1e-5
TOL_HEAD = 1e-4
STRIDES = (8, 16, 32)
IMGSZ = 64


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rboxes(rng, shape, lo=4.0, hi=40.0, span=IMGSZ):
    """(..., 5) = cx, cy, w, h, angle, seeded."""
    xy = rng.uniform(0, span, (*shape, 2))
    wh = rng.uniform(lo, hi, (*shape, 2))
    a = rng.uniform(-np.pi / 2, np.pi / 2, (*shape, 1))
    return np.concatenate([xy, wh, a], -1).astype(np.float32)


def test_probiou_and_batch_probiou_match_jax():
    rng = np.random.default_rng(0)
    a, b = rboxes(rng, (64,)), rboxes(rng, (64,))
    b[:8] = a[:8]  # identical boxes: probiou near one
    close(TB.probiou(t(a), t(b)), JB.probiou(jnp.asarray(a), jnp.asarray(b)), TOL_OPS)
    m, n = rboxes(rng, (2, 7)), rboxes(rng, (2, 11))
    close(TB.batch_probiou(t(m), t(n)), JB.batch_probiou(jnp.asarray(m), jnp.asarray(n)), TOL_OPS)


def test_dist2rbox_and_rbox_corners_match_jax():
    rng = np.random.default_rng(1)
    dist = rng.uniform(0, 8, (2, 50, 4)).astype(np.float32)
    ang = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 50, 1)).astype(np.float32)
    anc = rng.uniform(0, 8, (50, 2)).astype(np.float32)
    close(TA.dist2rbox(t(dist), t(ang), t(anc)),
          JA.dist2rbox(jnp.asarray(dist), jnp.asarray(ang), jnp.asarray(anc)), TOL_OPS)
    rb = rboxes(rng, (3, 9))
    close(TT.rbox_corners(t(rb)), JT.rbox_corners(jnp.asarray(rb)), TOL_OPS)


def test_select_candidates_in_rotated_gts_matches_jax():
    rng = np.random.default_rng(2)
    centers = rng.uniform(0, IMGSZ, (300, 2)).astype(np.float32)
    gts = rboxes(rng, (2, 6), lo=8, hi=48)
    got = TT.select_candidates_in_rotated_gts(t(centers), t(gts)).numpy()
    want = np.asarray(JT.select_candidates_in_rotated_gts(jnp.asarray(centers), jnp.asarray(gts)))
    assert got.any() and np.array_equal(got, want)


def obb_inputs(seed, b=2, n_max=5, nc=4):
    """Predicted probabilities and rotated boxes at the anchors of 64 px,
    ground truth near some of them (padded slots masked)."""
    rng = np.random.default_rng(seed)
    anchors, stride_t = JA.make_anchors([(8, 8), (4, 4), (2, 2)], STRIDES)
    anc = np.asarray(anchors * stride_t)
    n = anc.shape[0]
    gt = rboxes(rng, (b, n_max), lo=10, hi=40)
    labels = rng.integers(0, nc, (b, n_max, 1)).astype(np.float32)
    mask = np.zeros((b, n_max, 1), bool)
    mask[0, :3] = mask[1, :4] = True
    pd_boxes = np.concatenate([anc[None].repeat(b, 0) + rng.normal(0, 3, (b, n, 2)),
                               rng.uniform(8, 40, (b, n, 2)),
                               rng.uniform(-1.0, 2.0, (b, n, 1))], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n, nc)).astype(np.float32)
    return scores, pd_boxes, anc.astype(np.float32), labels, gt, mask


def test_assign_rotated_matches_jax():
    scores, pd, anc, labels, gt, mask = obb_inputs(3)
    want = JT.assign_rotated(*(jnp.asarray(a) for a in (scores, pd, anc, labels, gt, mask)),
                             num_classes=scores.shape[-1])
    got = TT.assign_rotated(*(t(a) for a in (scores, pd, anc, labels, gt, mask)))
    names = ("target_labels", "target_rboxes", "target_scores", "fg_mask", "target_gt_idx")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in ("target_labels", "fg_mask", "target_gt_idx"):
            assert np.array_equal(g, w), name
        else:
            close(g, w, TOL_OPS)
    assert got[3].any()


def test_nms_rotated_matches_jax():
    rng = np.random.default_rng(4)
    b, n, nc = 2, 200, 3
    boxes = rboxes(rng, (b, n), lo=6, hi=30)
    scores = rng.uniform(0, 1, (b, n, nc)).astype(np.float32)
    pred = np.concatenate([boxes[..., :4], scores, boxes[..., 4:]], -1)
    wd, wv = JN.nms_rotated(jnp.asarray(pred), conf_thres=0.3, iou_thres=0.5, max_det=50)
    gd, gv = TN.nms_rotated(t(pred), conf_thres=0.3, iou_thres=0.5, max_det=50)
    assert np.array_equal(gv.numpy(), np.asarray(wv)) and gv.sum() > 10
    close(gd.numpy(), np.asarray(wd), TOL_OPS)


def det_maps_nhwc(rng, b, nc, reg_max=16, hw=(8, 4, 2)):
    return [(rng.normal(0, 1, (b, h, h, 4 * reg_max)).astype(np.float32),
             rng.normal(-2, 1, (b, h, h, nc)).astype(np.float32)) for h in hw]


def to_port_maps(maps):
    return [(nchw(bm), nchw(cm)) for bm, cm in maps]


def test_decode_obb_and_keypoints_match_jax():
    rng = np.random.default_rng(5)
    maps = det_maps_nhwc(rng, 2, 4)
    angle = [rng.normal(0, 1, (2, h, h, 1)).astype(np.float32) for h in (8, 4, 2)]
    want = JH.decode_obb([(jnp.asarray(a), jnp.asarray(c)) for a, c in maps],
                         [jnp.asarray(a) for a in angle], STRIDES, 4)
    got = TH.decode_obb(to_port_maps(maps), [nchw(a) for a in angle], STRIDES, 4)
    close(got.numpy(), np.asarray(want), TOL_OPS)
    for kpt_shape in ((17, 3), (5, 2)):
        kmaps = [rng.normal(0, 1, (2, h, h, kpt_shape[0] * kpt_shape[1])).astype(np.float32)
                 for h in (8, 4, 2)]
        want = JH.decode_keypoints([jnp.asarray(k) for k in kmaps], STRIDES, kpt_shape)
        got = TH.decode_keypoints([nchw(k) for k in kmaps], STRIDES, kpt_shape)
        close(got.numpy(), np.asarray(want), TOL_OPS)


HEADS = {
    "segment": (lambda ch: JH.Segment(nc=3, nm=8, npr=16, ch=ch),
                lambda ch: TH.Segment(nc=3, nm=8, npr=16, ch=ch)),
    "pose": (lambda ch: JH.Pose(nc=1, kpt_shape=(5, 3), ch=ch, legacy=False),
             lambda ch: TH.Pose(nc=1, kpt_shape=(5, 3), ch=ch, legacy=False)),
    "obb": (lambda ch: JH.OBB(nc=4, ne=1, ch=ch), lambda ch: TH.OBB(nc=4, ne=1, ch=ch)),
}


@pytest.mark.parametrize("task", list(HEADS))
def test_task_heads_match_jax(task):
    ch = (16, 32, 64)
    rng = np.random.default_rng(6)
    feats = [rng.normal(size=(2, 8 >> i, 8 >> i, c)).astype(np.float32) for i, c in enumerate(ch)]
    jm, tm = (f(ch) for f in HEADS[task])
    jfeats = [jnp.asarray(f) for f in feats]
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jfeats), 6)
    tm = load_jax_variables(tm, flatten_variables(v)).eval()
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree.leaves(v["params"]))
    want = jax.jit(jm.apply)(v, jfeats)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    for (gb, gc), (wb, wc) in zip(got["det"], want["det"]):
        close(gb.numpy().transpose(0, 2, 3, 1), wb, TOL_HEAD)
        close(gc.numpy().transpose(0, 2, 3, 1), wc, TOL_HEAD)
    for key in set(want) - {"det"}:
        ws = want[key] if isinstance(want[key], list) else [want[key]]
        gs = got[key] if isinstance(got[key], list) else [got[key]]
        for g, w in zip(gs, ws):
            close(g.numpy().transpose(0, 2, 3, 1), w, TOL_HEAD)
    if task == "segment":  # npr -> npr: a kernel loaded unflipped would show above
        assert tm.proto_up.in_channels == tm.proto_up.out_channels == 16


def padded_batch(rng, b=2, m=6, obb=False, nc=3):
    """Labels in 64 px: (B, m, 5) cls + xyxy (or (B, m, 6) cls + rbox),
    with the last slots empty."""
    n_valid = (3, 5)
    cb = np.zeros((b, m, 6 if obb else 5), np.float32)
    mask = np.zeros((b, m), bool)
    for i in range(b):
        k = n_valid[i]
        mask[i, :k] = True
        cb[i, :k, 0] = rng.integers(0, nc, k)
        if obb:
            cb[i, :k, 1:] = rboxes(rng, (k,), lo=10, hi=36)
            cb[i, :k, 1:3] = rng.uniform(16, 48, (k, 2))
        else:
            xy = rng.uniform(2, 36, (k, 2))
            cb[i, :k, 1:3] = xy
            cb[i, :k, 3:5] = xy + rng.uniform(10, 26, (k, 2))
    return cb, mask


def loss_and_grads(jax_fn, port_fn, arrays):
    """(JAX loss, JAX grads, port loss, port grads) of the losses over the
    NHWC ``arrays`` (list of head outputs); the port's get them NCHW."""
    jl, jg = jax.value_and_grad(lambda xs: jax_fn(xs).total)([jnp.asarray(a) for a in arrays])
    xs = [nchw(a).requires_grad_(True) for a in arrays]
    tl = port_fn(xs).total
    tl.backward()
    return float(jl), jg, float(tl.detach()), [x.grad.numpy().transpose(0, 2, 3, 1) for x in xs]


def check_loss(jl, jg, tl, tg):
    assert abs(tl - jl) <= 1e-4 * abs(jl)
    for g, w in zip(tg, jg):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()


def _split(xs, n):
    return [(xs[2 * i], xs[2 * i + 1]) for i in range(n)]


def test_segmentation_loss_matches_jax():
    rng = np.random.default_rng(7)
    nc, nm = 3, 8
    maps = det_maps_nhwc(rng, 2, nc)
    coefs = [rng.normal(0, 1, (2, h, h, nm)).astype(np.float32) for h in (8, 4, 2)]
    proto = rng.normal(0, 1, (2, 16, 16, nm)).astype(np.float32)
    cb, mask = padded_batch(rng, nc=nc)
    masks = np.zeros((2, 16, 16), np.int32)
    for i in range(2):
        for s in range(int(mask[i].sum())):
            x1, y1, x2, y2 = (cb[i, s, 1:5] / 4).astype(int)
            masks[i, y1:y2, x1:x2] = s + 1
    arrays = [a for pair in maps for a in pair] + coefs + [proto]
    jb = {"cls_boxes": jnp.asarray(cb), "mask": jnp.asarray(mask), "masks": jnp.asarray(masks)}
    tb = {"cls_boxes": t(cb), "mask": t(mask), "masks": t(masks)}

    def jfn(xs):
        out = {"det": _split(xs, 3), "coefs": xs[6:9], "proto": xs[9]}
        return JL.segmentation_loss(out, jb, STRIDES, nc)

    def tfn(xs):
        return TL.segmentation_loss({"det": _split(xs, 3), "coefs": xs[6:9], "proto": xs[9]},
                                    tb, STRIDES)

    check_loss(*loss_and_grads(jfn, tfn, arrays))


@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 2)], ids=["17x3", "5x2"])
def test_pose_loss_matches_jax(kpt_shape):
    rng = np.random.default_rng(8)
    nk, nd = kpt_shape
    maps = det_maps_nhwc(rng, 2, 1)
    kpts = [rng.normal(0, 0.5, (2, h, h, nk * nd)).astype(np.float32) for h in (8, 4, 2)]
    cb, mask = padded_batch(rng, nc=1)
    gk = np.zeros((2, cb.shape[1], nk, 3), np.float32)
    gk[..., :2] = cb[..., None, 1:3] + rng.uniform(0, 10, (2, cb.shape[1], nk, 2))
    gk[..., 2] = rng.integers(0, 3, (2, cb.shape[1], nk))
    arrays = [a for pair in maps for a in pair] + kpts
    jb = {"cls_boxes": jnp.asarray(cb), "mask": jnp.asarray(mask), "keypoints": jnp.asarray(gk)}
    tb = {"cls_boxes": t(cb), "mask": t(mask), "keypoints": t(gk)}

    def jfn(xs):
        return JL.pose_loss({"det": _split(xs, 3), "kpts": xs[6:]}, jb, STRIDES, 1, kpt_shape)

    def tfn(xs):
        return TL.pose_loss({"det": _split(xs, 3), "kpts": xs[6:]}, tb, STRIDES, kpt_shape)

    check_loss(*loss_and_grads(jfn, tfn, arrays))


def test_obb_loss_matches_jax():
    rng = np.random.default_rng(9)
    nc = 4
    maps = det_maps_nhwc(rng, 2, nc)
    angle = [rng.normal(0, 1, (2, h, h, 1)).astype(np.float32) for h in (8, 4, 2)]
    cb, mask = padded_batch(rng, obb=True, nc=nc)
    arrays = [a for pair in maps for a in pair] + angle
    jb = {"cls_boxes": jnp.asarray(cb), "mask": jnp.asarray(mask)}
    tb = {"cls_boxes": t(cb), "mask": t(mask)}

    def jfn(xs):
        return JL.obb_loss({"det": _split(xs, 3), "angle": xs[6:]}, jb, STRIDES, nc)

    def tfn(xs):
        return TL.obb_loss({"det": _split(xs, 3), "angle": xs[6:]}, tb, STRIDES)

    check_loss(*loss_and_grads(jfn, tfn, arrays))
