"""Port parity: SAM (``xlstm_yolo_torch/models_sam.py``) against the JAX
``xlstm_yolo_tpu/models_sam.py``, and the float cv2 resize
(``imgproc.resize_linear_f32``) against cv2.

On the CPU, fp32, torch on one thread, on one seeded JAX tree (every
parameter noised, ``rel_pos_h`` / ``rel_pos_w`` included) loaded into the
port through ``load_jax_variables``. SAM at img 128, dim 64, depth 3: block 2
is global, blocks 0 and 1 windowed (window 14 over the 8 x 8 grid: padded).
The JAX side is compiled at XLA's lowest backend optimization level
(``LowOpt``). Tolerances: encoder maps, masks and IoU within ``TOL`` = 1e-4
of each output's own max; a boolean mask equals JAX's except at pixels whose
float value (JAX's, before the threshold) lies within ``TOL`` of the max of
the threshold, and those pixels are counted and bounded (``NEAR_MAX``, a
share of the pixels); the AMG host stage fed JAX's device outputs gives JAX's
kept masks, scores and boxes exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_detect_zoo import compiled
from test_torch_yolo11 import one_thread, seeded_variables  # noqa: F401
from xlstm_yolo_tpu import models_sam as JS
from xlstm_yolo_torch import models_sam as TS
from xlstm_yolo_torch.data.imgproc import resize_linear_f32
from xlstm_yolo_torch.models_sam2 import build_sam
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

TOL = 1e-4
NEAR_MAX = 0.01  # the share of a mask's pixels that may lie within TOL of the threshold
S = 128

# the JAX parameter counts (jax.eval_shape of SAM.init; SAM2's through track_step)
SAM_COUNTS = {"vit_b": 93_993_572, "vit_l": 312_600_932, "vit_h": 641_308_260,
              "mobile_sam": 7_810_916, "sam2_t": 38_185_380}


class LowOpt:
    """``jax.jit(f)`` with each signature (the arguments' tree and shapes)
    compiled once at XLA's lowest backend optimization level."""

    def __init__(self, f):
        self.f, self.cache = f, {}

    def __call__(self, *args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(a), np.asarray(a).dtype.str) for a in leaves))
        if key not in self.cache:
            self.cache[key] = compiled(self.f, *args)
        return self.cache[key](*args)


def assert_close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    err, scale = np.abs(got - want).max(initial=0.0), np.abs(want).max(initial=0.0)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def assert_bool_near(got, want, want_float, thresh=0.0, what=""):
    """``got`` equals ``want`` except where ``want_float`` lies within TOL x
    max|want_float - thresh| of ``thresh``; such pixels are few."""
    got, want, f = np.asarray(got), np.asarray(want), np.asarray(want_float, np.float64)
    near = np.abs(f - thresh) <= TOL * np.abs(f - thresh).max()
    assert got.shape == want.shape
    assert not ((got != want) & ~near).any(), f"{what}: a mask differs away from the threshold"
    assert near.mean() <= NEAR_MAX, f"{what}: {near.sum()} pixels at the threshold"
    return int((got != want).sum())


def jax_predictor(jm, v):
    p = JS.SAMPredictor(jm, v, img_size=S)
    p._encode = LowOpt(lambda v, x: jm.apply(v, x, method=jm.encode_image))
    p._decode = LowOpt(lambda v, e, pt, lb, bx: jm.apply(v, e, pt, lb, bx, method=jm.decode))
    return p


@pytest.fixture(scope="module")
def sam():
    """(JAX SAM, its seeded variables, the port on them, the JAX predictor)."""
    jm = JS.SAM(img_size=S, encoder_dim=64, encoder_depth=3)
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3))), 0)
    tm = load_jax_variables(TS.SAM(img_size=S, encoder_dim=64, encoder_depth=3, device="cpu"),
                            flatten_variables(v))
    return jm, v, tm, jax_predictor(jm, v)


def image(seed, h, w, b=None):
    shape = (h, w, 3) if b is None else (b, h, w, 3)
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("hw", [(S, S), (96, 160)], ids=["img_size", "resized_pos"])
def test_image_encoder_matches_jax(sam, hw):
    """At ``img_size``, and at 96 x 160 px, where ``pos_embed`` is bicubic-
    resized to 6 x 10 and the global block's rel-pos tables linearly."""
    jm, v, tm, _ = sam
    x = image(1, *hw, b=2)
    want = LowOpt(lambda v, x: jm.apply(v, x, method=jm.encode_image))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(x))
    assert_close(got, want, what="encoder")


def prompts():
    pts = np.asarray([[[30.0, 40.0], [100.0, 20.0], [0.0, 0.0]],
                      [[5.0, 6.0], [70.0, 80.0], [90.0, 10.0]]], np.float32)
    labels = np.asarray([[1, 0, -1], [0, 1, 1]], np.int32)  # a padded point in row 0
    boxes = np.asarray([[[10.0, 10.0], [90.0, 90.0]], [[3.0, 30.0], [60.0, 120.0]]], np.float32)
    return pts, labels, boxes


@pytest.mark.parametrize("kind", ["points", "box", "points_box"])
def test_prompt_encoder_matches_jax(sam, kind):
    jm, v, tm, _ = sam
    pts, labels, boxes = prompts()
    args = (pts if "points" in kind else None, labels if "points" in kind else None,
            boxes if "box" in kind else None)

    def f(v, p, lab, bx):
        return jm.apply(v, method=lambda m: m.prompt_encoder(p, lab, bx, img_size=float(S)))

    want = LowOpt(f)(v, *args)
    with torch.no_grad():
        got = tm.prompt_encoder(*[None if a is None else torch.from_numpy(a) for a in args],
                                img_size=float(S))
    assert_close(got, want, what="sparse")
    dense = LowOpt(lambda v: jm.apply(v, method=lambda m: m.prompt_encoder.dense_pe(8, 6)))(v)
    assert_close(tm.prompt_encoder.dense_pe(8, 6).detach(), dense, what="dense_pe")


@pytest.mark.parametrize("kind", ["points", "box", "points_box", "none"])
def test_decoder_matches_jax(sam, kind):
    """Masks and IoU of the two-way decoder on the JAX embedding (batch 2;
    batch 1 without a prompt, the only batch JAX decodes prompt-free)."""
    jm, v, tm, _ = sam
    pts, labels, boxes = prompts()
    emb = np.asarray(LowOpt(lambda v, x: jm.apply(v, x, method=jm.encode_image))(
        v, jnp.asarray(image(2, S, S, b=2))))
    if kind == "none":
        emb = emb[:1]
    args = (emb, pts if "points" in kind else None, labels if "points" in kind else None,
            boxes if "box" in kind else None)
    wm, wi = LowOpt(lambda v, e, p, lab, bx: jm.apply(v, e, p, lab, bx, method=jm.decode))(
        v, *args)
    with torch.no_grad():
        gm, gi = tm.decode(*[None if a is None else torch.from_numpy(a) for a in args])
    assert gm.shape == (emb.shape[0], 4, 32, 32)
    assert_close(gm, wm, what="masks")
    assert_close(gi, wi, what="iou")


def test_predictor_matches_jax(sam):
    """``SAMPredictor`` on a non-square uint8 image: a point, a box with
    ``multimask_output=False``; the JAX masks' float maps from cv2."""
    import cv2

    jm, v, tm, jp = sam
    img = np.random.default_rng(3).integers(0, 256, (100, 160, 3), dtype=np.uint8)
    tp = TS.SAMPredictor(tm, img_size=S)
    jp.set_image(img)
    tp.set_image(img)
    assert_close(tp._embed, jp._embed, what="embedding")
    r, px, py = jp._meta

    def jax_floats(p, lab, bx):
        masks = np.asarray(jp._decode(v, jp._embed, p, lab, bx)[0][0])
        out = []
        for m in masks:
            full = cv2.resize(m, (S, S), interpolation=cv2.INTER_LINEAR)
            crop = full[int(py):S - int(py) or None, int(px):S - int(px) or None]
            out.append(cv2.resize(crop, (160, 100), interpolation=cv2.INTER_LINEAR))
        return np.stack(out)

    for kw, multi in (({"points": [[80, 50], [20, 90]], "point_labels": [1, 0]}, True),
                      ({"boxes": [20, 20, 120, 80]}, False)):
        wm, wi = jp.predict(**kw, multimask_output=multi)
        gm, gi = tp.predict(**kw, multimask_output=multi)
        assert gm.dtype == bool and gm.shape == wm.shape == ((4 if multi else 1), 100, 160)
        assert_close(gi, wi, what="iou")
        p, lab, bx = TS.letterbox_meta_prompts(jp._meta, kw.get("points"),
                                               kw.get("point_labels"), kw.get("boxes"))
        floats = jax_floats(p, lab, bx)[:len(wm)]
        for k in range(len(wm)):
            assert_bool_near(gm[k], wm[k], floats[k], what=f"mask {k}")
        assert_close(TS.mask_to_image(tp.decode(**kw)[0][0].numpy(), S, tp._meta, (100, 160)),
                     floats[0], what="float map")


@pytest.mark.parametrize("hw,out", [((32, 48), (96, 64)), ((100, 60), (23, 37)),
                                    ((64, 96), (48, 32)), ((256, 256), (1024, 1024)),
                                    ((1024, 683), (540, 810))],
                         ids=["enlarge", "shrink", "exact_2x", "mask_to_img_size", "to_image"])
@pytest.mark.parametrize("channels", [None, 3])
def test_float_resize_matches_cv2(hw, out, channels):
    """``resize_linear_f32`` against ``cv2.resize(INTER_LINEAR)`` on
    float32, bit for bit (``out`` is (width, height))."""
    cv2 = pytest.importorskip("cv2")
    shape = hw if channels is None else (*hw, channels)
    a = np.random.default_rng(sum(hw)).normal(size=shape).astype(np.float32) * 10
    want = cv2.resize(a, out, interpolation=cv2.INTER_LINEAR)
    got = resize_linear_f32(a, out)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)


def amg_points(n_side=4, bs=8):
    pts = (JS.build_point_grid(n_side) * S).astype(np.float32)[:bs]
    return pts[:, None, :], np.ones((bs, 1), np.float32)


def test_amg_batch_fn_matches_jax(sam):
    """The device batch: keep flags, boxes and binary masks, with the
    thresholds at midpoints of JAX's own IoU and stability values (so that
    both sides of each are taken)."""
    jm, v, tm, jp = sam
    img = np.random.default_rng(4).integers(0, 256, (96, 130, 3), dtype=np.uint8)
    jp.set_image(img)
    pts, lab = amg_points()
    emb = np.broadcast_to(np.asarray(jp._embed), (len(pts),) + jp._embed.shape[1:])
    masks, iou = (np.asarray(a) for a in jp._decode(v, emb, pts, lab, None))
    masks, iou = masks.reshape(-1, *masks.shape[2:]), iou.reshape(-1)
    stab = (masks > 0.95).sum((1, 2)) / np.maximum((masks > -0.95).sum((1, 2)), 1)

    def mid(x):
        s = np.sort(x)
        return float((s[len(s) // 2 - 1] + s[len(s) // 2]) / 2)

    kw = dict(points_batch_size=8, conf_thres=mid(iou), stability_score_thresh=mid(stab))
    jgen = JS.SAMAutoMaskGenerator(jp, **kw)
    jgen._batch_fn = LowOpt(jgen._batch_fn.__wrapped__)
    wb, wi, wbox, wk = (np.asarray(a) for a in jgen._batch_fn(v, jp._embed, pts, lab))
    tp = TS.SAMPredictor(tm, img_size=S).set_image(img)
    gb, gi, gbox, gk = (t.numpy() for t in TS.SAMAutoMaskGenerator(tp, **kw).batch_fn(
        tp._embed, torch.from_numpy(pts), torch.from_numpy(lab)))
    assert 0 < wk.sum() < len(wk)
    assert np.array_equal(gk, wk)
    assert_close(gi, wi, what="iou")
    for k in range(len(wb)):
        if assert_bool_near(gb[k], wb[k], masks[k], what=f"mask {k}") == 0:
            assert np.array_equal(gbox[k], wbox[k])


@pytest.mark.parametrize("crop_n_layers", [0, 1])
def test_amg_host_stage_matches_jax(sam, crop_n_layers):
    """The host stage (crop-edge filter, NMS per crop and across crops, the
    uncrop) fed the device outputs JAX's ``generate`` made: JAX's masks,
    scores and boxes exactly. The filters are off and the mask threshold
    near the logits' median, so that the random decoder's masks differ a
    little and NMS at 0.98 keeps some of them."""
    jm, v, tm, jp = sam
    img = np.random.default_rng(5).integers(0, 256, (96, 130, 3), dtype=np.uint8)
    kw = dict(points_stride=4, points_batch_size=8, conf_thres=-1e9, stability_score_thresh=-1.0,
              mask_threshold=0.25, iou_thres=0.98)
    jgen = JS.SAMAutoMaskGenerator(jp, **kw)
    batch_fn, outs = LowOpt(jgen._batch_fn.__wrapped__), []
    jgen._batch_fn = lambda *a: outs.append(batch_fn(*a)) or outs[-1]
    wm, ws, wb = jgen.generate(img, crop_n_layers=crop_n_layers)
    gen = TS.SAMAutoMaskGenerator(TS.SAMPredictor(tm, img_size=S), **kw)
    regions, layers = TS.generate_crop_boxes((S, S), crop_n_layers, 512 / 1500)
    grids = TS.build_all_layer_point_grids(4, crop_n_layers, 1)
    per_crop, it = [], iter(outs)
    for region, layer in zip(regions, layers):
        n = len(grids[layer])
        valid = np.concatenate([np.ones(n, bool), np.zeros((-n) % 8, bool)])
        kept = [gen.keep_batch(*(torch.from_numpy(np.asarray(a)) for a in next(it)),
                               valid[b0:b0 + 8]) for b0 in range(0, len(valid), 8)]
        kept = [k for k in kept if k is not None]
        per_crop.append((region, layer, *(np.concatenate(z) for z in zip(*kept)))
                        if kept else (region, layer, None, None, None))
    assert next(it, None) is None
    gm, gs, gb = gen.host_stage(per_crop, img.shape[:2], jp._meta)
    n_candidates = sum(len(c[2]) for c in per_crop if c[2] is not None)
    assert n_candidates > len(ws) > 1 and gm.shape == wm.shape == (len(ws), 96, 130)
    assert np.array_equal(gs, ws) and np.array_equal(gb, wb) and np.array_equal(gm, wm)


def test_amg_generate_runs(sam):
    """``generate`` end to end on the port (crop layers 0 and 1): shapes and
    the original-space boxes, as the JAX test holds its own."""
    _, _, tm, _ = sam
    img = np.random.default_rng(0).integers(0, 255, (96, 130, 3)).astype(np.uint8)
    gen = TS.SAMAutoMaskGenerator(TS.SAMPredictor(tm, img_size=S), points_stride=4,
                                  points_batch_size=8, conf_thres=-1e9,
                                  stability_score_thresh=-1.0)
    for layers in (0, 1):
        masks, scores, boxes = gen.generate(img, crop_n_layers=layers)
        assert masks.shape[1:] == (96, 130) and len(masks) == len(scores) == len(boxes) >= 1
        assert boxes[:, 0].min() >= 0 and boxes[:, 2].max() <= 130


def test_amg_grid_helpers_match_jax():
    for n in (1, 4, 32):
        assert np.array_equal(TS.build_point_grid(n), JS.build_point_grid(n))
    for args in ((32, 1, 2), (16, 2, 2)):
        for a, b in zip(TS.build_all_layer_point_grids(*args),
                        JS.build_all_layer_point_grids(*args)):
            assert np.array_equal(a, b)
    for args in (((100, 200), 1, 0.34), ((1024, 1024), 2, 512 / 1500)):
        assert TS.generate_crop_boxes(*args) == JS.generate_crop_boxes(*args)
    masks = np.zeros((3, 9, 11), bool)
    masks[0, 2:5, 3:8] = True
    masks[2, 8, 0] = True
    assert np.array_equal(TS.masks_to_boxes(torch.from_numpy(masks)).numpy(),
                          np.asarray(JS._masks_to_boxes(jnp.asarray(masks))))
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 50, (60, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (60, 2)).astype(np.float32)], 1)
    scores = rng.random(60).astype(np.float32)
    assert np.array_equal(TS.greedy_nms(boxes, scores, 0.3), JS._greedy_nms(boxes, scores, 0.3))


@pytest.mark.parametrize("variant", list(SAM_COUNTS))
def test_build_sam_param_counts(variant):
    with torch.device("meta"):
        m = build_sam(variant, device="meta")
    assert sum(p.numel() for p in m.parameters()) == SAM_COUNTS[variant]


def test_build_sam_refuses_unknown_variant():
    with pytest.raises(ValueError):
        build_sam("nope", device="cpu")


def test_seeded_init_follows_flax():
    """The port's own init: zero rel-pos tables and biases, unit-scale
    tokens, 0.02-scale pos_embed, lecun-scale kernels; the same seed gives
    the same weights."""
    a = TS.SAM(img_size=64, encoder_dim=64, encoder_depth=1, device="cpu", seed=3)
    b = TS.SAM(img_size=64, encoder_dim=64, encoder_depth=1, device="cpu", seed=3)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    enc, dec = a.image_encoder, a.mask_decoder
    with torch.no_grad():
        assert not enc.block0.attn.rel_pos_h.any() and not enc.block0.attn.qkv.bias.any()
        assert 0.01 < float(enc.pos_embed.std()) < 0.03
        assert 0.7 < float(dec.mask_tokens.std()) < 1.3
        assert 0.7 < float(a.prompt_encoder.pe_gaussian.std()) < 1.3
        w = enc.block0.mlp.Dense_0.weight
        assert abs(float(w.std()) * np.sqrt(64) - 1) < 0.1
        assert float(w.abs().max()) <= 2 / np.sqrt(64) / 0.8796 + 1e-6
