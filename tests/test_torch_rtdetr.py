"""Port parity: RT-DETR (``xlstm_yolo_torch/nn/rtdetr.py``, ``RepC3``,
``LightConv``, the rtdetr task) against the JAX package.

On the CPU, fp32, torch on one thread. Tolerances: forward outputs and
losses within 1e-5 of their max (``TOL_FWD``), gradients within 1e-4 of
each tensor's max (``TOL_GRAD``).

* the blocks, NHWC for JAX and NCHW for the port, on seeded numpy variables
  in the JAX tree's structure loaded through ``load_jax_variables``:
  ``HGStem`` (its -inf padded max pool at an odd size), ``HGBlock``
  (plain, ``lightconv``, ``shortcut``), ``LightConv``, ``RepC3`` (e 1;
  e 0.5 where c2 e rounds to 1, so the sum broadcasts and ``cv3`` runs;
  both packages refuse any other e 0.5), ``AIFI``;
* ``deform_sample`` forward and its gradients with respect to the value,
  the locations and the weights against ``jax.grad``, with locations
  inside, on and outside [0, 1]; in bf16 on an 80 x 80 map;
* ``MSDeformAttn``, and ``DeformableDecoderLayer`` under the denoising
  mask;
* ``RTDETRDecoder`` in eval and with denoising queries on maps of 56, 28
  and 14: the 220 border anchors of P3 are invalid and share one score,
  which the test puts among the selected ones, so the selection order of
  tied scores shows; ``ranked`` against ``jax.lax.top_k`` on tied scores;
* ``cdn_attn_mask``; ``get_cdn_group``'s invariants from a torch generator
  and ``cdn_from_draws`` on JAX's own draws; ``_host_hungarian``;
* ``rtdetr_loss`` and ``cdn_loss`` on the same decoder outputs and JAX's
  denoising draws: the Hungarian matches equal, the terms, and the
  gradients with respect to every output; ``rtdetr_postprocess`` with tied
  scores;
* ``tests/test_rtdetr.py``'s tiny graph (plain convs under an
  ``RTDETRDecoder``) through ``TaskModel.predictions_full`` and, in train
  mode on JAX's draws and JAX's ReLU signs, ``.loss`` and every gradient
  (fp32 rounding flips a few ReLU kinks of the decoder's FFNs and
  query-position MLP, which moves those tensors by up to 3e-3 of their own
  max between the packages; on one sign pattern they agree within 2e-5);
* the five RT-DETR YAMLs (``yolov8-rtdetr`` at every scale): the port's
  graph on the meta device, its parameter count (from the JAX
  ``eval_shape`` tree) and, for yolov8-rtdetr n and a small graph of every
  RT-DETR row, its keys and shapes against that tree;
* ``YOLO`` on a small RT-DETR YAML of every block on the CPU: predict (fp32
  and bf16), one epoch with ``val=False``, save and reload, info, fuse,
  reset_weights and load; ``val``, ``train`` with
  validation and ``embed`` raise.
"""
import copy

import numpy as np
import pytest
import torch
import yaml

import flax.linen
import jax
import jax.numpy as jnp

from test_torch_detect_zoo import compiled, jax_task_model
from test_torch_yolo11 import nchw, nhwc, one_thread, seeded_variables  # noqa: F401
from xlstm_yolo_tpu.cfg import load_model_yaml as jax_load_model_yaml
from xlstm_yolo_tpu.nn import modules as JM
from xlstm_yolo_tpu.nn import rtdetr as JR
from xlstm_yolo_torch import YOLO
from xlstm_yolo_torch.cfg import load_model_yaml
from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset
from xlstm_yolo_torch.nn import modules as TM
from xlstm_yolo_torch.nn import rtdetr as TR
from xlstm_yolo_torch.nn.graph import GraphModel, parse_model
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.jax_weights import (
    flatten_variables, load_jax_variables, port_named, torch_name)

TOL_FWD = 1e-5
TOL_GRAD = 1e-4

# tests/test_rtdetr.py's tiny graph: plain convs to P5 under the decoder
TINY = {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                              [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                              [-1, 1, "Conv", [32, 3, 2]]],
        "head": [[[2, 3, 4], 1, "RTDETRDecoder", [3]]]}

# every RT-DETR block at small widths, for the facade
SMALL = {"nc": 3, "backbone": [
    [-1, 1, "HGStem", [8, 16]],                          # 0 P2/4
    [-1, 2, "HGBlock", [8, 32, 3]],                      # 1
    [-1, 1, "DWConv", [32, 3, 2, 1, False]],             # 2 P3/8
    [-1, 2, "HGBlock", [16, 32, 5, True, True]],         # 3
    [-1, 1, "DWConv", [64, 3, 2, 1, False]],             # 4 P4/16
    [-1, 1, "LightConv", [64, 3]],                       # 5
    [-1, 1, "DWConv", [64, 3, 2, 1, False]]],            # 6 P5/32
    "head": [
    [-1, 1, "Conv", [32, 1, 1, None, 1, 1, False]],      # 7
    [-1, 1, "AIFI", [64, 4]],                            # 8
    [-1, 1, "nn.Upsample", [None, 2, "nearest"]],        # 9
    [[-1, 5], 1, "Concat", [1]],                         # 10
    [-1, 2, "RepC3", [32]],                              # 11 P4
    [[3, 11, 8], 1, "RTDETRDecoder", ["nc"]]]}           # 12

# the five YAMLs: (YAML, scale, the JAX TaskModel's parameters at nc 80)
YAMLS = [("rtdetr-l.yaml", None, 32_970_476), ("rtdetr-x.yaml", None, 67_467_852),
         ("rtdetr-resnet50.yaml", None, 42_925_132), ("rtdetr-resnet101.yaml", None, 61_917_260),
         ("yolov8-rtdetr.yaml", "n", 9_643_868), ("yolov8-rtdetr.yaml", "s", 16_518_572),
         ("yolov8-rtdetr.yaml", "m", 29_645_180), ("yolov8-rtdetr.yaml", "l", 45_644_364),
         ("yolov8-rtdetr.yaml", "x", 67_113_884)]


def to_cxcywh(xyxy):
    return np.concatenate([(xyxy[..., :2] + xyxy[..., 2:]) / 2, xyxy[..., 2:] - xyxy[..., :2]], -1)


def assert_close(got, want, tol=TOL_FWD, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def loaded(tm, v):
    """The port module with the JAX variables ``v`` (no missing or extra
    key), in eval mode; its parameter count equals the tree's."""
    tm = load_jax_variables(tm, flatten_variables(v)).eval()
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree.leaves(v["params"]))
    return tm


def check_block(jm, tm, x, seed):
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    tm = loaded(tm, v)
    want = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    assert_close(got.numpy().transpose(0, 2, 3, 1), want)


def test_hgstem_matches_jax():
    check_block(JR.HGStem(8, 16), TR.HGStem(3, 8, 16), nhwc(0, hw=27, c=3), 0)


@pytest.mark.parametrize("light,shortcut", [(False, False), (True, False), (True, True)],
                         ids=["plain", "lightconv", "shortcut"])
def test_hgblock_matches_jax(light, shortcut):
    c2 = 32 if shortcut else 48
    check_block(JR.HGBlock(16, c2, k=5 if light else 3, n=3, lightconv=light, shortcut=shortcut),
                TR.HGBlock(32, 16, c2, k=5 if light else 3, n=3, lightconv=light,
                           shortcut=shortcut), nhwc(1), 1)


def test_lightconv_matches_jax():
    check_block(JM.LightConv(24, 5), TM.LightConv(32, 24, 5), nhwc(2), 2)


@pytest.mark.parametrize("c2,e", [(48, 1.0), (2, 0.5)], ids=["e1", "e0.5_c2"])
def test_repc3_matches_jax(c2, e):
    tm = TM.RepC3(32, c2, n=2, e=e)
    assert (tm.cv3 is not None) == (e != 1.0)
    check_block(JM.RepC3(c2, n=2, e=e), tm, nhwc(3), 3)


def test_repc3_half_width_raises_in_both():
    """c2 e = 8 channels added to 16: no broadcast, in either package."""
    x = nhwc(4, c=8)
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(lambda: JM.RepC3(16, n=1, e=0.5).init(jax.random.PRNGKey(0),
                                                              jnp.asarray(x)))
    with pytest.raises(RuntimeError, match="size of tensor"):
        TM.RepC3(8, 16, n=1, e=0.5)(nchw(x))


def test_aifi_matches_jax():
    x = nhwc(5, hw=6, c=32)[:, :, :5]  # 6 x 5: rows and columns differ
    check_block(JR.AIFI(32, num_heads=4, cm=64), TR.AIFI(32, num_heads=4, cm=64), x, 5)


SHAPES = [(6, 7), (3, 4)]


def sample_inputs(seed):
    """value (B, L, NH, DH), locs with entries inside, exactly on and outside
    [0, 1], weights."""
    rng = np.random.default_rng(seed)
    b, q, nh, dh, npnt = 2, 5, 2, 3, 4
    n = sum(h * w for h, w in SHAPES)
    value = rng.normal(size=(b, n, nh, dh)).astype(np.float32)
    locs = rng.uniform(-0.3, 1.3, (b, q, nh, len(SHAPES), npnt, 2)).astype(np.float32)
    locs[0, 0, 0, :, 0] = 0.0
    locs[0, 0, 1, :, 1] = 1.0
    locs[1, 1, 0, 0, :2] = [[0.0, 1.0], [1.0, 0.0]]
    weights = rng.uniform(0, 1, (b, q, nh, len(SHAPES) * npnt)).astype(np.float32)
    return value, locs, weights


def test_deform_sample_and_grads_match_jax():
    value, locs, weights = sample_inputs(6)
    inside = ((locs >= 0) & (locs <= 1)).all(-1)
    assert inside.any() and (~inside).any() and ((locs == 0) | (locs == 1)).any()
    cot = np.random.default_rng(7).normal(size=(2, 5, 6)).astype(np.float32)
    f = lambda v, l, w: jnp.sum(JR.deform_sample(v, SHAPES, l, w) * cot)
    jargs = [jnp.asarray(a) for a in (value, locs, weights)]
    want = jax.jit(lambda v, l, w: JR.deform_sample(v, SHAPES, l, w))(*jargs)
    wgrads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*jargs)
    args = [torch.from_numpy(a).requires_grad_() for a in (value, locs, weights)]
    got = TR.deform_sample(args[0], SHAPES, args[1], args[2])
    assert_close(got.detach(), want)
    (got * torch.from_numpy(cot)).sum().backward()
    for a, w, name in zip(args, wgrads, ("value", "locs", "weights")):
        assert_close(a.grad, w, TOL_GRAD, name)


def test_deform_sample_bf16_indexes_an_80_map():
    """bf16 serving samples P3 of 640 px (80 x 80): the pixel index y w + x
    reaches 6399, which bf16 cannot hold, so it is formed in integers (JAX
    casts the corners to int32); the bf16 result against JAX's bf16 one (the
    pixel coordinates themselves round to halves in bf16, in both)."""
    rng = np.random.default_rng(19)
    value = torch.from_numpy(rng.normal(size=(1, 6400, 2, 4)).astype(np.float32))
    locs = torch.from_numpy(rng.uniform(0.9, 1.0, (1, 50, 2, 1, 4, 2)).astype(np.float32))
    weights = torch.from_numpy(rng.uniform(0, 1, (1, 50, 2, 4)).astype(np.float32))
    args = [a.bfloat16() for a in (value, locs, weights)]
    got = TR.deform_sample(args[0], [(80, 80)], args[1], args[2])
    j = [jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in args]
    want = JR.deform_sample(j[0], [(80, 80)], j[1], j[2])
    assert_close(got.float(), np.asarray(want, np.float32), 1e-2)


def msda_inputs(seed, c=16, q=6):
    rng = np.random.default_rng(seed)
    n = sum(h * w for h, w in SHAPES)
    query = rng.normal(size=(2, q, c)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (2, q, 4)).astype(np.float32)
    ref[..., 2:] *= 0.5
    value = rng.normal(size=(2, n, c)).astype(np.float32)
    return query, ref, value


def test_msdeformattn_matches_jax():
    query, ref, value = msda_inputs(8)
    jm = JR.MSDeformAttn(16, num_heads=2, n_levels=2, n_points=3)
    fn = lambda v, q, r, val: jm.apply(v, q, r, val, SHAPES)
    args = [jnp.asarray(a) for a in (query, ref, value)]
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), *args, SHAPES), 8)
    tm = loaded(TR.MSDeformAttn(16, num_heads=2, n_levels=2, n_points=3), v)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (query, ref, value)), SHAPES)
    assert_close(got, jax.jit(fn)(v, *args))


def test_decoder_layer_with_cdn_mask_matches_jax():
    num_dn, num_group, nq = 4, 2, 6
    query, ref, value = msda_inputs(9, q=num_dn + nq)
    pos = np.random.default_rng(10).normal(size=query.shape).astype(np.float32)
    jmask = JR.cdn_attn_mask(num_dn, num_group, nq)
    jm = JR.DeformableDecoderLayer(16, num_heads=2, n_levels=2, n_points=3, cm=24)
    args = [jnp.asarray(a) for a in (query, ref, value)]
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), args[0], args[1], args[2],
                                         SHAPES, jnp.asarray(pos), jmask), 9)
    want = jax.jit(lambda v, q, r, val, p: jm.apply(v, q, r, val, SHAPES, p, jmask))(
        v, *args, jnp.asarray(pos))
    tm = loaded(TR.DeformableDecoderLayer(16, num_heads=2, n_levels=2, n_points=3, cm=24), v)
    mask = TR.cdn_attn_mask(num_dn, num_group, nq)
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (query, ref, value)), SHAPES,
                 torch.from_numpy(pos), mask)
    assert_close(got, want)
    with torch.no_grad():  # the mask matters here
        assert (tm(*(torch.from_numpy(a) for a in (query, ref, value)), SHAPES,
                   torch.from_numpy(pos)) - got).abs().max() > 1e-3


def test_cdn_attn_mask_matches_jax():
    for num_dn, num_group, nq in ((12, 3, 5), (0, 3, 4), (8, 2, 1)):
        assert np.array_equal(TR.cdn_attn_mask(num_dn, num_group, nq).numpy(),
                              np.asarray(JR.cdn_attn_mask(num_dn, num_group, nq)))


def test_ranked_orders_ties_as_lax_top_k():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 5, (4, 300)).astype(np.float32)  # every value tied many times
    x[1] = 3.0  # one row all tied
    for k in (1, 7, 150, 300):
        _, want = jax.lax.top_k(jnp.asarray(x), k)
        assert np.array_equal(TR.ranked(torch.from_numpy(x), k).numpy(), np.asarray(want))
    assert np.array_equal(TR.ranked(torch.tensor([[1., 3, 3, 3, 0]]), 3).numpy(), [[1, 2, 3]])


FEAT_HW = (56, 28, 14)


def decoder_case(seed=12, nc=3, hd=32):
    """(JAX decoder, its variables, port decoder, feats NHWC) on maps of
    56, 28 and 14 with every class logit of the invalid anchors' shared
    feature raised, so that their tied score ranks among the selected; the
    decoder selects that many more than the anchors above the tie, so that
    only the lower-indexed half of the 220 tied anchors is taken."""
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(2, s, s, 8)).astype(np.float32) for s in FEAT_HW]
    kw = dict(nc=nc, ch=(8, 8, 8), hd=hd, ndl=2, nh=4, ndp=2)
    jfeats = [jnp.asarray(f) for f in feats]
    v = seeded_variables(lambda: JR.RTDETRDecoder(nq=300, **kw).init(
        jax.random.PRNGKey(0), jfeats, dn=(jnp.zeros((2, 6), jnp.int32),
                                           jnp.full((2, 6, 4), 0.5), 3)), seed)
    p = jax.tree.map(np.array, v["params"])
    b = p["enc_output"]["bias"]
    f0 = (b - b.mean()) / np.sqrt(b.var() + 1e-6) * p["enc_output_norm"]["scale"] \
        + p["enc_output_norm"]["bias"]  # the invalid anchors' shared feature
    p["enc_score_head"]["kernel"] = (0.4 * f0[:, None] + 0.02 * rng.normal(size=(hd, nc))
                                     ).astype(np.float32)
    v = {**v, "params": jax.tree.map(jnp.asarray, p)}
    tm = loaded(TR.RTDETRDecoder(nq=300, **kw), v)
    with torch.no_grad():
        scores = _enc_max_scores(tm, [nchw(f) for f in feats])
    invalid = TR._build_anchors([(s, s) for s in FEAT_HW])[1][0, :, 0] == 0
    assert int(invalid.sum()) == 220
    tie = scores[:, invalid]
    assert (tie == tie[:, :1]).all()
    above = int((scores[0] > tie[0, 0]).sum())
    assert above == int((scores[1] > tie[1, 0]).sum())  # one cut for both images
    nq = above + 110
    tm.nq = nq
    return JR.RTDETRDecoder(nq=nq, **kw), v, tm, feats


def _enc_max_scores(tm, feats):
    value = torch.cat([getattr(tm, f"input_proj{i}")(f).flatten(2).transpose(1, 2)
                       for i, f in enumerate(feats)], 1)
    valid = TR._build_anchors([tuple(f.shape[2:]) for f in feats])[1]
    feat = tm.enc_output_norm(TR._dense(value * valid, tm.enc_output))
    return TR._dense(feat, tm.enc_score_head).max(-1)[0]


def test_decoder_matches_jax_with_tied_selection():
    jm, v, tm, feats = decoder_case()
    jfeats = [jnp.asarray(f) for f in feats]
    want = jax.jit(lambda v, f: jm.apply(v, f))(v, jfeats)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    for k in ("boxes", "scores", "aux_boxes", "aux_scores", "enc_boxes", "enc_scores"):
        assert_close(got[k], want[k], what=k)
    # the selected queries: some tied anchors taken, in index order
    sel = TR.ranked(_enc_max_scores(tm, [nchw(f) for f in feats]).detach(), tm.nq)
    _, jsel = jax.lax.top_k(jnp.max(want["enc_scores"], -1), tm.nq)
    assert np.array_equal(sel.numpy(), np.asarray(jsel))

    # denoising queries, in train mode (batch statistics, detached selection)
    key = jax.random.PRNGKey(3)
    gt = jnp.asarray([[[0.5, 0.5, 0.3, 0.2], [0.2, 0.3, 0.1, 0.2]]] * 2)
    dn_cls, dn_box, *_ = JR.get_cdn_group(jnp.asarray([[1, 2]] * 2), gt, jnp.ones((2, 2)), 3,
                                          key, num_group=3)
    fn = lambda v, f: jm.apply(v, f, train=True, dn=(dn_cls, dn_box, 3),
                               mutable=["batch_stats"])[0]
    want = jax.jit(fn)(v, jfeats)
    tm.train()
    with torch.no_grad():
        got = tm([nchw(f) for f in feats], dn=(torch.from_numpy(np.asarray(dn_cls)),
                                               torch.from_numpy(np.asarray(dn_box)), 3))
    for k in ("boxes", "scores", "aux_boxes", "dn_boxes", "dn_scores"):
        assert_close(got[k], want[k], what=k)


def test_cdn_group_invariants_and_jax_draws():
    gt_cls = torch.tensor([[1, 2, 0]])
    gt_box = torch.tensor([[[0.5, 0.5, 0.2, 0.2], [0.3, 0.3, 0.1, 0.1], [0, 0, 0, 0]]])
    mask = torch.tensor([[1.0, 1.0, 0.0]])
    dn_cls, dn_box, dn_pos, dn_valid, idx = TR.get_cdn_group(
        gt_cls, gt_box, mask, 3, torch.Generator().manual_seed(0), num_group=2)
    d = 2 * 3 * 2
    assert dn_cls.shape == (1, d) and dn_box.shape == (1, d, 4) and idx.shape == (1, d)
    assert dn_pos.tolist() == [[1, 1, 0, 0, 0, 0] * 2] and dn_valid.tolist() == [[1, 1, 0] * 4]
    assert 0 <= float(dn_box.min()) and float(dn_box.max()) <= 1
    assert ((dn_cls >= 0) & (dn_cls < 3)).all()
    # each edge moved within 1/2 of the size (positives: their edges never
    # cross); by [1/2, 3/2) of it (negatives: the edges may cross, so either
    # pairing of the box's edges with the source's), where not clipped
    for gen_seed in (0, 1):
        box = TR.get_cdn_group(gt_cls, gt_box, mask, 3, torch.Generator().manual_seed(gen_seed),
                               num_group=2)[1][0]
        for ax in (0, 1):
            c, s = gt_box[0, idx[0], ax], gt_box[0, idx[0], 2 + ax]
            src = torch.stack([c - s / 2, c + s / 2], -1)
            half = box[:, 2 + ax] / 2
            edges = torch.stack([box[:, ax] - half, box[:, ax] + half], -1)
            free = (edges > 1e-6) & (edges < 1 - 1e-6)
            move = (edges - src).abs() / s[:, None]
            swap = (edges - src.flip(-1)).abs() / s[:, None]
            pos, neg = [0, 1, 6, 7], [3, 4, 9, 10]
            assert ((move[pos] <= 0.5 + 1e-5) | ~free[pos]).all()
            in_band = lambda m: (((m >= 0.5 - 1e-5) & (m <= 1.5 + 1e-5)) | ~free[neg]).all(-1)
            assert (in_band(move[neg]) | in_band(swap[neg])).all()
    # the same function on JAX's draws
    key = jax.random.PRNGKey(4)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    b, dd = 1, d
    draws = (jax.random.uniform(k1, (b, dd)) < 0.25, jax.random.randint(k2, (b, dd), 0, 3),
             jax.random.randint(k3, (b, dd, 4), 0, 2) * 2.0 - 1.0,
             jax.random.uniform(k4, (b, dd, 4)))
    want = JR.get_cdn_group(jnp.asarray(gt_cls.numpy()), jnp.asarray(gt_box.numpy()),
                            jnp.asarray(mask.numpy()), 3, key, num_group=2)
    got = TR.cdn_from_draws(gt_cls, gt_box, mask, 2,
                            *(torch.from_numpy(np.asarray(a)) for a in draws))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)


def test_host_hungarian_matches_jax():
    cost = np.random.default_rng(13).normal(size=(3, 10, 4)).astype(np.float32)
    n_valid = np.asarray([4, 0, 2])
    got = TR._host_hungarian(cost, n_valid)
    assert np.array_equal(got, JR._host_hungarian(cost, n_valid))
    assert (got[1] == -1).all() and (got[2, 2:] == -1).all()


def loss_case(seed=14, nq=20, nc=4, m=5, n_aux=2, num_dn=30):
    rng = np.random.default_rng(seed)
    sig = lambda x: 1 / (1 + np.exp(-x))
    out = {"boxes": sig(rng.normal(size=(2, nq, 4))), "scores": rng.normal(size=(2, nq, nc)),
           "aux_boxes": sig(rng.normal(size=(n_aux, 2, nq, 4))),
           "aux_scores": rng.normal(size=(n_aux, 2, nq, nc)),
           "dn_boxes": sig(rng.normal(size=(2, num_dn, 4))),
           "dn_scores": rng.normal(size=(2, num_dn, nc))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    cb = np.zeros((2, m, 5), np.float32)
    mask = np.zeros((2, m), bool)
    cb[0, :3] = [[1, 10, 10, 40, 50], [3, 30, 5, 60, 30], [0, 2, 20, 30, 62]]
    cb[1, :2] = [[2, 0, 0, 64, 64], [1, 16, 16, 24, 20]]
    mask[0, :3], mask[1, :2] = True, True
    return out, {"cls_boxes": cb, "mask": mask}


def test_rtdetr_loss_and_cdn_loss_match_jax(monkeypatch):
    out, batch = loss_case()
    nc, imgsz = 4, 64.0
    key = jax.random.PRNGKey(5)
    gt = batch["cls_boxes"]
    xyxy = gt[..., 1:5] / imgsz
    cxcywh = to_cxcywh(xyxy)
    _, _, dn_pos, dn_valid, dn_gt_idx = JR.get_cdn_group(
        jnp.asarray(gt[..., 0].astype(np.int32)), jnp.asarray(cxcywh),
        jnp.asarray(batch["mask"].astype(np.float32)), nc, key, num_group=3)
    meta = (dn_pos, dn_valid, dn_gt_idx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    jmatches, tmatches = [], []
    real = JR._host_hungarian
    monkeypatch.setattr(JR, "_host_hungarian", lambda c, n: jmatches.append(real(c, n))
                        or jmatches[-1])
    real_t = TR.hungarian
    monkeypatch.setattr(TR, "hungarian", lambda c, n: tmatches.append(real_t(c, n))
                        or tmatches[-1])

    def jloss(o):
        total, aux = JR.rtdetr_loss(o, jbatch, nc, imgsz)
        dn_total, dn_aux = JR.cdn_loss(o, meta, jbatch, nc, imgsz)
        return total + dn_total, {**aux, **dn_aux}

    (jtotal, jaux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in out.items()})
    tout = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tmeta = tuple(torch.from_numpy(np.asarray(a)) for a in meta)
    total, aux = TR.rtdetr_loss(tout, tbatch, nc, imgsz)
    dn_total, dn_aux = TR.cdn_loss(tout, tmeta, tbatch, nc, imgsz)
    (total + dn_total).backward()
    # the last layer and two auxiliary ones (jit orders JAX's callbacks freely)
    assert len(jmatches) == len(tmatches) == 3
    assert sorted(t.numpy().astype(np.int32).tobytes() for t in tmatches) == sorted(
        j.tobytes() for j in jmatches)
    assert_close(float(total + dn_total), float(jtotal))
    for k, v in {**aux, **dn_aux}.items():
        assert_close(float(v), float(jaux[k]), what=k)
    for k, t in tout.items():
        assert_close(t.grad, jgrads[k], TOL_GRAD, k)


def test_postprocess_matches_jax_with_ties():
    rng = np.random.default_rng(15)
    out = {"boxes": rng.uniform(0.1, 0.9, (2, 30, 4)).astype(np.float32),
           "scores": rng.integers(-3, 3, (2, 30, 5)).astype(np.float32)}  # many ties
    want = JR.rtdetr_postprocess({k: jnp.asarray(v) for k, v in out.items()}, 64.0, max_det=40)
    got = TR.rtdetr_postprocess({k: torch.from_numpy(v) for k, v in out.items()}, 64.0, max_det=40)
    assert_close(got, want)
    assert np.array_equal(got[..., 5].numpy(), np.asarray(want[..., 5]))


@pytest.fixture(scope="module")
def tiny():
    """(JAX TaskModel, its seeded variables, the port TaskModel loaded with
    them) of ``TINY``."""
    jm = jax_task_model(TINY, None, (8, 16, 32))
    v = seeded_variables(lambda: jm.init(0, imgsz=64), 16)
    tm = load_jax_variables(TaskModel(TINY, device="cpu"), flatten_variables(v))
    assert tm.task == jm.task == "rtdetr" and tm.strides == (8, 16, 32)
    assert tm.num_params() == jm.num_params(v)
    return jm, v, tm


def test_tiny_graph_predictions_match_jax(tiny):
    jm, v, tm = tiny
    x = np.random.default_rng(17).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = compiled(jm.predictions_full, v, jnp.asarray(x))(v, jnp.asarray(x))["dets"]
    with torch.no_grad():
        got = tm.eval().predictions_full(torch.from_numpy(x))["dets"]
    assert got.shape == (2, 252, 6)
    assert_close(got, want)
    assert np.array_equal(got[..., 5].numpy(), np.asarray(want[..., 5]))


def test_tiny_graph_train_loss_and_grads_match_jax(tiny, monkeypatch):
    """The train step on JAX's denoising draws and on JAX's ReLU signs
    (recorded in call order from ``flax.linen.relu``, replayed by the
    port's ``F.relu``): the loss and its terms within TOL_FWD, every
    gradient within TOL_GRAD of its own max; the self-attention key biases,
    whose gradient is zero up to rounding (a softmax ignores a shift of
    its logits), of the model's largest gradient; the encoder heads none in
    both."""
    jm, v, tm = tiny
    rng = np.random.default_rng(18)
    img = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    cb = np.zeros((2, 4, 5), np.float32)
    cb[0, :2] = [[1, 8, 8, 40, 40], [2, 4, 30, 20, 60]]
    cb[1, :3] = [[0, 10, 10, 50, 30], [1, 30, 30, 62, 62], [2, 0, 40, 20, 63]]
    mask = cb[..., 3] > 0
    key = jax.random.PRNGKey(7)
    jbatch = {"img": jnp.asarray(img), "cls_boxes": jnp.asarray(cb), "mask": jnp.asarray(mask),
              "dn_key": key}

    def jloss(params):
        (total, aux), _ = jm.loss({**v, "params": params}, jbatch, train=True)
        return total, aux

    signs, real_relu = [], flax.linen.relu

    def recording_relu(x):
        jax.debug.callback(lambda keep: signs.append(np.asarray(keep)), x > 0, ordered=True)
        return real_relu(x)

    monkeypatch.setattr(flax.linen, "relu", recording_relu)
    (jtotal, jaux), jgrads = compiled(jax.value_and_grad(jloss, has_aux=True),
                                      v["params"])(v["params"])
    jax.effects_barrier()
    replayed = iter(signs)

    def replaying_relu(x, inplace=False):
        keep = torch.from_numpy(next(replayed))
        assert keep.shape == x.shape
        return x * keep.to(x.dtype)

    monkeypatch.setattr(torch.nn.functional, "relu", replaying_relu)
    xyxy = cb[..., 1:5] / 64.0
    cxcywh = to_cxcywh(xyxy)
    dn_cls, dn_box, *_ = JR.get_cdn_group(jnp.asarray(cb[..., 0].astype(np.int32)),
                                          jnp.asarray(cxcywh), jnp.asarray(mask, jnp.float32),
                                          3, key, num_group=3)
    tm = copy.deepcopy(tm).train()
    total, aux = tm.loss({"img": torch.from_numpy(img), "cls_boxes": torch.from_numpy(cb),
                          "mask": torch.from_numpy(mask),
                          "dn_queries": (torch.from_numpy(np.asarray(dn_cls)),
                                         torch.from_numpy(np.asarray(dn_box)))})
    total.backward()
    assert signs and next(replayed, None) is None  # every JAX ReLU replayed, in order
    assert set(aux) == set(jaux) == {"box", "cls", "aux", "dn_box", "dn_cls"}
    assert_close(float(total), float(jtotal))
    for k in aux:
        assert_close(float(aux[k]), float(jaux[k]), what=k)
    want = port_named(flatten_variables(jgrads))
    gmax = max(np.abs(g).max() for g in want.values())
    for name, p in tm.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        scale = np.abs(want[name]).max()
        if scale == 0:  # the encoder heads: no gradient, in both
            assert np.abs(g).max() == 0, name
            continue
        if scale < 1e-6 * gmax:  # the key biases: zero up to rounding
            assert name.endswith("self_attn.key.bias"), name
            scale = gmax
        assert np.abs(g - want[name]).max() <= TOL_GRAD * scale, name
    assert np.abs(want["l5.enc_score_head.weight"]).max() == 0


@pytest.mark.parametrize("path,scale,params", YAMLS,
                         ids=[f"{p[:-5]}{s or ''}" for p, s, _ in YAMLS])
def test_yaml_param_count_and_tree_match_jax(path, scale, params):
    """The port's graph on the meta device: its parameter count (the JAX
    ``TaskModel``'s, from ``jax.eval_shape`` of its init), and for
    yolov8-rtdetr n its state-dict keys and shapes against that tree (the
    others are other depths and widths of the same rows; every RT-DETR row
    is in ``test_small_yaml_tree_matches_jax``, the ResNet rows in
    ``tests/test_torch_classify.py``)."""
    cfg, s = load_model_yaml(path)
    with torch.device("meta"):
        g = GraphModel(parse_model(cfg, scale=scale or s))
    assert g.parsed.task == "rtdetr"
    assert sum(p.numel() for p in g.parameters()) == params
    if scale == "n":
        jcfg, js = jax_load_model_yaml(path)
        assert_same_tree(g, jcfg, scale)


def assert_same_tree(g, jcfg, scale):
    """The port graph's state-dict keys and shapes equal the JAX init's
    ``eval_shape`` tree carried through ``torch_name``."""
    jm = jax_task_model(jcfg, scale, (8, 16, 32))
    leaves = jax.tree_util.tree_flatten_with_path(jax.eval_shape(lambda: jm.init(0, imgsz=64)))[0]
    mapped = dict(torch_name("/".join(str(k.key) for k in path), np.empty(sds.shape))
                  for path, sds in leaves)
    state = {k: tuple(t.shape) for k, t in g.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert {k: a.shape for k, a in mapped.items()} == state


def test_small_yaml_tree_matches_jax():
    """Every RT-DETR row (``SMALL``) in one graph: the same tree as JAX's."""
    with torch.device("meta"):
        g = GraphModel(parse_model(dict(SMALL)))
    assert_same_tree(g, dict(SMALL), None)


def test_facade_predict_train_save_and_refusals(tmp_path):
    data = make_synthetic_dataset(tmp_path / "ds", n_train=4, n_val=2, imgsz=64)
    cfg = tmp_path / "rtdetr-small.yaml"
    cfg.write_text(yaml.safe_dump(SMALL))
    m = YOLO(str(cfg), device="cpu")
    assert m.task == m.model.task == "rtdetr" and m.model.strides == (8, 16, 32)
    val_dir = str(tmp_path / "ds" / "images" / "val")
    res = m.predict(val_dir, imgsz=64, conf=0.0, verbose=False)
    # 84 queries x 3 classes at 64 px, every pair above conf 0
    assert len(res) == 2 and all(len(r) == 252 for r in res)
    half = m.predict(val_dir, imgsz=64, conf=0.0, verbose=False, half=True)  # bf16 serving
    assert all(len(r) == 252 and np.isfinite(r.boxes.data).all() for r in half)
    with pytest.raises(ValueError, match="cannot be validated"):
        m.train(data=data, epochs=1, imgsz=64, batch=2, project=str(tmp_path / "runs"),
                name="v")
    m.train(data=data, epochs=1, imgsz=64, batch=2, val=False, max_labels=8, plots=False,
            project=str(tmp_path / "runs"), name="t")
    assert m.model.nc == 3 and np.isfinite(m.metrics["train_loss"])
    before = m.predict(val_dir, imgsz=64, conf=0.01, verbose=False)
    m.save(tmp_path / "w.pt")
    again = YOLO(str(tmp_path / "w.pt"), device="cpu").predict(val_dir, imgsz=64, conf=0.01,
                                                                 verbose=False)
    for a, b in zip(again, before):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)
    with pytest.raises(ValueError, match="cannot be validated"):
        m.val(data=data, imgsz=64)
    with pytest.raises(ValueError, match="embed"):
        m.embed(val_dir, imgsz=64)
    assert m.info().startswith("rtdetr model") and "strides (8, 16, 32)" in m.info()
    m.fuse()  # the BatchNorms folded: the same predictions
    assert not any(isinstance(t, torch.nn.BatchNorm2d) for t in m.model.modules())
    for a, b in zip(m.predict(val_dir, imgsz=64, conf=0.01, verbose=False), before):
        np.testing.assert_allclose(a.boxes.data, b.boxes.data, rtol=1e-4, atol=1e-3)
    m.reset_weights()
    assert m.model.task == "rtdetr" and any(isinstance(t, torch.nn.BatchNorm2d)
                                            for t in m.model.modules())
    m.load(tmp_path / "w.pt")  # back to the trained weights
    for a, b in zip(m.predict(val_dir, imgsz=64, conf=0.01, verbose=False), before):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)
    with pytest.raises(ValueError, match="predictions_full"):
        m.model.predictions(torch.zeros(1, 64, 64, 3))
