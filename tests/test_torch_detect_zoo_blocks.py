"""Port parity: the blocks of the rest of the detect zoo against the JAX package.

On the CPU, NHWC for JAX and NCHW for the port, each block on seeded numpy
variables in the JAX tree's structure (``test_torch_yolo11.seeded_variables``:
BatchNorm variances kept positive), loaded into the port in eval mode;
tolerance 1e-4 of each output's max (fp32, summation order only):

* YOLOv3 / v5 / v6 / v8 variants: ``DWConv``, ``C3``, ``MaxPool``, torch's
  ``nn.ZeroPad2d`` and ``nn.Identity`` (what the graph builds for those
  rows), ``GhostConv``, ``ConvTransposeBN`` (c1 == c2,
  where a loader that did not flip the flax kernel would load wrong weights
  of the right shape, and k 3 / 4 and stride 3, where the flax "SAME"
  padding is uneven), ``C2``, ``SPP``, ``GhostBottleneck`` (stride 1 and
  2), ``C3Ghost``, and ``Detect`` over 2 and 4 taps with its decode;
* YOLOv9: ``ADown`` and ``AConv`` at an odd size (the counted pad),
  ``RepConv``, ``RepBottleneck``, ``RepCSP``, ``RepNCSPELAN4``, ``SPPELAN``,
  ``ELAN1``, ``CBLinear`` and ``CBFuse`` (one input shrunk, where torch's
  ``"nearest"`` picks other pixels than ``jax.image.resize``);
* YOLOv10: ``SCDown``, ``RepVGGDW``, ``CIB`` (with and without ``lk``),
  ``C2fCIB``, ``PSA``, ``v10Detect`` (eval: one2one only; train: both
  branches on batch statistics) and ``v10_postprocess``; TAL's top-k mask
  at k = 1 (the one2one assignment);
* YOLO12: ``AAttn`` (2 heads, area 4 at 8 x 8, so a wrong token or channel
  order shows; and 7 x 7, where the area falls back to 1), ``ABlock`` and
  ``A2C2f`` (area attention, the ``C3k`` form, and ``residual``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_yolo11 import assert_close, nchw, nhwc, one_thread, seeded_variables  # noqa: F401
from xlstm_yolo_tpu.nn import heads as JH
from xlstm_yolo_tpu.nn import modules as JM
from xlstm_yolo_tpu.utils import tal as JT
from xlstm_yolo_torch.nn import heads as TH
from xlstm_yolo_torch.nn import modules as TM
from xlstm_yolo_torch.utils import tal as TT
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def run_block(jm, tm, x, seed):
    """(port output, JAX output) of a block on ``x`` (an NHWC array or a
    list of them), the port loaded with the JAX block's seeded variables
    and in eval mode; the parameter counts equal."""
    jx = [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jx), seed)
    tm = load_jax_variables(tm, flatten_variables(v)).eval()
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree.leaves(v.get("params", {})))
    want = jax.jit(jm.apply)(v, jx)
    with torch.no_grad():
        got = tm([nchw(a) for a in x] if isinstance(x, list) else nchw(x))
    return got, want


def check_block(jm, tm, x, seed):
    got, want = run_block(jm, tm, x, seed)
    assert_close(to_nhwc(got), want)


# (JAX block, port block, input NHWC (batch, size, channels)) by name
BLOCKS = {
    "dwconv": lambda: (JM.DWConv(48, 3, 2), TM.DWConv(32, 48, 3, 2), (2, 8, 32)),
    "c3": lambda: (JM.C3(48, n=2), TM.C3(32, 48, n=2), (2, 8, 32)),
    "c3_no_shortcut": lambda: (JM.C3(32, n=1, shortcut=False),
                               TM.C3(32, 32, n=1, shortcut=False), (2, 6, 32)),
    "maxpool_2_2": lambda: (JM.MaxPool(2, 2), TM.MaxPool(2, 2), (2, 8, 16)),
    "maxpool_3_2": lambda: (JM.MaxPool(3, 2), TM.MaxPool(3, 2), (2, 7, 16)),
    "zeropad": lambda: (JM.ZeroPad2d((1, 2, 3, 0)), torch.nn.ZeroPad2d((1, 2, 3, 0)), (2, 5, 8)),
    "identity": lambda: (JM.Identity(), torch.nn.Identity(), (2, 4, 8)),
    "ghostconv": lambda: (JM.GhostConv(48, 3, 2), TM.GhostConv(32, 48, 3, 2), (2, 8, 32)),
    "convtranspose_c1_eq_c2": lambda: (JM.ConvTransposeBN(32, 2, 2),
                                       TM.ConvTransposeBN(32, 32, 2, 2), (2, 5, 32)),
    "convtranspose_k3": lambda: (JM.ConvTransposeBN(48, 3, 2), TM.ConvTransposeBN(32, 48, 3, 2),
                                 (2, 5, 32)),
    "convtranspose_k4": lambda: (JM.ConvTransposeBN(16, 4, 2), TM.ConvTransposeBN(32, 16, 4, 2),
                                 (2, 4, 32)),
    "convtranspose_s3": lambda: (JM.ConvTransposeBN(16, 2, 3), TM.ConvTransposeBN(24, 16, 2, 3),
                                 (2, 4, 24)),
    "c2": lambda: (JM.C2(48, n=2), TM.C2(32, 48, n=2), (2, 8, 32)),
    "spp": lambda: (JM.SPP(48, (5, 9, 13)), TM.SPP(32, 48, (5, 9, 13)), (2, 8, 32)),
    "ghostbottleneck_s1": lambda: (JM.GhostBottleneck(32), TM.GhostBottleneck(32, 32),
                                   (2, 8, 32)),
    "ghostbottleneck_s2": lambda: (JM.GhostBottleneck(48, 3, 2), TM.GhostBottleneck(32, 48, 3, 2),
                                   (2, 8, 32)),
    "c3ghost": lambda: (JM.C3Ghost(48, n=2), TM.C3Ghost(32, 48, n=2), (2, 8, 32)),
    "adown": lambda: (JM.ADown(48), TM.ADown(32, 48), (2, 7, 32)),
    "aconv": lambda: (JM.AConv(48), TM.AConv(32, 48), (2, 7, 32)),
    "repconv": lambda: (JM.RepConv(48), TM.RepConv(32, 48), (2, 8, 32)),
    "repbottleneck": lambda: (JM.RepBottleneck(32), TM.RepBottleneck(32, 32), (2, 8, 32)),
    "repcsp": lambda: (JM.RepCSP(48, n=2), TM.RepCSP(32, 48, n=2), (2, 8, 32)),
    "repncspelan4": lambda: (JM.RepNCSPELAN4(64, 32, 16, 2), TM.RepNCSPELAN4(32, 64, 32, 16, 2),
                             (2, 8, 32)),
    "sppelan": lambda: (JM.SPPELAN(48, 16), TM.SPPELAN(32, 48, 16), (2, 8, 32)),
    "elan1": lambda: (JM.ELAN1(48, 32, 16), TM.ELAN1(32, 48, 32, 16), (2, 8, 32)),
    "scdown": lambda: (JM.SCDown(48, 3, 2), TM.SCDown(32, 48, 3, 2), (2, 8, 32)),
    "repvggdw": lambda: (JM.RepVGGDW(32), TM.RepVGGDW(32, 32), (2, 8, 32)),
    "cib": lambda: (JM.CIB(32), TM.CIB(32, 32), (2, 8, 32)),
    "cib_lk": lambda: (JM.CIB(32, lk=True), TM.CIB(32, 32, lk=True), (2, 8, 32)),
    "c2fcib": lambda: (JM.C2fCIB(48, n=2, shortcut=True), TM.C2fCIB(32, 48, n=2, shortcut=True),
                       (2, 8, 32)),
    "c2fcib_lk": lambda: (JM.C2fCIB(48, n=2, shortcut=True, lk=True),
                          TM.C2fCIB(32, 48, n=2, shortcut=True, lk=True), (2, 8, 32)),
    "psa": lambda: (JM.PSA(256), TM.PSA(256, 256), (2, 4, 256)),
    "aattn_area4": lambda: (JM.AAttn(64, 2, 4), TM.AAttn(64, 2, 4), (2, 8, 64)),
    "aattn_area_fallback": lambda: (JM.AAttn(64, 2, 4), TM.AAttn(64, 2, 4), (2, 7, 64)),
    "ablock": lambda: (JM.ABlock(64, 2, 1.2, 4), TM.ABlock(64, 2, 1.2, 4), (2, 8, 64)),
    "a2c2f": lambda: (JM.A2C2f(64, n=2, a2=True, area=4), TM.A2C2f(32, 64, n=2, a2=True, area=4),
                      (2, 8, 32)),
    "a2c2f_c3k": lambda: (JM.A2C2f(64, n=2, a2=False, area=-1),
                          TM.A2C2f(32, 64, n=2, a2=False, area=-1), (2, 8, 32)),
    "a2c2f_residual": lambda: (JM.A2C2f(64, n=1, a2=True, area=4, residual=True),
                               TM.A2C2f(64, 64, n=1, a2=True, area=4, residual=True),
                               (2, 8, 64)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
    jm, tm, (b, hw, c) = BLOCKS[name]()
    check_block(jm, tm, nhwc(len(name), b=b, hw=hw, c=c), len(name))


def test_convtranspose_kernel_is_flipped():
    """k 2, stride 2, c1 == c2: the loaded weight is the flax kernel flipped
    in both spatial axes, in (in, out, kh, kw); unflipped, the output
    differs by far more than the tolerance."""
    jm, tm = JM.ConvTransposeBN(32, 2, 2), TM.ConvTransposeBN(32, 32, 2, 2)
    x = nhwc(7, hw=5)
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 7)
    load_jax_variables(tm, flatten_variables(v)).eval()
    kernel = np.asarray(v["params"]["conv"]["kernel"])
    np.testing.assert_array_equal(tm.conv.weight.detach().numpy(),
                                  kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        tm.conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))))
        wrong = to_nhwc(tm(nchw(x)))
    assert np.abs(wrong - want).max() > 1e-2 * np.abs(want).max()


def test_cblinear_matches_jax():
    """A list of two maps (16 and 24 channels) from one conv with bias."""
    got, want = run_block(JM.CBLinear((16, 24)), TM.CBLinear(32, (16, 24)), nhwc(8), 8)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_close(to_nhwc(g), w)


def test_cbfuse_matches_jax_resize():
    """Inputs shrunk 8 -> 4 (torch's ``"nearest"`` takes the even pixels,
    JAX's half-pixel nearest the odd ones) and enlarged 3 -> 4, each the
    ``idx``-th map of a list; the target last."""
    rng = np.random.default_rng(9)
    big = [rng.normal(size=(2, 8, 8, c)).astype(np.float32) for c in (16, 24)]
    small = [rng.normal(size=(2, 3, 3, 24)).astype(np.float32)]
    target = rng.normal(size=(2, 4, 4, 24)).astype(np.float32)
    want = JM.CBFuse((1, 0)).apply({}, [[jnp.asarray(a) for a in big],
                                         [jnp.asarray(a) for a in small], jnp.asarray(target)])
    tm = TM.CBFuse((1, 0))
    got = tm([[nchw(a) for a in big], [nchw(a) for a in small], nchw(target)])
    assert_close(to_nhwc(got), want)
    plain = nchw(target) + torch.nn.functional.interpolate(nchw(big[1]), size=(4, 4))
    plain = plain + torch.nn.functional.interpolate(nchw(small[0]), size=(4, 4))
    assert np.abs(to_nhwc(plain) - np.asarray(want)).max() > 0.1


@pytest.mark.parametrize("ch", [(32, 64), (16, 32, 48, 64)], ids=["2taps", "4taps"])
def test_detect_over_2_and_4_taps_matches_jax(ch):
    """The legacy head over v3-tiny's two taps (strides 16, 32) and a P2 /
    P6 model's four, and the decode of its maps."""
    nc, strides = 5, (16, 32) if len(ch) == 2 else (4, 8, 16, 32)
    feats = [nhwc(10 + i, hw=16 >> i, c=c) for i, c in enumerate(ch)]
    got, want = run_block(JH.Detect(nc=nc, ch=ch), TH.Detect(nc=nc, ch=ch), feats, 10)
    assert len(got) == len(want) == len(ch)
    for (gb, gc), (wb, wc) in zip(got, want):
        assert_close(to_nhwc(gb), wb)
        assert_close(to_nhwc(gc), wc)
    cands = TH.decode_detections(got, strides, nc)
    assert cands.shape == (2, sum((16 >> i) ** 2 for i in range(len(ch))), 4 + nc)
    assert_close(cands.numpy(), JH.decode_detections(want, strides, nc))


def _v10_case(seed=11):
    ch, nc = (16, 32, 64), 5
    feats = [nhwc(seed + i, hw=8 >> i, c=c) for i, c in enumerate(ch)]
    jm = JH.v10Detect(nc=nc, ch=ch)
    jfeats = [jnp.asarray(f) for f in feats]
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jfeats), seed)
    tm = load_jax_variables(TH.v10Detect(nc=nc, ch=ch), flatten_variables(v))
    return jm, jfeats, v, tm, [nchw(f) for f in feats], nc


def _check_branch(got, want, reg_max=16):
    """Port (box, cls) pairs against JAX's concatenated per-scale maps."""
    assert len(got) == len(want)
    for (gb, gc), w in zip(got, want):
        w = np.asarray(w)
        assert_close(to_nhwc(gb), w[..., :4 * reg_max])
        assert_close(to_nhwc(gc), w[..., 4 * reg_max:])


def test_v10detect_eval_matches_jax():
    """Eval: one2one only, though both branches' parameters exist."""
    jm, jfeats, v, tm, feats, nc = _v10_case()
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree.leaves(v["params"]))
    want = jax.jit(jm.apply)(v, jfeats)
    with torch.no_grad():
        got = tm.eval()(feats)
    assert set(got) == set(want) == {"one2one"}
    _check_branch(got["one2one"], want["one2one"])
    assert TH.det_maps(got) is got["one2one"]


def test_v10detect_train_matches_jax():
    """Train: both branches, BatchNorm on the batch statistics, which both
    packages update alike."""
    jm, jfeats, v, tm, feats, nc = _v10_case(12)
    want, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        v, jfeats)
    with torch.no_grad():
        got = tm.train()(feats)
    assert set(got) == set(want) == {"one2one", "one2many"}
    for k in got:
        _check_branch(got[k], want[k])
    stats = flatten_variables({"batch_stats": upd["batch_stats"]})
    state = tm.state_dict()
    for path, arr in stats.items():
        mods, leaf = path.split("/")[1:-1], path.split("/")[-1]
        name = ".".join(mods) + (".running_mean" if leaf == "mean" else ".running_var")
        np.testing.assert_allclose(state[name].numpy(), arr, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_v10_postprocess_matches_jax():
    cands = np.random.default_rng(13).uniform(0, 64, (2, 50, 4 + 7)).astype(np.float32)
    cands[..., 4:] /= 64
    want = np.asarray(JH.v10_postprocess(jnp.asarray(cands), max_det=30))
    got = TH.v10_postprocess(torch.from_numpy(cands), max_det=30)
    assert got.shape == want.shape == (2, 30, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    assert TH.v10_postprocess(torch.from_numpy(cands[:, :2]), max_det=30).shape == (2, 14, 6)


@pytest.mark.parametrize("k", [1, 10])
def test_topk_positive_mask_matches_jax(k):
    """k = 1 runs the kth-value chain with no suppress pass: each row's
    largest positive entries (ties admitted), as the JAX mask at top-1."""
    x = np.random.default_rng(14 + k).uniform(-0.2, 1, (2, 4, 60)).astype(np.float32)
    x[0, 1] = 0.0
    x[1, 2, :5] = x[1, 2].max() + 0.1  # a tie at the max
    want = np.asarray(JT.topk_positive_mask(jnp.asarray(x), k))
    got = TT.topk_positive_mask(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)
    if k == 1:
        assert got[1, 2].sum() == 5 and got[0, 1].sum() == 0
