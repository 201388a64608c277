"""Port parity: the conv-fused ViL layer function against the JAX package.

``vil_layer_conv_plain`` (the CUDA kernels' plain version) is held against
the JAX composite ``_vil_conv_composite`` and against the conv-fused Pallas
kernel in interpret mode with fp32 operands, on a square and a non-square
token grid, S a multiple of the plain chunk and not, exp and sigmoid input
gates. Tolerance 1e-5 of the output's max: fp32 throughout, the same
equations, differences from summation order and chunking only. The
interpret-mode kernel pads S to 128 and draws unit-scale gates (near a
cancelling normalizer the JAX kernel and the JAX native form differ by more
than that themselves).

The hand backward (frozen stabilizer) is held two ways, as the cell's and
the block's are. With the gate kernels at zero no gate gradient reaches
q/k/v, so every gradient but the gate kernels' and biases' equals
``jax.grad`` of the composite: 1e-4 (rtol, atol 1e-4 of the tensor's max);
the gate kernels and biases at 2e-2 of each tensor's max (the dropped
normalizer-floor terms). With seeded gate kernels every gradient is held at
2e-5 against the same chain built from JAX pieces: ``jax.vjp`` of the tail,
the JAX ``mlstm_chunkwise_bwd_ref``, ``jax.vjp`` of the projections and gate
dots, ``jax.vjp`` of RMSNorm, proj_up and the conv.
``ViLLayer.forward_conv_fused`` on loaded JAX weights equals the JAX layer in
both directions. The kernels on the card are checked in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.kernels.mlstm_bwd import mlstm_chunkwise_bwd_ref as jax_bwd_ref
from xlstm_yolo_tpu.kernels.mlstm_pallas import (
    _vil_conv_composite, mlstm_vil_layer_conv_fused_pallas)
from xlstm_yolo_tpu.nn import vil as JV
from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd_plain
from xlstm_yolo_torch.kernels.vil_cell import Cfg
from xlstm_yolo_torch.kernels.vil_conv import (
    _conv_plain, conv_layer_bwd, vil_layer_conv_fwd, vil_layer_conv_plain)
from xlstm_yolo_torch.kernels.vil_layer import vil_layer_ref
from xlstm_yolo_torch.nn import vil as TV
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

TOL_REL = 1e-5
CELL = ["wq", "bq", "wk", "bk", "wv", "bv", "wgi", "bgi", "wgf", "bgf"]
TAIL = ["nsc", "nbi", "skip", "wd", "bd"]
NAMES = ["x", "nrm", "wu", "bu", "wc", "bc"] + CELL + TAIL
GATES = ("wgi", "bgi", "wgf", "bgf")


def conv_args(B=2, H=8, W=8, DIM=16, NH=2, DH=16, seed=3, gate_scale=0.05, unit_gates=False):
    """Seeded fp32 numpy arguments of the conv-fused layer function, JAX
    layouts except ``wc``, the port's (INNER, 1, 3, 3). ``unit_gates``: gate
    biases 0 and 2 instead of -8 and 4, so the gate preacts are O(1)."""
    rng = np.random.default_rng(seed)
    INNER = NH * DH
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    bgi, bgf = (0.0, 2.0) if unit_gates else (-8.0, 4.0)
    return dict(
        x=mk(B, H * W, DIM), nrm=1.0 + mk(DIM) * 0.2, wu=mk(DIM, 2 * INNER) * 0.3,
        bu=mk(2 * INNER) * 0.1, wc=mk(INNER, 1, 3, 3) * 0.3, bc=mk(INNER) * 0.1,
        wq=mk(NH, DH, DH) * 0.3, bq=mk(INNER) * 0.1, wk=mk(NH, DH, DH) * 0.3,
        bk=mk(INNER) * 0.1, wv=mk(NH, DH, DH) * 0.3, bv=mk(INNER) * 0.1,
        wgi=mk(3 * INNER, NH) * gate_scale, bgi=np.full((NH,), bgi, np.float32),
        wgf=mk(3 * INNER, NH) * gate_scale, bgf=np.full((NH,), bgf, np.float32),
        nsc=1.0 + mk(INNER) * 0.2, nbi=mk(INNER) * 0.1, skip=1.0 + mk(INNER) * 0.1,
        wd=mk(INNER, DIM) * 0.2, bd=mk(DIM) * 0.1)


def _t(a, names=NAMES):
    return [torch.from_numpy(a[n]) for n in names]


def _j(a, names=NAMES):
    """jnp arguments; the conv kernel as flax's HWIO (3, 3, 1, INNER)."""
    return [jnp.asarray(a[n].transpose(2, 3, 1, 0) if n == "wc" else a[n]) for n in names]


def _composite(j, nh, H, W, chunk, igate_act):
    """``_vil_conv_composite`` on arguments in the entry's order."""
    d = dict(zip(NAMES, j))
    return _vil_conv_composite(
        d["x"], d["nrm"], d["wu"], d["bu"], d["wc"], d["bc"], d["wq"], d["wk"], d["wv"],
        d["bq"], d["bk"], d["bv"], d["wgi"], d["bgi"], d["wgf"], d["bgf"], d["nsc"], d["nbi"],
        d["skip"], d["wd"], d["bd"], nh, H, W, chunk, igate_act, 1e-6, 1e-3, 1e-6)


def assert_close_rel(got, want, tol=TOL_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("H,W,igate_act", [(8, 8, "exp"), (6, 10, "exp"), (6, 10, "sigmoid"),
                                           (14, 14, "exp"), (1, 20, "exp")])
def test_vil_conv_plain_matches_jax_composite(H, W, igate_act):
    """Square and non-square grids, S = 60 and 196 ragged against the plain
    chunk of 16, a one-row grid (no vertical neighbours at all)."""
    a = conv_args(H=H, W=W, seed=H + W)
    want = _composite(_j(a), 2, H, W, 16, igate_act)
    got = vil_layer_conv_plain(*_t(a), 2, (H, W), chunk_size=16, igate_act=igate_act)
    assert_close_rel(got.numpy(), want)


@pytest.mark.parametrize("B,H,W,igate_act", [(2, 8, 8, "exp"), (1, 16, 24, "sigmoid"),
                                             (1, 6, 10, "exp")])
def test_vil_conv_plain_matches_jax_kernel_interpret(B, H, W, igate_act):
    a = conv_args(B=B, H=H, W=W, seed=5 + H, gate_scale=0.1, unit_gates=True)
    want = mlstm_vil_layer_conv_fused_pallas(*_j(a), 2, (H, W), chunk_size=128,
                                             igate_act=igate_act, interpret=True,
                                             mxu_dtype="float32")
    got = vil_layer_conv_plain(*_t(a), 2, (H, W), chunk_size=8, igate_act=igate_act)
    assert_close_rel(got.numpy(), want)


def test_vil_conv_plain_is_the_library_conv_feeding_the_layer_function():
    """The conv zero-pads its input x_mlstm, not x: the plain version equals
    torch's own padded depthwise conv feeding ``vil_layer_ref``."""
    a = conv_args(H=5, W=7, seed=9)
    x, nrm, wu, bu, wc, bc, *rest = _t(a)
    xf = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * nrm
    xm = xf @ wu[:, :32] + bu[:32]
    img = torch.nn.functional.pad(xm.transpose(1, 2).reshape(2, 32, 5, 7), (1, 1, 1, 1))
    conv = torch.nn.functional.conv2d(img, wc, bc, groups=32).reshape(2, 32, 35).transpose(1, 2)
    want = vil_layer_ref(x, torch.nn.functional.silu(conv), nrm, wu, bu, *rest, 2, chunk_size=8)
    got = vil_layer_conv_plain(*_t(a), 2, (5, 7), chunk_size=8)
    assert_close_rel(got.numpy(), want.numpy())


def test_vil_conv_fwd_on_cpu_is_the_plain_version():
    a = conv_args(H=4, W=5)
    before = vil_layer_conv_fwd.launches
    got = vil_layer_conv_fwd(*_t(a), 2, (4, 5), chunk_size=8)
    assert vil_layer_conv_fwd.launches == before  # no kernel launched for CPU tensors
    np.testing.assert_array_equal(
        got.numpy(), vil_layer_conv_plain(*_t(a), 2, (4, 5), chunk_size=8).numpy())


def test_vil_conv_fwd_refuses():
    """Another device is refused with and without gradients (no plain
    fallback, the autograd Function is not entered); a grid that does not
    cover S and a kernel that is no depthwise 3x3 raise."""
    a = conv_args(H=2, W=4)
    args = [t.to("meta") for t in _t(a)]
    with pytest.raises(ValueError):
        vil_layer_conv_fwd(*args, 2, (2, 4))
    args[2].requires_grad_()
    with pytest.raises(ValueError):
        vil_layer_conv_fwd(*args, 2, (2, 4))
    with pytest.raises(ValueError, match="grid"):
        vil_layer_conv_fwd(*_t(a), 2, (3, 3))
    bad = _t(a)
    bad[4] = bad[4][:, :, :1]
    with pytest.raises(ValueError, match="depthwise"):
        vil_layer_conv_fwd(*bad, 2, (2, 4))


def _autograd(a, nh, seqlens, **kw):
    """Gradients of sum(out**2) through the port's entry on the CPU (its
    autograd Function, the hand backward)."""
    leaves = [t.clone().requires_grad_() for t in _t(a)]
    (vil_layer_conv_fwd(*leaves, nh, seqlens, **kw) ** 2).sum().backward()
    return {n: t.grad.numpy() for n, t in zip(NAMES, leaves)}


def _wc_grad(n, w):
    """A JAX gradient in the port's layout (the conv kernel back to OIHW)."""
    w = np.asarray(w)
    return w.transpose(3, 2, 0, 1) if n == "wc" else w


@pytest.mark.parametrize("H,W", [(4, 8), (3, 9)])
def test_hand_backward_matches_jax_autodiff_with_zero_gate_kernels(H, W):
    a = conv_args(H=H, W=W, seed=7 + W, gate_scale=0.0)
    want = jax.grad(lambda *t: jnp.sum(_composite(t, 2, H, W, 8, "exp") ** 2),
                    argnums=tuple(range(len(NAMES))))(*_j(a))
    got = _autograd(a, 2, (H, W), chunk_size=8)
    for n, w in zip(NAMES, want):
        w = _wc_grad(n, w)
        if n in GATES:
            assert np.abs(got[n] - w).max() <= 2e-2 * np.abs(w).max(), n
        else:
            np.testing.assert_allclose(got[n], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=n)


def _jax_head(x, nrm, wu, bu, wc, bc, hgrid, wgrid):
    """RMSNorm, proj_up, the depthwise conv and its SiLU in jnp -> conv_act,
    x_mlstm, z."""
    B, S, _ = x.shape
    inner = wu.shape[-1] // 2
    xn = x * jax.lax.rsqrt(jnp.mean(x * x, axis=-1, keepdims=True) + 1e-6) * nrm
    y = xn @ wu + bu
    xm, z = y[..., :inner], y[..., inner:]
    cv = jax.lax.conv_general_dilated(
        xm.reshape(B, hgrid, wgrid, inner), wc, (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=inner) + bc
    return jax.nn.silu(cv).reshape(B, S, inner), xm, z


def _jax_pre(conv, xm, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf, nh=2):
    """Projections and gate dots in jnp -> q, k, v (B, NH, S, DH), i, f (B, NH, S)."""
    B, S, INNER = conv.shape
    dh = INNER // nh
    hw = lambda t, w, b: (jnp.einsum("bsnd,nod->bnso", t.reshape(B, S, nh, dh), w)
                          + b.reshape(1, nh, 1, dh))
    q, k, v = hw(conv, wq, bq), hw(conv, wk, bk), hw(xm, wv, bv)
    cat = jnp.concatenate([t.transpose(0, 2, 1, 3).reshape(B, S, INNER) for t in (q, k, v)], -1)
    return q, k, v, (cat @ wgi + bgi).transpose(0, 2, 1), (cat @ wgf + bgf).transpose(0, 2, 1)


def _jax_tail(h, conv, z, xres, nsc, nbi, skip, wd, bd, nh=2):
    """The layer's tail in jnp on h (B, NH, S, DH)."""
    B, _, S, dh = h.shape
    hn = (h - h.mean(-1, keepdims=True)) * jax.lax.rsqrt(h.var(-1, keepdims=True) + 1e-3)
    hn = hn.transpose(0, 2, 1, 3).reshape(B, S, nh * dh) * nsc + nbi
    return ((hn + skip * conv) * jax.nn.silu(z)) @ wd + bd + xres


def _frozen_chain(a, h_nat, H, W):
    """Gradients of sum(out**2) by the JAX pieces, frozen stabilizer; h_nat
    is the cell output (B, S, INNER) of the forward."""
    head = _j(a, NAMES[:6])
    (conv, xm, z), vjp_head = jax.vjp(lambda *t: _jax_head(*t, H, W), *head)
    (q, k, v, i, f), vjp_pre = jax.vjp(_jax_pre, conv, xm, *_j(a, CELL))
    B, NH, S, DH = q.shape
    h = jnp.asarray(h_nat).reshape(B, S, NH, DH).transpose(0, 2, 1, 3)
    out, vjp_tail = jax.vjp(_jax_tail, h, conv, z, head[0], *_j(a, TAIL))
    dh, dconv, dz, dres, *dtail = vjp_tail(2 * out)
    dconv_c, dxm, *dcell = vjp_pre(tuple(jax_bwd_ref(q, k, v, i, f, dh, chunk_size=8)))
    dx, *dhead = vjp_head((dconv + dconv_c, dxm, dz))
    grads = dict(zip(NAMES, (dx + dres, *dhead, *dcell, *dtail)))
    return {n: _wc_grad(n, g) for n, g in grads.items()}


@pytest.mark.parametrize("H,W", [(4, 8), (5, 8)])
def test_hand_backward_matches_jax_frozen_chain_with_gate_kernels(H, W):
    """S a multiple of the chunk of 8, as the JAX backward reference needs."""
    a = conv_args(H=H, W=W, seed=11)
    cfg = Cfg(2, 8, seqlens=(H, W))
    out, acts = _conv_plain(_t(a), cfg)
    ref = conv_layer_bwd(_t(a), acts, 2 * out, cfg, mlstm_chunkwise_bwd_plain)
    want = _frozen_chain(a, acts[0].numpy(), H, W)
    got = _autograd(a, 2, (H, W), chunk_size=8)
    assert len(ref) == len(NAMES)
    for n, r in zip(NAMES, ref):
        np.testing.assert_allclose(r.numpy(), want[n], rtol=2e-5, atol=2e-5, err_msg=n)
        np.testing.assert_allclose(got[n], r.numpy(), rtol=1e-6, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_forward_conv_fused_matches_jax_layer_and_forward(direction):
    """On loaded JAX weights, a 6 x 8 grid: the conv-fused entry equals the
    JAX layer (1e-4, as the layer's own parity test) and the port's
    ``forward``; with a backward direction the conv sees the flipped
    sequence laid on the grid."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 48, 32)).astype(np.float32)
    kw = dict(dim=32, direction=direction, qkv_block_size=16, seqlens=(6, 8), chunk_size=16)
    jm = JV.ViLLayer(**kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(rng.normal(size=p.shape), p.dtype), v)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load_jax_variables(TV.ViLLayer(**kw), flatten_variables(v)).eval()
    with torch.no_grad():
        got = tm.forward_conv_fused(torch.from_numpy(x))
        by_forward = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert_close_rel(got.numpy(), by_forward.numpy(), 1e-6)
    with pytest.raises(ValueError):
        TV.ViLLayer(dim=32, qkv_block_size=16).forward_conv_fused(torch.from_numpy(x))


def test_forward_conv_fused_gradients_equal_forward():
    """Under autograd on the CPU the conv-fused entry (hand backward through
    conv and SiLU) gives the gradients of ``forward`` (autograd through the
    conv branch plus the layer function's hand backward)."""
    rng = np.random.default_rng(8)
    tm = TV.ViLLayer(32, direction="backward", qkv_block_size=16, seqlens=(5, 7), chunk_size=16)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32) * 0.2))
        tm.mlstm_cell.fgate.bias.add_(3.0)
    x = torch.from_numpy(rng.normal(size=(2, 35, 32)).astype(np.float32))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    tm(xa).square().sum().backward()
    want = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad()
    tm.forward_conv_fused(xb).square().sum().backward()
    assert_close_rel(xb.grad.numpy(), xa.grad.numpy(), 2e-5)
    for n, p in tm.named_parameters():
        assert_close_rel(p.grad.numpy(), want[n].numpy(), 2e-5)
