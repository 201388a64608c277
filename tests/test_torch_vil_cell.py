"""Port parity: the ViL cell and block functions against the JAX package.

``vil_cell_plain`` and ``vil_block_plain`` (the CUDA kernels' plain versions)
are held against the JAX composites and against the cell-fused and
block-fused Pallas kernels in interpret mode with fp32 operands, with S both
a chunk multiple and not, exp and sigmoid input gates. Tolerance 1e-5 (rtol
and atol, outputs O(1)): fp32 throughout, the same equations, differences
from summation order and chunking only. The interpret-mode kernels pad S to
128, so those cases keep B and NH small and draw unit-scale gates (near a
cancelling normalizer the JAX kernel and the JAX native form differ by more
than that themselves).

The hand backward (frozen stabilizer) is held two ways. With the gate
kernels at zero no gate gradient reaches q/k/v, so every gradient but the
gate kernels' and biases' equals JAX autodiff of the entry (which on the CPU
differentiates the native form): 1e-4 (rtol, atol 1e-4 of the tensor's
max); the gate kernels and biases at 2e-2 of each tensor's max (the dropped
normalizer-floor terms). With seeded gate kernels, every gradient is held
at 2e-5 against the same chain built from JAX pieces: ``jax.vjp`` of the
tail, the JAX ``mlstm_chunkwise_bwd_ref`` (frozen stabilizer), ``jax.vjp`` of
the projections and gate dots.
The kernels on the card are checked in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.kernels.mlstm_bwd import mlstm_chunkwise_bwd_ref as jax_bwd_ref
from xlstm_yolo_tpu.kernels.mlstm_pallas import (
    _vil_block_composite, _vil_fused_composite, mlstm_vil_block_fused_pallas,
    mlstm_vil_fused_pallas)
from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd_plain
from xlstm_yolo_torch.kernels.vil_block import (
    _block_plain, block_bwd, vil_block_fwd, vil_block_plain)
from xlstm_yolo_torch.kernels.vil_cell import (
    Cfg, _cell_plain, cell_bwd, vil_cell_fwd, vil_cell_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
CELL = ["conv", "xm", "wq", "bq", "wk", "bk", "wv", "bv", "wgi", "bgi", "wgf", "bgf"]
BLOCK = ["conv", "xm", "z", "xres"] + CELL[2:] + ["nsc", "nbi", "skip", "wd", "bd"]
GATES = ("wgi", "bgi", "wgf", "bgf")


def block_args(B=2, NH=2, S=48, DH=8, DIM=8, seed=3, gate_scale=0.05, unit_gates=False):
    """Seeded fp32 numpy arguments of the block function (the cell's are a
    subset), JAX layouts. ``unit_gates``: gate biases 0 and 2 instead of -8
    and 4, so the gate preacts are O(1)."""
    rng = np.random.default_rng(seed)
    INNER = NH * DH
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    bgi, bgf = (0.0, 2.0) if unit_gates else (-8.0, 4.0)
    return dict(
        conv=mk(B, S, INNER), xm=mk(B, S, INNER), z=mk(B, S, INNER), xres=mk(B, S, DIM),
        wq=mk(NH, DH, DH) * 0.3, bq=mk(INNER) * 0.1, wk=mk(NH, DH, DH) * 0.3,
        bk=mk(INNER) * 0.1, wv=mk(NH, DH, DH) * 0.3, bv=mk(INNER) * 0.1,
        wgi=mk(3 * INNER, NH) * gate_scale, bgi=np.full((NH,), bgi, np.float32),
        wgf=mk(3 * INNER, NH) * gate_scale, bgf=np.full((NH,), bgf, np.float32),
        nsc=1.0 + mk(INNER) * 0.2, nbi=mk(INNER) * 0.1, skip=1.0 + mk(INNER) * 0.1,
        wd=mk(INNER, DIM) * 0.2, bd=mk(DIM) * 0.1)


def _t(a, names):
    return [torch.from_numpy(a[n]) for n in names]


def _j(a, names):
    return [jnp.asarray(a[n]) for n in names]


def _natural(h_t, B, NH):  # JAX (B*NH, DH, S) or (B, NH, DH, S) -> (B, S, INNER)
    h = np.asarray(h_t)
    h = h.reshape(B, NH, *h.shape[-2:])
    return h.transpose(0, 3, 1, 2).reshape(B, h.shape[-1], -1)


@pytest.mark.parametrize("S,igate_act", [(48, "exp"), (40, "exp"), (40, "sigmoid")])
def test_vil_cell_plain_matches_jax_composite(S, igate_act):
    a = block_args(S=S)
    j = dict(zip(CELL, _j(a, CELL)))
    want = _vil_fused_composite(j["conv"], j["xm"], j["wq"], j["wk"], j["wv"], j["bq"], j["bk"],
                                j["bv"], j["wgi"], j["bgi"], j["wgf"], j["bgf"], 2, 8, igate_act,
                                1e-6)
    got = vil_cell_plain(*_t(a, CELL), 2, chunk_size=16, igate_act=igate_act)
    np.testing.assert_allclose(got.numpy(), _natural(want, 2, 2), **TOL)


@pytest.mark.parametrize("S,igate_act", [(48, "exp"), (40, "exp"), (40, "sigmoid")])
def test_vil_block_plain_matches_jax_composite(S, igate_act):
    a = block_args(S=S, seed=4)
    j = dict(zip(BLOCK, _j(a, BLOCK)))
    want = _vil_block_composite(
        j["conv"], j["xm"], j["z"], j["xres"], j["wq"], j["wk"], j["wv"], j["bq"], j["bk"],
        j["bv"], j["wgi"], j["bgi"], j["wgf"], j["bgf"], j["nsc"], j["nbi"], j["skip"], j["wd"],
        j["bd"], 2, 8, igate_act, 1e-6, 1e-3)
    got = vil_block_plain(*_t(a, BLOCK), 2, chunk_size=16, igate_act=igate_act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,igate_act", [(16, "exp"), (24, "sigmoid")])
def test_vil_cell_plain_matches_jax_kernel_interpret(S, igate_act):
    a = block_args(B=1, S=S, seed=5, gate_scale=0.1, unit_gates=True)
    want = mlstm_vil_fused_pallas(*_j(a, CELL), 2, chunk_size=128, igate_act=igate_act,
                                  interpret=True, mxu_dtype="float32")
    got = vil_cell_plain(*_t(a, CELL), 2, chunk_size=8, igate_act=igate_act)
    np.testing.assert_allclose(got.numpy(), _natural(want, 1, 2), **TOL)


@pytest.mark.parametrize("S,igate_act", [(16, "exp"), (24, "sigmoid")])
def test_vil_block_plain_matches_jax_kernel_interpret(S, igate_act):
    a = block_args(B=1, S=S, seed=6, gate_scale=0.1, unit_gates=True)
    want = mlstm_vil_block_fused_pallas(*_j(a, BLOCK), 2, chunk_size=128, igate_act=igate_act,
                                        interpret=True, mxu_dtype="float32")
    got = vil_block_plain(*_t(a, BLOCK), 2, chunk_size=8, igate_act=igate_act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fwd,plain,names", [(vil_cell_fwd, vil_cell_plain, CELL),
                                             (vil_block_fwd, vil_block_plain, BLOCK)],
                         ids=["cell", "block"])
def test_fwd_on_cpu_is_the_plain_version(fwd, plain, names):
    a = block_args(S=20)
    before = fwd.launches
    got = fwd(*_t(a, names), 2, chunk_size=8)
    assert fwd.launches == before  # no kernel launched for CPU tensors
    np.testing.assert_array_equal(got.numpy(), plain(*_t(a, names), 2, chunk_size=8).numpy())


@pytest.mark.parametrize("fwd,names", [(vil_cell_fwd, CELL), (vil_block_fwd, BLOCK)],
                         ids=["cell", "block"])
def test_fwd_rejects_other_devices_with_and_without_grad(fwd, names):
    """Off the CPU and CUDA a call refuses: there is no plain fallback for
    another device, and the autograd Function is not entered."""
    a = block_args(S=8)
    args = [t.to("meta") for t in _t(a, names)]
    with pytest.raises(ValueError):
        fwd(*args, 2)
    args[2].requires_grad_()
    with pytest.raises(ValueError):
        fwd(*args, 2)


def _autograd(fwd, a, names, nh, **kw):
    """Gradients of sum(out**2) through the port's entry on the CPU (its
    autograd Function, the hand backward)."""
    leaves = [t.clone().requires_grad_() for t in _t(a, names)]
    (fwd(*leaves, nh, **kw) ** 2).sum().backward()
    return {n: t.grad.numpy() for n, t in zip(names, leaves)}


@pytest.mark.parametrize("S", [32, 27])
@pytest.mark.parametrize("fwd,entry,names", [
    (vil_cell_fwd, mlstm_vil_fused_pallas, CELL),
    (vil_block_fwd, mlstm_vil_block_fused_pallas, BLOCK)], ids=["cell", "block"])
def test_hand_backward_matches_jax_autodiff_with_zero_gate_kernels(fwd, entry, names, S):
    a = block_args(S=S, seed=7 + S, gate_scale=0.0)
    want = jax.grad(lambda *t: jnp.sum(entry(*t, 2, chunk_size=8) ** 2),
                    argnums=tuple(range(len(names))))(*_j(a, names))
    got = _autograd(fwd, a, names, 2, chunk_size=8)
    for n, w in zip(names, want):
        w = np.asarray(w)
        if n in GATES:
            assert np.abs(got[n] - w).max() <= 2e-2 * np.abs(w).max(), n
        else:
            np.testing.assert_allclose(got[n], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                       err_msg=n)


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


def _frozen_chain(a, h_nat, with_tail):
    """Gradients of sum(out**2) by the JAX pieces, frozen stabilizer; h_nat
    is the cell output (B, S, INNER) of the forward."""
    cell = _j(a, CELL)
    (q, k, v, i, f), vjp_pre = jax.vjp(_jax_pre, *cell)
    B, NH, S, DH = q.shape
    h = jnp.asarray(h_nat).reshape(B, S, NH, DH).transpose(0, 2, 1, 3)
    grads = {}
    if with_tail:
        tail_names = ["conv", "z", "xres", "nsc", "nbi", "skip", "wd", "bd"]
        out, vjp_tail = jax.vjp(_jax_tail, h, *_j(a, tail_names))
        dh, *dtail = vjp_tail(2 * out)
        grads = dict(zip(tail_names, dtail))
    else:
        dh = 2 * h
    g = vjp_pre(tuple(jax_bwd_ref(q, k, v, i, f, dh, chunk_size=8)))
    for n, x in zip(CELL, g):
        grads[n] = grads[n] + x if n in grads else x
    return {n: np.asarray(x) for n, x in grads.items()}


@pytest.mark.parametrize("which", ["cell", "block"])
def test_hand_backward_matches_jax_frozen_chain_with_gate_kernels(which):
    a = block_args(S=32, seed=11)
    cfg = Cfg(2, 8)
    if which == "cell":
        names, fwd = CELL, vil_cell_fwd
        h, acts = _cell_plain(*_t(a, CELL), cfg)
        ref = cell_bwd(_t(a, CELL), acts, 2 * h, cfg, mlstm_chunkwise_bwd_plain)
    else:
        names, fwd = BLOCK, vil_block_fwd
        out, acts = _block_plain(_t(a, BLOCK), cfg)
        h = acts[0]
        ref = block_bwd(_t(a, BLOCK), acts, 2 * out, cfg, mlstm_chunkwise_bwd_plain)
    want = _frozen_chain(a, h.numpy(), with_tail=which == "block")
    got = _autograd(fwd, a, names, 2, chunk_size=8)
    for n, r in zip(names, ref):
        np.testing.assert_allclose(r.numpy(), want[n], rtol=2e-5, atol=2e-5, err_msg=n)
        np.testing.assert_allclose(got[n], r.numpy(), rtol=1e-6, atol=1e-6, err_msg=n)
