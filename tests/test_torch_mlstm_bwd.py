"""Port parity: the chunkwise mLSTM backward and the ViL layer backward.

* ``mlstm_chunkwise_bwd_ref`` and ``chunk_carry_states`` against the JAX
  ones, fp32 on the CPU, exp and sigmoid input gates. Tolerance 1e-5 (rtol
  and atol): the same equations, differing in summation order only. q and k
  are aligned so that the normalizer stays away from zero (well-conditioned
  gradients).
* ``vil_layer_bwd_ref`` (the plain hand backward, frozen stabilizer) against
  ``jax.grad`` of the JAX layer-fused Pallas entry in interpret mode with
  fp32 operands, whose ``custom_vjp`` runs the same frozen-stabilizer
  backward around the Pallas chunkwise kernel. Tolerance 2e-4 (rtol and
  atol), as the JAX package pins that entry to autodiff of its composite:
  the chunk lengths differ (128 there, 64 here) and the gradients pass
  through the whole layer.
The CUDA kernel is held against the plain version in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.kernels import mlstm_pallas_bwd as JP
from xlstm_yolo_tpu.kernels.mlstm_bwd import mlstm_chunkwise_bwd_ref as jax_bwd_ref
from xlstm_yolo_tpu.kernels.mlstm_pallas import mlstm_vil_layer_fused_pallas
from xlstm_yolo_torch.kernels import mlstm_bwd as T
from xlstm_yolo_torch.kernels.vil_cell import Cfg
from xlstm_yolo_torch.kernels.vil_layer import _layer_plain, vil_layer_bwd_ref, vil_layer_fwd

TOL = dict(rtol=1e-5, atol=1e-5)
LAYER_TOL = dict(rtol=2e-4, atol=2e-4)
NAMES = ["x", "conv", "nrm", "wu", "bu", "wq", "bq", "wk", "bk", "wv", "bv",
         "wgi", "bgi", "wgf", "bgf", "nsc", "nbi", "skip", "wd", "bd"]


def _cell_inputs(seed, B=2, NH=2, S=32, DH=8):
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, NH, S, DH)).astype(np.float32)
    k = (q + 0.1 * r.normal(size=q.shape)).astype(np.float32)
    v, dh = (r.normal(size=(B, NH, S, DH)).astype(np.float32) for _ in range(2))
    i = r.normal(size=(B, NH, S)).astype(np.float32)
    f = (r.normal(size=(B, NH, S)) + 2).astype(np.float32)
    return q, k, v, i, f, dh


@pytest.mark.parametrize("igate_act,DH", [("exp", 8), ("sigmoid", 8), ("exp", 128)],
                         ids=["exp", "sigmoid", "exp-dh128"])
def test_mlstm_chunkwise_bwd_ref_matches_jax(igate_act, DH):
    """The reference, and the kernel's plain version on the natural
    (B, S, NH*DH) layout, at a small head dim and at the language model's
    head dim 128 (the CUDA kernel takes 64, 128 and 256)."""
    a = _cell_inputs(0, DH=DH)
    want = jax_bwd_ref(*map(jnp.asarray, a), chunk_size=8, igate_act=igate_act)
    got = T.mlstm_chunkwise_bwd_ref(*map(torch.from_numpy, a), chunk_size=8,
                                    igate_act=igate_act)
    for name, g, w in zip("qkvif", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **TOL)
    B, NH, S, _ = a[0].shape
    nat = lambda t: torch.from_numpy(t).transpose(1, 2).reshape(B, S, NH * DH)
    q, k, v, i, f, dh = a
    got = T.mlstm_chunkwise_bwd_plain(nat(q), nat(k), nat(v), torch.from_numpy(i),
                                      torch.from_numpy(f), nat(dh), NH, chunk_size=8,
                                      igate_act=igate_act)
    for name, g, w in zip("qkv", got[:3], want[:3]):
        w = np.asarray(w).transpose(0, 2, 1, 3).reshape(B, S, NH * DH)
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **TOL)
    for name, g, w in zip("if", got[3:], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **TOL)


def test_chunk_carry_states_match_jax():
    """The port keeps the layer kernel's layout: C as [k index][v index]
    (JAX: transposed), n (B*NH, NS, DH) (JAX: (B*NH, DH, NS)), and m_prev
    with btot/m_loc instead of the log decays, which ``_carry_scan``
    returns."""
    q, k, v, i, f, _ = _cell_inputs(1)
    ct, n_prev, scal = JP.chunk_carry_states(*map(jnp.asarray, (q, k, v, i, f)), 8)
    got = T.chunk_carry_states(*map(torch.from_numpy, (k, v, i, f)), 8)
    np.testing.assert_allclose(got.c.numpy(), np.asarray(ct).swapaxes(-1, -2), **TOL)
    np.testing.assert_allclose(got.n.numpy(), np.asarray(n_prev).swapaxes(1, 2), **TOL)
    np.testing.assert_allclose(got.m.numpy(), np.asarray(scal[:, 0]), **TOL)
    _, btot, m_loc = JP._gate_chunk_weights(jnp.asarray(i), jnp.asarray(f), 8, "exp")
    np.testing.assert_allclose(got.btot.numpy(), np.asarray(btot).reshape(4, -1), **TOL)
    np.testing.assert_allclose(got.mloc.numpy(), np.asarray(m_loc).reshape(4, -1), **TOL)


def test_mlstm_chunkwise_bwd_on_cpu_is_the_plain_version_ragged():
    """The natural-layout entry on CPU tensors launches nothing and equals
    the JAX reference on the sequence zero-padded to a chunk multiple."""
    q, k, v, i, f, dh = _cell_inputs(2, S=27)
    nat = lambda t: torch.from_numpy(t).transpose(1, 2).reshape(2, 27, 16)
    before = T.mlstm_chunkwise_bwd.launches
    got = T.mlstm_chunkwise_bwd(nat(q), nat(k), nat(v), torch.from_numpy(i),
                                torch.from_numpy(f), nat(dh), 2, chunk_size=8)
    assert T.mlstm_chunkwise_bwd.launches == before
    pad = lambda t: jnp.pad(jnp.asarray(t), [(0, 0), (0, 0), (0, 5)] + [(0, 0)] * (t.ndim - 3))
    want = jax_bwd_ref(*(pad(t) for t in (q, k, v, i, f, dh)), chunk_size=8)
    for name, g, w in zip("qkv", got[:3], want[:3]):
        w = np.asarray(w)[:, :, :27].transpose(0, 2, 1, 3).reshape(2, 27, 16)
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **TOL)
    for name, g, w in zip("if", got[3:], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[..., :27], err_msg=f"d{name}", **TOL)


def _layer_args(S, seed, B=2, NH=2, DH=8, DIM=8):
    rng = np.random.default_rng(seed)
    INNER = NH * DH
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(
        x=mk(B, S, DIM), conv=mk(B, S, INNER), nrm=1.0 + mk(DIM) * 0.2,
        wu=mk(DIM, 2 * INNER) * 0.3, bu=mk(2 * INNER) * 0.1,
        wq=mk(NH, DH, DH) * 0.3, bq=mk(INNER) * 0.1, wk=mk(NH, DH, DH) * 0.3,
        bk=mk(INNER) * 0.1, wv=mk(NH, DH, DH) * 0.3, bv=mk(INNER) * 0.1,
        wgi=mk(3 * INNER, NH) * 0.05, bgi=np.full((NH,), -8.0, np.float32),
        wgf=mk(3 * INNER, NH) * 0.05, bgf=np.full((NH,), 4.0, np.float32),
        nsc=1.0 + mk(INNER) * 0.2, nbi=mk(INNER) * 0.1, skip=1.0 + mk(INNER) * 0.1,
        wd=mk(INNER, DIM) * 0.2, bd=mk(DIM) * 0.1)


@pytest.mark.parametrize("S", [64, 77])
def test_vil_layer_bwd_ref_matches_jax_custom_vjp(S):
    """Loss sum(out**2): the JAX side is jax.grad through the fused entry's
    custom_vjp (interpret mode, fp32 operands); the port's side calls
    ``vil_layer_bwd_ref`` on the plain forward's activations, and autograd
    through ``vil_layer_fwd`` (the CPU path of the autograd Function) must
    give the same gradients."""
    a = _layer_args(S, seed=S)

    def loss(*t):
        out = mlstm_vil_layer_fused_pallas(*t, 2, chunk_size=64, interpret=True,
                                           mxu_dtype="float32")
        return jnp.sum(out ** 2)

    want = jax.grad(loss, argnums=tuple(range(20)))(*(jnp.asarray(a[n]) for n in NAMES))
    args = [torch.from_numpy(a[n]) for n in NAMES]
    out, acts = _layer_plain(args, Cfg(2, 64))
    got = vil_layer_bwd_ref(args, acts, 2 * out, 2, chunk_size=64)
    for n, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=n, **LAYER_TOL)

    leaves = [t.clone().requires_grad_() for t in args]
    (vil_layer_fwd(*leaves, 2, chunk_size=64) ** 2).sum().backward()
    for n, leaf, g in zip(NAMES, leaves, got):
        np.testing.assert_allclose(leaf.grad.numpy(), g.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=n)
