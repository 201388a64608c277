"""Port parity: the torch mLSTM forward against the JAX one.

Same seeded numpy inputs through ``xlstm_yolo_tpu.kernels.mlstm_native``
and ``xlstm_yolo_torch.kernels.mlstm_native``, fp32 on the CPU. Tolerance
1e-5: the same algorithm in fp32, differing only in summation order.
``mlstm_chunkwise_fwd`` (on the CPU the plain version of the CUDA kernel in
``csrc/mlstm_fwd.cu``) is held to the JAX Pallas kernel in interpret mode
with fp32 operands, to the JAX native forms and to the step-by-step form, at
whole and ragged S, within 1e-5 of each output's max. The CUDA kernel itself
is checked on the card in ``test_torch_cuda.py``.

The pair the card runs under autograd, forward kernel with the chunkwise
backward kernel as its backward, is held here through its plain versions
(``mlstm_chunkwise_fwd_plain`` with ``mlstm_chunkwise_bwd_heads`` on CPU
tensors): the five gradients against the JAX ``mlstm_chunkwise_bwd_ref``
(frozen stabilizer, 1e-5), and dq/dk/dv, which do not depend on the
stabilizer, against JAX autodiff of the chunkwise forward.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.kernels import mlstm_native as J
from xlstm_yolo_tpu.kernels.mlstm_bwd import mlstm_chunkwise_bwd_ref as jax_bwd_ref
from xlstm_yolo_tpu.kernels.mlstm_pallas import _mlstm_pallas_fwd_impl, mlstm_chunkwise_pallas
from xlstm_yolo_torch.kernels import mlstm_native as T
from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
from xlstm_yolo_torch.kernels.mlstm_fwd import (
    mlstm_chunkwise_bwd_heads, mlstm_chunkwise_fwd, mlstm_chunkwise_fwd_plain)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B=2, NH=3, S=64, DH=8, gate_scale=2.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, NH, S, DH)).astype(np.float32) for _ in range(3))
    i = (rng.normal(size=(B, NH, S)) * gate_scale).astype(np.float32)
    f = (rng.normal(size=(B, NH, S)) * gate_scale + 2.0).astype(np.float32)
    return q, k, v, i, f


@pytest.mark.parametrize("igate_act", ["exp", "sigmoid"])
@pytest.mark.parametrize("chunk_size", [16, 64])
def test_mlstm_chunkwise_matches_jax(igate_act, chunk_size):
    args = _inputs(0)
    want = J.mlstm_chunkwise(*map(jnp.asarray, args), chunk_size=chunk_size,
                             igate_act=igate_act)
    got = T.mlstm_chunkwise(*map(torch.from_numpy, args), chunk_size=chunk_size,
                            igate_act=igate_act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlstm_chunkwise_last_state_matches_jax():
    args = _inputs(1, S=32)
    hj, (cj, nj, mj) = J.mlstm_chunkwise(*map(jnp.asarray, args), chunk_size=8,
                                         return_last_state=True)
    ht, (ct, nt, mt) = T.mlstm_chunkwise(*map(torch.from_numpy, args), chunk_size=8,
                                         return_last_state=True)
    for a, b in ((ht, hj), (ct, cj), (nt, nj), (mt, mj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_log_igate_rejects_unknown_activation():
    with pytest.raises(ValueError):
        T._log_igate(torch.zeros(3), "relu")


TOL_REL = 1e-5


def assert_close_rel(got, want, tol=TOL_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("igate_act", ["exp", "sigmoid"])
def test_mlstm_chunkwise_fwd_matches_jax_kernel_interpret(igate_act):
    """Gates drawn as the JAX package's own kernel test draws them (unit
    scale): with wider gates the JAX kernel and the JAX native form differ
    from each other by 1e-5 of the output's max at this size."""
    args = _inputs(2, B=2, NH=4, S=256, DH=16, gate_scale=1.0)
    want = _mlstm_pallas_fwd_impl(*map(jnp.asarray, args), 64, igate_act, 1e-6,
                                  interpret=True, mxu_dtype="float32")
    got = mlstm_chunkwise_fwd(*map(torch.from_numpy, args), chunk_size=64, igate_act=igate_act)
    assert_close_rel(got.numpy(), want)


@pytest.mark.parametrize("igate_act", ["exp", "sigmoid"])
def test_mlstm_chunkwise_fwd_matches_jax_native(igate_act):
    args = _inputs(3, S=128, DH=16)
    want = J.mlstm_chunkwise(*map(jnp.asarray, args), chunk_size=64, igate_act=igate_act)
    got = mlstm_chunkwise_fwd(*map(torch.from_numpy, args), chunk_size=64, igate_act=igate_act)
    assert_close_rel(got.numpy(), want)


@pytest.mark.parametrize("S", [77, 200])
def test_mlstm_chunkwise_fwd_ragged_matches_jax(S):
    """A sequence that is no chunk multiple: the JAX entry pads with gate
    preacts -40 / +40, the port zero-pads (its kernel masks); both agree
    with the step-by-step form, JAX's and the port's."""
    args = _inputs(S, B=2, NH=2, S=S, DH=16)
    jargs, targs = tuple(map(jnp.asarray, args)), tuple(map(torch.from_numpy, args))
    got = mlstm_chunkwise_fwd(*targs, chunk_size=64)
    assert got.shape == args[0].shape
    assert_close_rel(got.numpy(), mlstm_chunkwise_pallas(*jargs, chunk_size=64, interpret=True,
                                                         mxu_dtype="float32"))
    assert_close_rel(got.numpy(), J.mlstm_recurrent(*jargs))
    assert_close_rel(got.numpy(), T.mlstm_recurrent(*targs).numpy())


def test_mlstm_chunkwise_fwd_chunk_8_and_64_agree():
    targs = tuple(map(torch.from_numpy, _inputs(5, S=200, DH=16)))
    assert_close_rel(mlstm_chunkwise_fwd(*targs, chunk_size=8).numpy(),
                     mlstm_chunkwise_fwd(*targs, chunk_size=64).numpy())


@pytest.mark.parametrize("igate_act", ["exp", "sigmoid"])
def test_mlstm_recurrent_matches_jax(igate_act):
    args = _inputs(6, S=19)
    hj, stj = J.mlstm_recurrent(*map(jnp.asarray, args), igate_act=igate_act,
                                return_last_state=True)
    ht, stt = T.mlstm_recurrent(*map(torch.from_numpy, args), igate_act=igate_act,
                                return_last_state=True)
    assert_close_rel(ht.numpy(), hj)
    for a, w in zip(stt, stj):
        assert_close_rel(a.numpy(), w)


def test_mlstm_chunkwise_fwd_on_cpu_is_the_plain_version():
    targs = tuple(map(torch.from_numpy, _inputs(7, S=40)))
    before = mlstm_chunkwise_fwd.launches
    got = mlstm_chunkwise_fwd(*targs, chunk_size=16)
    assert mlstm_chunkwise_fwd.launches == before  # no kernel launched for CPU tensors
    np.testing.assert_array_equal(got.numpy(),
                                  mlstm_chunkwise_fwd_plain(*targs, chunk_size=16).numpy())
    q = targs[0].clone().requires_grad_()
    mlstm_chunkwise_fwd(q, *targs[1:], chunk_size=16).square().sum().backward()
    assert bool(torch.isfinite(q.grad).all()) and float(q.grad.abs().sum()) > 0


def test_mlstm_chunkwise_fwd_off_cpu_refuses():
    """Off the CPU nothing falls back to the plain version: a call that
    needs gradients takes the kernels' route at every head dim the kernels
    take (64, 128, 256) and so refuses a device that is no CUDA device, with
    no launch counted; a head dim the kernel does not take, an unknown gate
    activation and a device that is no CUDA device without gradients each
    raise, without touching a card."""
    meta = lambda DH: tuple(torch.from_numpy(a).to("meta") for a in _inputs(8, S=16, DH=DH))
    before = (mlstm_chunkwise_fwd.launches, mlstm_chunkwise_bwd.launches)
    for DH in (64, 128, 256):
        args = meta(DH)
        with pytest.raises(ValueError, match="unsupported device"):
            mlstm_chunkwise_fwd(args[0].requires_grad_(), *args[1:])
    assert (mlstm_chunkwise_fwd.launches, mlstm_chunkwise_bwd.launches) == before
    with pytest.raises(ValueError, match="head dim"):
        mlstm_chunkwise_fwd(*meta(32))
    with pytest.raises(ValueError, match="igate_act"):
        mlstm_chunkwise_fwd(*meta(64), igate_act="relu")
    with pytest.raises(ValueError, match="unsupported device"):
        mlstm_chunkwise_fwd(*meta(64))


def _pair_inputs(seed, B=2, NH=2, S=32, DH=8):
    """q and k aligned, so that the normalizer stays away from zero and the
    gradients are well conditioned."""
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, NH, S, DH)).astype(np.float32)
    k = (q + 0.1 * r.normal(size=q.shape)).astype(np.float32)
    v, dh = (r.normal(size=(B, NH, S, DH)).astype(np.float32) for _ in range(2))
    i = r.normal(size=(B, NH, S)).astype(np.float32)
    f = (r.normal(size=(B, NH, S)) + 2).astype(np.float32)
    return q, k, v, i, f, dh


@pytest.mark.parametrize("igate_act", ["exp", "sigmoid"])
def test_plain_forward_backward_pair_matches_jax_bwd_ref(igate_act):
    a = _pair_inputs(9)
    want = jax_bwd_ref(*map(jnp.asarray, a), chunk_size=8, igate_act=igate_act)
    got = mlstm_chunkwise_bwd_heads(*map(torch.from_numpy, a), chunk_size=8, igate_act=igate_act)
    for name, g, w in zip("qkvif", got, want):
        assert tuple(g.shape) == w.shape, name
        assert_close_rel(g.numpy(), w)


def test_plain_forward_backward_pair_ragged_matches_jax_autodiff_on_qkv():
    """S 27 against a chunk of 8: the pair pads, JAX autodiff runs the
    step-by-step form; dq/dk/dv are exact whatever the stabilizer, the gate
    gradients are held to the frozen-stabilizer reference above."""
    q, k, v, i, f, dh = _pair_inputs(10, S=27)
    loss = lambda q_, k_, v_: jnp.sum(
        J.mlstm_recurrent(q_, k_, v_, jnp.asarray(i), jnp.asarray(f)) * jnp.asarray(dh))
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    targs = tuple(map(torch.from_numpy, (q, k, v, i, f, dh)))
    got = mlstm_chunkwise_bwd_heads(*targs, chunk_size=8)
    for g, w in zip(got[:3], want):
        assert_close_rel(g.numpy(), w, 1e-4)
    h = mlstm_chunkwise_fwd_plain(*targs[:5], chunk_size=8)
    assert_close_rel(h.numpy(), J.mlstm_recurrent(*map(jnp.asarray, (q, k, v, i, f))))
