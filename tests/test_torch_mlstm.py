"""Port parity: the torch chunkwise mLSTM against the JAX one.

Same seeded numpy inputs through ``xlstm_yolo_tpu.kernels.mlstm_native``
and ``xlstm_yolo_torch.kernels.mlstm_native``, fp32 on the CPU. Tolerance
1e-5: the same algorithm in fp32, differing only in summation order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xlstm_yolo_tpu.kernels import mlstm_native as J
from xlstm_yolo_torch.kernels import mlstm_native as T

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B=2, NH=3, S=64, DH=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, NH, S, DH)).astype(np.float32) for _ in range(3))
    i = (rng.normal(size=(B, NH, S)) * 2.0).astype(np.float32)
    f = (rng.normal(size=(B, NH, S)) * 2.0 + 2.0).astype(np.float32)
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
