"""Port parity: the torch sLSTM recurrence against the JAX one.

Same seeded numpy inputs through ``xlstm_yolo_tpu.kernels.slstm`` (and the
fused Pallas kernel in interpret mode) and ``xlstm_yolo_torch.kernels.slstm``
on the CPU, where ``slstm_scan_fwd`` takes the kernel's plain version.
Tolerance 1e-5 of each output's max: the same fp32 recurrence, differing in
summation order only. The reverse-time kernel's plain version
(``slstm_scan_bwd_plain``, the stabilizer held constant) is held to
``jax.vjp`` of the JAX scan, the JAX entry's backward, at the same
tolerance. The CUDA kernels themselves are checked on the card in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.kernels import slstm as J
from xlstm_yolo_tpu.kernels.slstm_pallas import slstm_scan_pallas
from xlstm_yolo_torch.kernels import slstm as T

TOL_REL = 1e-5


def assert_close(got, want, tol=TOL_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _inputs(seed, B=2, S=16, NH=3, DH=8):
    rng = np.random.default_rng(seed)
    wx = rng.normal(size=(B, S, NH, 4, DH)).astype(np.float32)
    r = (rng.normal(size=(NH, DH, 4, DH)) * 0.2).astype(np.float32)
    b = rng.normal(size=(NH, 4, DH)).astype(np.float32)
    return wx, r, b


@pytest.mark.parametrize("B,S,NH,DH", [(2, 16, 3, 8), (1, 33, 4, 32), (3, 5, 1, 16)])
def test_slstm_scan_matches_jax(B, S, NH, DH):
    args = _inputs(0, B, S, NH, DH)
    want = J.slstm_scan(*map(jnp.asarray, args))
    got = T.slstm_scan(*map(torch.from_numpy, args))
    assert_close(got.numpy(), want)


def test_slstm_scan_matches_jax_kernel_interpret():
    args = _inputs(3, B=2, S=12, NH=2, DH=16)
    want = slstm_scan_pallas(*map(jnp.asarray, args), interpret=True)
    got = T.slstm_scan_fwd(*map(torch.from_numpy, args))
    assert_close(got.numpy(), want)


def test_slstm_scan_state_carry_matches_jax():
    wx, r, b = _inputs(1, B=1, S=12, NH=2, DH=8)
    jr, jb, tr, tb = jnp.asarray(r), jnp.asarray(b), torch.from_numpy(r), torch.from_numpy(b)
    y1j, stj = J.slstm_scan(jnp.asarray(wx[:, :6]), jr, jb, return_last_state=True)
    y2j = J.slstm_scan(jnp.asarray(wx[:, 6:]), jr, jb, initial_state=stj)
    y1t, stt = T.slstm_scan_fwd(torch.from_numpy(wx[:, :6]), tr, tb, return_last_state=True)
    y2t = T.slstm_scan_fwd(torch.from_numpy(wx[:, 6:]), tr, tb, initial_state=stt)
    assert_close(y1t.numpy(), y1j)
    assert_close(y2t.numpy(), y2j)
    for a, w in zip(stt, stj):
        assert_close(a.numpy(), w)
    # the carried halves are the full scan
    full = T.slstm_scan(torch.from_numpy(wx), tr, tb)
    assert_close(torch.cat([y1t, y2t], 1).numpy(), full.numpy())


def test_slstm_step_matches_jax_and_scan():
    wx, r, b = _inputs(2, B=1, S=5, NH=2, DH=4)
    full = T.slstm_scan(*map(torch.from_numpy, (wx, r, b)))
    zj = jnp.zeros((1, 2, 4))
    sj = (zj, zj, zj, jnp.full((1, 2, 4), J.NEG_INIT))
    st = tuple(torch.from_numpy(np.array(s)) for s in sj)
    for t in range(5):
        yj, sj = J.slstm_step(jnp.asarray(wx[:, t]), jnp.asarray(r), jnp.asarray(b), sj)
        yt, st = T.slstm_step(torch.from_numpy(wx[:, t]), torch.from_numpy(r),
                              torch.from_numpy(b), st)
        assert_close(yt.numpy(), yj)
        assert_close(yt.numpy(), full[:, t].numpy())
        for a, w in zip(st, sj):
            assert_close(a.numpy(), w)


def test_slstm_first_step_has_no_forget_path():
    """m starts at NEG_INIT, so exp(NEG_INIT - m') is exactly 0 at step 1:
    n' is the input gate exp(0) = 1, never 0, and c' = tanh(z)."""
    wx, r, b = _inputs(4, B=2, S=1, NH=2, DH=8)
    assert T.NEG_INIT == J.NEG_INIT == -1e30
    y, (_, c, n, m) = T.slstm_scan(*map(torch.from_numpy, (wx, r, b)), return_last_state=True)
    raw = torch.from_numpy(wx[:, 0] + b[None])
    assert bool((n == 1.0).all())
    np.testing.assert_array_equal(m.numpy(), raw[:, :, 0].numpy())
    np.testing.assert_array_equal(c.numpy(), torch.tanh(raw[:, :, 2]).numpy())
    assert bool(torch.isfinite(y).all())


@pytest.mark.parametrize("block_idx,num_blocks", [(0, 4), (3, 4), (1, 7), (0, 1)])
def test_powerlaw_blockdependent_bias_matches_jax(block_idx, num_blocks):
    want = J.powerlaw_blockdependent_bias(4, 32, block_idx, num_blocks)
    got = T.powerlaw_blockdependent_bias(4, 32, block_idx, num_blocks)
    assert_close(got.numpy(), want)


def test_slstm_scan_fwd_on_cpu_is_the_plain_version():
    args = tuple(map(torch.from_numpy, _inputs(5)))
    before = T.slstm_scan_fwd.launches
    got = T.slstm_scan_fwd(*args)
    assert T.slstm_scan_fwd.launches == before  # no kernel launched for CPU tensors
    np.testing.assert_array_equal(got.numpy(), T.slstm_scan(*args).numpy())


def test_slstm_scan_fwd_on_cpu_is_differentiable():
    wx, r, b = (t.requires_grad_() for t in map(torch.from_numpy, _inputs(6, S=6)))
    T.slstm_scan_fwd(wx, r, b).square().sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) and float(t.grad.abs().sum()) > 0
               for t in (wx, r, b))


def test_slstm_scan_fwd_off_cpu_refuses():
    """Off the CPU nothing falls back to the plain scan: a call that needs
    gradients takes the kernels' route (the autograd Function) and so
    refuses a device that is no CUDA device, as a call without gradients
    does; a head dim the kernel is not built for raises; no launch is
    counted. Nothing touches a card."""
    meta = lambda DH: tuple(torch.from_numpy(a).to("meta") for a in _inputs(7, DH=DH))
    wx, r, b = meta(32)
    launches = lambda: (T.slstm_scan_fwd.launches, T.slstm_scan_bwd.launches)
    before = launches()
    with pytest.raises(ValueError, match="unsupported device"):
        T.slstm_scan_fwd(wx, r.requires_grad_(), b)
    with pytest.raises(ValueError, match="head dim"):
        T.slstm_scan_fwd(*meta(8))
    with pytest.raises(ValueError, match="unsupported device"):
        T.slstm_scan_fwd(*meta(32))
    assert launches() == before


def test_slstm_scan_fwd_off_cpu_state_carry_does_not_fall_back():
    """An explicit state carry off the CPU goes the kernel's way too, with
    or without gradients of the carried state or through the returned last
    state (the reverse-time kernel takes both): a device that is no CUDA
    device is refused, instead of running the plain scan there."""
    wx, r, b = (torch.from_numpy(a).to("meta") for a in _inputs(8, DH=32))
    state = tuple(torch.zeros((2, 3, 32), device="meta") for _ in range(4))
    with pytest.raises(ValueError, match="unsupported device"):
        T.slstm_scan_fwd(wx, r, b, initial_state=tuple(s.requires_grad_() for s in state))
    with pytest.raises(ValueError, match="unsupported device"):
        T.slstm_scan_fwd(wx.requires_grad_(), r, b, return_last_state=True)
    wx = wx.detach()
    with pytest.raises(ValueError, match="unsupported device"):
        T.slstm_scan_fwd(wx, r, b, initial_state=tuple(s.detach() for s in state))
    with pytest.raises(ValueError, match="unsupported device"):
        T.slstm_scan_fwd(wx, r, b, return_last_state=True)


@pytest.mark.parametrize("DH,S,carried", [(8, 1, False), (8, 13, False), (32, 1, False),
                                          (32, 13, False), (8, 13, True)],
                         ids=["dh8_S1", "dh8_ragged", "dh32_S1", "dh32_ragged", "dh8_carried"])
def test_slstm_scan_bwd_plain_matches_jax_vjp_and_autograd(DH, S, carried):
    """The reverse recurrence (stabilizer held constant) on the plain
    forward's states gives ``jax.vjp`` of the JAX scan (the JAX entry's
    backward) and autograd of the port's scan, for a recurrent kernel that
    matters, from the zero state and from a carried-in one."""
    B, NH = 2, 3
    wx, r, b = _inputs(10 + DH + S, B=B, S=S, NH=NH, DH=DH)
    rng = np.random.default_rng(DH + S)
    r = (rng.normal(size=r.shape) * 0.5 * DH ** -0.5).astype(np.float32)
    dy = rng.normal(size=(B, S, NH, DH)).astype(np.float32)
    init = None
    if carried:
        y0, c0, n0, m0 = (rng.normal(size=(B, NH, DH)).astype(np.float32) for _ in range(4))
        init = (y0, c0, np.abs(n0) + 0.5, m0)

    jinit = None if init is None else tuple(map(jnp.asarray, init))
    _, vjp = jax.vjp(lambda *a: J.slstm_scan(*a, initial_state=jinit), *map(jnp.asarray, (wx, r, b)))
    want = vjp(jnp.asarray(dy))

    tinit = None if init is None else tuple(map(torch.from_numpy, init))
    targs = tuple(torch.from_numpy(a).requires_grad_() for a in (wx, r, b))
    (T.slstm_scan(*targs, initial_state=tinit) * torch.from_numpy(dy)).sum().backward()
    with torch.no_grad():
        y, states = T.slstm_scan_states(*targs, initial_state=tinit)
        got = T.slstm_scan_bwd_plain(*targs, y, states, torch.from_numpy(dy), initial_state=tinit)
    assert_close(y.numpy(), J.slstm_scan(*map(jnp.asarray, (wx, r, b)), initial_state=jinit))
    for name, g, w, a in zip(("dwx", "dr", "db"), got, want, targs):
        assert tuple(g.shape) == w.shape, name
        assert_close(g.numpy(), w)
        assert_close(g.numpy(), a.grad.numpy())
