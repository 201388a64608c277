"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips where there is no CUDA device (the
kernels have no CPU mode). Imports nothing of JAX, so it runs on a GPU host
with only the port installed: ``pytest -m cuda tests/test_torch_cuda.py``.
Tolerance: relative error (max |kernel - plain| / max |plain|) 1e-3, fp32
with other summation orders and chunk lengths than the plain version; each
gradient is held to its own max.
"""
import copy
from contextlib import contextmanager, nullcontext

import numpy as np
import pytest
import torch

from xlstm_yolo_torch.kernels.mlstm_bwd import (
    chunk_carry_states, mlstm_chunkwise_bwd, mlstm_chunkwise_bwd_plain, mlstm_chunkwise_bwd_ref)
from xlstm_yolo_torch.kernels.mlstm_fwd import _carry_states
from xlstm_yolo_torch.kernels.mlstm_fwd import _launch as mlstm_fwd_launch
from xlstm_yolo_torch.kernels.mlstm_fwd import (
    mlstm_chunkwise_bwd_heads, mlstm_chunkwise_fwd, mlstm_chunkwise_fwd_plain)
from xlstm_yolo_torch.kernels.mlstm_native import mlstm_recurrent
from xlstm_yolo_torch.kernels.slstm import _launch as slstm_launch
from xlstm_yolo_torch.kernels.slstm import (
    slstm_scan, slstm_scan_bwd, slstm_scan_bwd_plain, slstm_scan_fwd, slstm_scan_states)
from xlstm_yolo_torch.kernels.topk import (
    NEG_INF, rowwise_kth_value, rowwise_kth_value_plain)
from xlstm_yolo_torch.kernels.vil_block import (
    _block_plain, block_bwd, vil_block_fwd, vil_block_plain)
from xlstm_yolo_torch.kernels.vil_cell import (
    Cfg, _cell_plain, cell_bwd, vil_cell_fwd, vil_cell_plain)
from xlstm_yolo_torch.kernels.vil_conv import (
    _conv_plain, conv_layer_bwd, vil_layer_conv_fwd, vil_layer_conv_plain)
from xlstm_yolo_torch.kernels.vil_layer import (
    _layer_plain, vil_layer_bwd_ref, vil_layer_fwd, vil_layer_ref)

pytestmark = pytest.mark.cuda
TOL_REL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer_args(B, S, DIM, NH, device, seed, DH=64):
    rng = np.random.default_rng(seed)
    INNER = NH * DH
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    return [mk(B, S, DIM), mk(B, S, INNER), 1.0 + mk(DIM) * 0.2,
            mk(DIM, 2 * INNER) * DIM ** -0.5, mk(2 * INNER) * 0.1,
            mk(NH, DH, DH) * 0.3, mk(INNER) * 0.1, mk(NH, DH, DH) * 0.3, mk(INNER) * 0.1,
            mk(NH, DH, DH) * 0.3, mk(INNER) * 0.1,
            mk(3 * INNER, NH) * 0.05, torch.full((NH,), -8.0, device=device),
            mk(3 * INNER, NH) * 0.05, torch.full((NH,), 4.0, device=device),
            1.0 + mk(INNER) * 0.2, mk(INNER) * 0.1, 1.0 + mk(INNER) * 0.1,
            mk(INNER, DIM) * INNER ** -0.5, mk(DIM) * 0.1]


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("S,DIM,NH,igate_act", [
    (6400, 64, 2, "exp"), (1600, 128, 4, "exp"), (400, 256, 8, "exp"),
    (200, 64, 2, "exp"), (77, 64, 2, "sigmoid"), (100, 70, 2, "exp"),
], ids=["P3", "P4", "P5", "ragged", "short_sigmoid", "odd_dim"])
def test_vil_layer_kernel_matches_plain(cuda_device, S, DIM, NH, igate_act):
    """ViL-YOLO-n stage shapes at 640 px, a ragged S, an S shorter than one
    chunk, and a DIM whose rows are not 16-byte aligned and whose last
    64-column tile is partial."""
    args = _layer_args(2, S, DIM, NH, cuda_device, seed=S)
    before = vil_layer_fwd.launches
    got = vil_layer_fwd(*args, NH, chunk_size=128, igate_act=igate_act)
    want = vil_layer_ref(*args, NH, chunk_size=128, igate_act=igate_act)
    torch.cuda.synchronize()
    assert vil_layer_fwd.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL_REL


def test_vil_layer_kernel_rejects_bad_input(cuda_device):
    args = _layer_args(1, 64, 64, 2, cuda_device, seed=0)
    with pytest.raises(TypeError):
        vil_layer_fwd(args[0].double(), *args[1:], 2)
    with pytest.raises(ValueError):  # 4 heads over weights made for 2
        vil_layer_fwd(*args, 4)


def test_vil_layer_kernel_refuses_grad(cuda_device):
    """With gradients needed the call goes through the hand-written backward:
    one forward launch, and one chunkwise-backward launch in backward();
    the gradients match the plain backward on the plain forward's
    activations."""
    args = _layer_args(2, 200, 64, 2, cuda_device, seed=1)
    leaves = [a.clone().requires_grad_() for a in args]
    gout = torch.randn(2, 200, 64, device=cuda_device)
    f0, b0 = vil_layer_fwd.launches, mlstm_chunkwise_bwd.launches
    out = vil_layer_fwd(*leaves, 2, chunk_size=128)
    (out * gout).sum().backward()
    torch.cuda.synchronize()
    assert (vil_layer_fwd.launches, mlstm_chunkwise_bwd.launches) == (f0 + 1, b0 + 1)
    _, acts = _layer_plain(args, Cfg(2, 128))
    want = vil_layer_bwd_ref(args, acts, gout, 2, chunk_size=128)
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        assert _rel(leaf.grad, w) <= TOL_REL, i


def _cell_args(B, S, NH, device, seed):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(device)
    INNER = NH * 64
    q = mk(B, S, INNER)
    k = q + 0.3 * mk(B, S, INNER)
    return (q, k, mk(B, S, INNER), mk(B, NH, S) - 3.0, mk(B, NH, S) + 3.0, mk(B, S, INNER))


@pytest.mark.parametrize("S,igate_act", [(256, "exp"), (400, "exp"), (77, "sigmoid")],
                         ids=["whole_chunks", "ragged_p5", "short_sigmoid"])
def test_mlstm_bwd_kernel_matches_plain(cuda_device, S, igate_act):
    q, k, v, i, f, dh = _cell_args(2, S, 2, cuda_device, seed=S)
    heads = lambda t: t.reshape(2, S, 2, 64).transpose(1, 2)
    carry = chunk_carry_states(heads(k), heads(v), i, f, 64, igate_act)
    before = mlstm_chunkwise_bwd.launches
    got = mlstm_chunkwise_bwd(q, k, v, i, f, dh, 2, carry=carry, igate_act=igate_act)
    want = mlstm_chunkwise_bwd_plain(q, k, v, i, f, dh, 2, igate_act=igate_act)
    torch.cuda.synchronize()
    assert mlstm_chunkwise_bwd.launches == before + 1
    for name, g_, w in zip("qkvif", got, want):
        assert bool(torch.isfinite(g_).all()), name
        assert _rel(g_, w) <= TOL_REL, name


def test_vil_yolo_forward_launches_kernel_per_stage(cuda_device):
    import xlstm_yolo_torch.nn.vil as vil_mod
    from xlstm_yolo_torch.nn.tasks import TaskModel

    model = TaskModel("vil_yolon.yaml", device=cuda_device)
    x = torch.rand(2, 160, 160, 3, device=cuda_device)
    with torch.inference_mode():
        before = vil_layer_fwd.launches
        got = model.predictions(x)
        assert vil_layer_fwd.launches == before + 3
        vil_mod.vil_layer_fwd = vil_layer_ref
        try:
            want = model.predictions(x)
        finally:
            vil_mod.vil_layer_fwd = vil_layer_fwd
    assert _rel(got, want) <= TOL_REL


def _mlstm_args(B, NH, S, DH, device, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    return mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S), mk(B, NH, S) + 2.0


@pytest.mark.parametrize("S,DH,igate_act", [
    (256, 64, "exp"), (256, 128, "exp"), (256, 256, "exp"), (200, 64, "exp"),
    (77, 128, "sigmoid"), (193, 256, "sigmoid"), (1, 64, "exp"),
], ids=["dh64", "dh128", "dh256", "ragged_dh64", "short_sigmoid_dh128", "ragged_sigmoid_dh256",
        "one_step"])
def test_mlstm_fwd_kernel_matches_plain(cuda_device, S, DH, igate_act):
    """K1 at every head dim it takes, at whole and ragged S (as ``generate``
    gives it), both gate activations; also against the step-by-step form."""
    args = _mlstm_args(2, 4, S, DH, cuda_device, seed=S + DH)
    before = mlstm_chunkwise_fwd.launches
    got = mlstm_chunkwise_fwd(*args, chunk_size=64, igate_act=igate_act)
    want = mlstm_chunkwise_fwd_plain(*args, chunk_size=64, igate_act=igate_act)
    torch.cuda.synchronize()
    assert mlstm_chunkwise_fwd.launches == before + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL_REL
    assert _rel(got, mlstm_recurrent(*args, igate_act=igate_act)) <= TOL_REL


def test_mlstm_fwd_kernel_refuses(cuda_device):
    """No fallback on the card: gradients at head dims 128 and 256 take the
    kernels' route (one K1 launch, one K2 launch in backward()); another head
    dim and another dtype each raise."""
    args = _mlstm_args(1, 2, 64, 64, cuda_device, seed=0)
    for DH in (128, 256):
        wide = _mlstm_args(1, 2, 64, DH, cuda_device, seed=0)
        before = (mlstm_chunkwise_fwd.launches, mlstm_chunkwise_bwd.launches)
        q = wide[0].clone().requires_grad_()
        mlstm_chunkwise_fwd(q, *wide[1:]).sum().backward()
        torch.cuda.synchronize()
        assert (mlstm_chunkwise_fwd.launches, mlstm_chunkwise_bwd.launches) == \
            (before[0] + 1, before[1] + 1)
        assert bool(torch.isfinite(q.grad).all())
    with pytest.raises(ValueError, match="head dim"):
        mlstm_chunkwise_fwd(*_mlstm_args(1, 2, 64, 32, cuda_device, seed=0))
    with pytest.raises(TypeError):
        mlstm_chunkwise_fwd(args[0].double(), *args[1:])


@pytest.mark.parametrize("S,igate_act", [(256, "exp"), (200, "sigmoid"), (77, "exp")],
                         ids=["whole_chunks", "ragged_sigmoid", "ragged"])
@pytest.mark.parametrize("DH", [64, 128, 256])
def test_mlstm_fwd_kernel_workspace_is_the_carry_states(cuda_device, DH, S, igate_act):
    """With a workspace (the call under autograd) K1 writes the state carried
    into every chunk, which the chunkwise backward reads: it equals
    ``chunk_carry_states`` (fp32, other summation orders: 1e-5 of each
    array's max). Without one it writes nothing but h, and h is the same
    bit for bit."""
    args = _mlstm_args(2, 4, S, DH, cuda_device, seed=S + DH + 1)
    h, ws, off = mlstm_fwd_launch(*args, igate_act, 1e-6, states=True)
    h_free, ws_free, _ = mlstm_fwd_launch(*args, igate_act, 1e-6)
    torch.cuda.synchronize()
    assert ws_free is None and torch.equal(h, h_free)
    got = _carry_states(ws, off, 2 * 4, S, DH)
    want = chunk_carry_states(*args[1:], 64, igate_act)
    for name in ("c", "n", "m", "btot", "mloc"):
        g_, w = getattr(got, name), getattr(want, name)
        assert g_.shape == w.shape and bool(torch.isfinite(g_).all()), name
        assert _rel(g_, w) <= 1e-5, name


@pytest.mark.parametrize("S,igate_act", [(256, "exp"), (200, "exp"), (40, "sigmoid")],
                         ids=["whole_chunks", "ragged", "short_sigmoid"])
def test_mlstm_fwd_kernel_under_grad_runs_the_backward_kernel(cuda_device, S, igate_act):
    """K1 under grad at head dim 64: one forward launch, and one
    chunkwise-backward launch in backward() on the carry states the forward
    kernel left; h and the five gradients match the plain pair (the plain
    forward with the plain chunkwise backward as its backward)."""
    args = _mlstm_args(2, 4, S, 64, cuda_device, seed=S)
    leaves = [a.clone().requires_grad_() for a in args]
    dh = torch.randn(2, 4, S, 64, device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(S))
    f0, b0 = mlstm_chunkwise_fwd.launches, mlstm_chunkwise_bwd.launches
    h = mlstm_chunkwise_fwd(*leaves, igate_act=igate_act)
    (h * dh).sum().backward()
    torch.cuda.synchronize()
    assert (mlstm_chunkwise_fwd.launches, mlstm_chunkwise_bwd.launches) == (f0 + 1, b0 + 1)
    assert _rel(h, mlstm_chunkwise_fwd_plain(*args, igate_act=igate_act)) <= TOL_REL
    cpu = [a.cpu() for a in args]
    want = mlstm_chunkwise_bwd_heads(*cpu, dh.cpu(), igate_act=igate_act)
    for name, leaf, w in zip("qkvif", leaves, want):
        assert bool(torch.isfinite(leaf.grad).all()), name
        assert _rel(leaf.grad.cpu(), w) <= TOL_REL, name


def _lm_train_step(cfg, tokens, plain: bool, recurrent_std: float = 0.0):
    """One train step of ``xLSTMLMModel(**cfg)`` on the card with seeded gate
    kernels (and sLSTM recurrent kernels at ``recurrent_std``), with the
    kernels or with the plain versions forced in -> (loss, gradients,
    launches of K1, K2, K5, the K5 backward)."""
    import xlstm_yolo_torch.nn.vil as vil_mod
    import xlstm_yolo_torch.nn.xlstm as lm_mod
    from xlstm_yolo_torch.nn.xlstm import xLSTMLMModel
    from xlstm_yolo_torch.utils.loss import lm_loss
    from xlstm_yolo_torch.utils.train_utils import StepUpdate

    model = xLSTMLMModel(**cfg, device=tokens.device).train()
    gg = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "gate.weight" in name:
                p.copy_((torch.randn(p.shape, generator=gg) * 0.05).to(p.device))
            elif "recurrent_kernel" in name:
                p.copy_((torch.randn(p.shape, generator=gg) * recurrent_std).to(p.device))
    update = StepUpdate(model)
    counters = (mlstm_chunkwise_fwd, mlstm_chunkwise_bwd, slstm_scan_fwd, slstm_scan_bwd)
    before = [c.launches for c in counters]
    if plain:
        vil_mod.mlstm_chunkwise_fwd, lm_mod.slstm_scan_fwd = mlstm_chunkwise_fwd_plain, slstm_scan
    try:
        loss = lm_loss(model(tokens[:, :-1]), tokens[:, 1:])
        loss.backward()
    finally:
        vil_mod.mlstm_chunkwise_fwd, lm_mod.slstm_scan_fwd = mlstm_chunkwise_fwd, slstm_scan_fwd
    torch.cuda.synchronize()
    counts = tuple(c.launches - b for c, b in zip(counters, before))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    update(1)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    return float(loss.detach()), grads, counts


def test_xlstm_lm_train_step_on_card(cuda_device):
    """One train step of an mLSTM-only language model (cell head dim 64):
    K1 and K2 once per block, the loss and every gradient within tolerance
    of the same step with the plain forward (autograd) forced in; a model
    with an sLSTM block now trains too: K5 and its reverse-time kernel once
    for the sLSTM block."""
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, 500, (2, 101), generator=g).to(cuda_device)
    for slstm_at, expect in (((), (2, 2, 0, 0)), ((1,), (1, 1, 1, 1))):
        cfg = dict(vocab_size=500, embedding_dim=128, num_blocks=2, slstm_at=slstm_at)
        lk, gk, counts = _lm_train_step(cfg, tokens, plain=False, recurrent_std=0.05)
        lp, gp, plain_counts = _lm_train_step(cfg, tokens, plain=True, recurrent_std=0.05)
        assert counts == expect and plain_counts == (0, 0, 0, 0)
        assert abs(lk - lp) <= TOL_REL * abs(lp)
        for n in gp:
            assert _rel(gk[n], gp[n]) <= TOL_REL, n


@pytest.mark.parametrize("cfg,S,expect", [
    (dict(vocab_size=50304, embedding_dim=128, num_blocks=7, slstm_at=(1,), num_heads=4), 256,
     (6, 6, 1, 1)),
    (dict(vocab_size=50304, embedding_dim=512, num_blocks=8, slstm_at=(1,), num_heads=4), 256,
     (7, 7, 1, 1)),
], ids=["readme_dh64_slstm_dh32", "wide_dh256_slstm_dh128"])
def test_lm_train_step_readme_and_wide_on_card(cuda_device, cfg, S, expect):
    """A train step of the README model and of the wide model (cell head dim
    256, sLSTM head dim 128) at batch 2: K1 and K2 once per mLSTM block, K5
    and the reverse-time kernel once, the loss and every gradient within
    tolerance of the step with the plain versions forced in."""
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg["vocab_size"], (2, S + 1), generator=g).to(cuda_device)
    std = 0.5 * (cfg["embedding_dim"] // cfg["num_heads"]) ** -0.5
    lk, gk, counts = _lm_train_step(cfg, tokens, plain=False, recurrent_std=std)
    lp, gp, plain_counts = _lm_train_step(cfg, tokens, plain=True, recurrent_std=std)
    assert counts == expect and plain_counts == (0, 0, 0, 0)
    assert abs(lk - lp) <= TOL_REL * abs(lp)
    gmax = max(g_.abs().max().item() for g_ in gp.values())
    for n in gp:  # a gradient that vanishes up to rounding is held to the largest one
        scale = max(gp[n].abs().max().item(), 1e-6 * gmax)
        assert (gk[n] - gp[n]).abs().max().item() <= TOL_REL * scale, n


def _slstm_args(B, S, NH, DH, device, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    return mk(B, S, NH, 4, DH), mk(NH, DH, 4, DH) * DH ** -0.5, mk(NH, 4, DH)


@pytest.mark.parametrize("B,S,DH", [(2, 64, 32), (3, 50, 64), (2, 64, 128), (1, 1, 32)],
                         ids=["dh32", "dh64_odd", "dh128", "one_step"])
def test_slstm_kernel_matches_plain(cuda_device, B, S, DH):
    """K5 at every head dim it takes, with a recurrent kernel that matters."""
    args = _slstm_args(B, S, 4, DH, cuda_device, seed=S + DH)
    before = slstm_scan_fwd.launches
    got = slstm_scan_fwd(*args)
    want = slstm_scan(*args)
    torch.cuda.synchronize()
    assert slstm_scan_fwd.launches == before + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL_REL


@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("DH", [32, 64, 128])
def test_slstm_kernel_batches_match_plain(cuda_device, DH, B):
    """K5 at every head dim over three heads and batches of 1 to 11 (one CTA
    or cluster per chain): the full scan with its last state, a single step,
    and two calls with the state carried through the kernel."""
    wx, r, b = _slstm_args(B, 37, 3, DH, cuda_device, seed=B + DH)
    want, want_last = slstm_scan(wx, r, b, return_last_state=True)
    before = slstm_scan_fwd.launches
    y, last = slstm_scan_fwd(wx, r, b, return_last_state=True)
    one = slstm_scan_fwd(wx[:, :1].contiguous(), r, b)
    y1, mid = slstm_scan_fwd(wx[:, :20].contiguous(), r, b, return_last_state=True)
    y2, last2 = slstm_scan_fwd(wx[:, 20:].contiguous(), r, b, initial_state=mid,
                               return_last_state=True)
    torch.cuda.synchronize()
    assert slstm_scan_fwd.launches == before + 4
    assert y.shape == want.shape and bool(torch.isfinite(y).all())
    assert _rel(y, want) <= TOL_REL
    assert _rel(one, slstm_scan(wx[:, :1], r, b)) <= TOL_REL
    assert _rel(torch.cat([y1, y2], 1), want) <= TOL_REL
    for got, got2, ref in zip(last, last2, want_last):
        assert _rel(got, ref) <= TOL_REL and _rel(got2, ref) <= TOL_REL


def test_slstm_kernel_refuses_and_state_carry(cuda_device):
    """Gradients of an input take the kernels' route (one forward launch,
    one reverse-time launch in backward()), and so do gradients of a
    carried state and through the returned last state; another head dim
    and a misshapen state raise; an explicit state carry launches the
    kernel, never the plain scan."""
    wx, r, b = _slstm_args(1, 8, 2, 32, cuda_device, seed=1)
    before = (slstm_scan_fwd.launches, slstm_scan_bwd.launches)
    rg = r.clone().requires_grad_()
    slstm_scan_fwd(wx, rg, b).sum().backward()
    torch.cuda.synchronize()
    assert (slstm_scan_fwd.launches, slstm_scan_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert bool(torch.isfinite(rg.grad).all())
    with pytest.raises(ValueError, match="head dim"):
        slstm_scan_fwd(*_slstm_args(1, 8, 2, 16, cuda_device, seed=1))
    before = slstm_scan_fwd.launches
    y, last = slstm_scan_fwd(wx, r, b, return_last_state=True)
    assert slstm_scan_fwd.launches == before + 1 and len(last) == 4
    assert _rel(slstm_scan_fwd(wx, r, b), y) <= TOL_REL
    before = (slstm_scan_fwd.launches, slstm_scan_bwd.launches)
    init = tuple(s.clone().requires_grad_() for s in last)
    y2, last2 = slstm_scan_fwd(wx, r.clone().requires_grad_(), b, initial_state=init,
                               return_last_state=True)
    (y2.sum() + sum(s.sum() for s in last2[:3])).backward()
    torch.cuda.synchronize()
    assert (slstm_scan_fwd.launches, slstm_scan_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert all(bool(torch.isfinite(s.grad).all()) for s in init)
    with pytest.raises(ValueError, match="initial_state"):
        slstm_scan_fwd(wx, r, b, initial_state=tuple(s[:, :1] for s in last))


@pytest.mark.parametrize("DH", [32, 64, 128])
def test_slstm_carried_state_grads_match_plain_reverse(cuda_device, DH):
    """The carried sLSTM state both ways on the card: gradients of the
    inputs and of a grad-requiring initial_state, for cotangents on y and on
    every part of the returned last state (y, c, n, m), through K5 and the
    reverse-time kernel, against ``slstm_scan_bwd_plain`` (the plain
    reverse recurrence) on the same inputs: TOL_REL of each tensor's max."""
    wx, r, b = _slstm_args(2, 23, 2, DH, cuda_device, seed=DH + 11)
    _, state = slstm_scan(wx[:, :6], r, b, return_last_state=True)
    g = torch.Generator(cuda_device).manual_seed(DH)
    dy = torch.randn(2, 23, 2, DH, device=cuda_device, generator=g)
    dlast = torch.randn(4, 2, 2, DH, device=cuda_device, generator=g)
    leaves = [t.clone().requires_grad_() for t in (wx, r, b, *state)]
    before = slstm_scan_bwd.launches
    y, last = slstm_scan_fwd(*leaves[:3], initial_state=tuple(leaves[3:]),
                             return_last_state=True)
    ((y * dy).sum() + sum((s * d).sum() for s, d in zip(last, dlast))).backward()
    torch.cuda.synchronize()
    assert slstm_scan_bwd.launches == before + 1
    want_y, states = slstm_scan_states(wx, r, b, initial_state=state)
    dwx, dr, db, dstate = slstm_scan_bwd_plain(wx, r, b, want_y, states, dy,
                                               initial_state=state, dlast=tuple(dlast),
                                               with_state=True)
    for name, leaf, w in zip(("wx", "r", "b", "y0", "c0", "n0", "m0"), leaves,
                             (dwx, dr, db, *dstate)):
        assert _rel(leaf.grad, w) <= TOL_REL, name


@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("DH", [32, 64, 128])
def test_slstm_bwd_kernel_matches_plain(cuda_device, DH, B):
    """The reverse-time kernel over three heads at a ragged S, from the zero
    state and from a carried-in one: the forward's workspace holds the plain
    scan's states, and (dwx, dr, db) match ``slstm_scan_bwd_plain`` on the
    same inputs."""
    wx, r, b = _slstm_args(B, 37, 3, DH, cuda_device, seed=B + DH + 7)
    dy = torch.randn(B, 37, 3, DH, device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(B + DH))
    _, mid = slstm_scan(wx[:, :5], r, b, return_last_state=True)
    for state in (None, mid):
        packed = None if state is None else torch.stack(state).contiguous()
        before = (slstm_scan_fwd.launches, slstm_scan_bwd.launches)
        y, _, saved = slstm_launch(wx, r, b, packed, return_last_state=False, save=True)
        got = slstm_scan_bwd(r, y, saved, dy, packed)
        torch.cuda.synchronize()
        assert (slstm_scan_fwd.launches, slstm_scan_bwd.launches) == (before[0] + 1, before[1] + 1)
        want_y, states = slstm_scan_states(wx, r, b, initial_state=state)
        assert _rel(y, want_y) <= TOL_REL
        for i, ref in enumerate(states):
            assert _rel(saved[:, :, :, 4 + i], ref) <= TOL_REL, i
        want = slstm_scan_bwd_plain(wx, r, b, want_y, states, dy, initial_state=state)
        for name, g_, w in zip(("dwx", "dr", "db"), got, want):
            assert g_.shape == w.shape and bool(torch.isfinite(g_).all()), name
            assert _rel(g_, w) <= TOL_REL, name


@pytest.mark.parametrize("DH,B,S", [
    (32, 2, 1), (64, 2, 1), (128, 2, 1), (32, 3, 3), (64, 3, 5), (128, 2, 3), (32, 2, 13),
    (64, 2, 21), (128, 3, 13), (128, 64, 40)],
    ids=["dh32_S1", "dh64_S1", "dh128_S1", "dh32_S3", "dh64_S5", "dh128_S3", "dh32_S13",
         "dh64_S21", "dh128_S13", "dh128_B64_waves"])
def test_slstm_bwd_kernel_ring_edges_and_carried_state(cuda_device, DH, B, S):
    """The reverse-time kernel where its rings are longer than S (one step,
    fewer steps than the staged and the coefficient rings, S no multiple of
    either) and at B 64, DH 128 (512 CTAs of two-CTA clusters: several
    waves), from the zero state and from a carried-in one with the gradient
    of the returned last state and of the initial one, against
    ``slstm_scan_bwd_plain``."""
    wx, r, b = _slstm_args(B, S, 2, DH, cuda_device, seed=B + S + DH)
    g = torch.Generator(cuda_device).manual_seed(S + DH)
    dy = torch.randn(B, S, 2, DH, device=cuda_device, generator=g)
    dlast = torch.randn(4, B, 2, DH, device=cuda_device, generator=g)
    _, mid = slstm_scan(wx[:, :2], r, b, return_last_state=True)
    for state, dl in ((None, None), (mid, dlast)):
        packed = None if state is None else torch.stack(state).contiguous()
        y, _, saved = slstm_launch(wx, r, b, packed, return_last_state=False, save=True)
        before = slstm_scan_bwd.launches
        got = slstm_scan_bwd(r, y, saved, dy, packed, dl, with_state=True)
        torch.cuda.synchronize()
        assert slstm_scan_bwd.launches == before + 1
        want_y, states = slstm_scan_states(wx, r, b, initial_state=state)
        want = slstm_scan_bwd_plain(wx, r, b, want_y, states, dy, initial_state=state,
                                    dlast=None if dl is None else tuple(dl), with_state=True)
        for name, g_, w in zip(("dwx", "dr", "db", "y0", "c0", "n0", "m0"),
                               (*got[:3], *got[3]), (*want[:3], *want[3])):
            assert g_.shape == w.shape and bool(torch.isfinite(g_).all()), name
            # one step from the zero state: y_{-1} = 0, so dr is exactly 0
            assert _rel(g_, w) <= TOL_REL if w.abs().max() > 0 else not g_.any(), name


@pytest.mark.parametrize("DH", [32, 128])
def test_slstm_function_grads_match_autograd(cuda_device, DH):
    """``slstm_scan_fwd`` under grad (``_SlstmFunction``: K5 with its
    workspace, then the reverse-time kernel) against autograd of the plain
    scan, from the zero state and from a carried-in constant state."""
    wx, r, b = _slstm_args(3, 29, 2, DH, cuda_device, seed=DH + 3)
    dy = torch.randn(3, 29, 2, DH, device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(DH))
    _, state = slstm_scan(wx[:, :4], r, b, return_last_state=True)
    for init in (None, state):
        grads = []
        for fn in (slstm_scan_fwd, slstm_scan):
            leaves = [t.clone().requires_grad_() for t in (wx, r, b)]
            (fn(*leaves, initial_state=init) * dy).sum().backward()
            grads.append([t.grad for t in leaves])
        for name, g_, w in zip(("wx", "r", "b"), *grads):
            assert _rel(g_, w) <= TOL_REL, name


@pytest.mark.parametrize("S,DH,igate_act", [
    (256, 128, "exp"), (256, 256, "exp"), (200, 128, "sigmoid"), (77, 256, "exp"),
    (1024, 256, "exp"),
], ids=["dh128", "dh256", "ragged_sigmoid_dh128", "ragged_dh256", "wide_S1024_dh256"])
def test_mlstm_bwd_kernel_wide_heads_match_reference(cuda_device, S, DH, igate_act):
    """K2 at head dims 128 and 256 on the carry states K1 leaves in its
    workspace, against ``mlstm_chunkwise_bwd_ref`` (whole chunks) or its
    zero-padded plain version (ragged S); then the same through autograd
    (``mlstm_chunkwise_fwd`` under grad)."""
    g = torch.Generator().manual_seed(S + DH)
    mk = lambda *sh: torch.randn(*sh, generator=g).to(cuda_device)
    q = mk(2, 4, S, DH)
    k, v, i, f, dh = q + 0.3 * mk(2, 4, S, DH), mk(2, 4, S, DH), mk(2, 4, S) - 3.0, \
        mk(2, 4, S) + 3.0, mk(2, 4, S, DH)
    _, ws, off = mlstm_fwd_launch(q, k, v, i, f, igate_act, 1e-6, states=True)
    carry = _carry_states(ws, off, 8, S, DH)
    before = mlstm_chunkwise_bwd.launches
    got = mlstm_chunkwise_bwd_heads(q, k, v, i, f, dh, carry=carry, igate_act=igate_act)
    torch.cuda.synchronize()
    assert mlstm_chunkwise_bwd.launches == before + 1
    if S % 64 == 0:
        want = mlstm_chunkwise_bwd_ref(q, k, v, i, f, dh, chunk_size=64, igate_act=igate_act)
    else:
        want = mlstm_chunkwise_bwd_heads(*(t.cpu() for t in (q, k, v, i, f, dh)),
                                         igate_act=igate_act)
    for name, g_, w in zip("qkvif", got, want):
        assert bool(torch.isfinite(g_).all()), name
        assert _rel(g_, w.to(cuda_device)) <= TOL_REL, name
    leaves = [t.clone().requires_grad_() for t in (q, k, v, i, f)]
    (mlstm_chunkwise_fwd(*leaves, igate_act=igate_act) * dh).sum().backward()
    for name, leaf, w in zip("qkvif", leaves, want):
        assert _rel(leaf.grad, w.to(cuda_device)) <= TOL_REL, name


@pytest.mark.parametrize("DH", [32, 64, 128])
def test_slstm_kernel_state_carry_matches_plain(cuda_device, DH):
    """K5 reads the carried-in (y, c, n, m) and writes the last one: two
    carried halves are the full scan, and every state agrees with the plain
    scan's."""
    wx, r, b = _slstm_args(2, 40, 4, DH, cuda_device, seed=DH)
    before = slstm_scan_fwd.launches
    y1, mid = slstm_scan_fwd(wx[:, :17], r, b, return_last_state=True)
    y2, last = slstm_scan_fwd(wx[:, 17:], r, b, initial_state=mid, return_last_state=True)
    assert slstm_scan_fwd.launches == before + 2
    want, want_last = slstm_scan(wx, r, b, return_last_state=True)
    _, want_mid = slstm_scan(wx[:, :17], r, b, return_last_state=True)
    assert _rel(torch.cat([y1, y2], 1), want) <= TOL_REL
    assert _rel(torch.cat([y1, y2], 1), slstm_scan_fwd(wx, r, b)) <= TOL_REL
    for got, ref in zip((*mid, *last), (*want_mid, *want_last)):
        assert got.shape == ref.shape and _rel(got, ref) <= TOL_REL
    y3 = slstm_scan_fwd(wx[:, 17:], r, b, initial_state=want_mid)  # carry in only
    assert _rel(y3, want[:, 17:]) <= TOL_REL


def test_xlstm_lm_forward_launches_kernels(cuda_device):
    """The language model on the card: one K1 launch per mLSTM block and one
    K5 launch per sLSTM block, logits within tolerance of the same model
    with the plain versions forced in; ``generate`` appends tokens."""
    import xlstm_yolo_torch.nn.vil as vil_mod
    import xlstm_yolo_torch.nn.xlstm as lm_mod
    from xlstm_yolo_torch.nn.xlstm import generate, xLSTMLMModel

    model = xLSTMLMModel(1000, embedding_dim=128, num_blocks=3, slstm_at=(1,), device=cuda_device)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "gate.weight" in name or "recurrent_kernel" in name:
                p.copy_((torch.randn(p.shape, generator=g) * 0.05).to(p.device))
    tokens = torch.randint(0, 1000, (2, 100), generator=g).to(cuda_device)
    k1, k5 = mlstm_chunkwise_fwd.launches, slstm_scan_fwd.launches
    with torch.no_grad():
        got = model(tokens)
    assert (mlstm_chunkwise_fwd.launches, slstm_scan_fwd.launches) == (k1 + 2, k5 + 1)
    vil_mod.mlstm_chunkwise_fwd, lm_mod.slstm_scan_fwd = mlstm_chunkwise_fwd_plain, slstm_scan
    try:
        with torch.no_grad():
            want = model(tokens)
    finally:
        vil_mod.mlstm_chunkwise_fwd, lm_mod.slstm_scan_fwd = mlstm_chunkwise_fwd, slstm_scan_fwd
    assert _rel(got, want) <= TOL_REL
    out = generate(model, tokens[:, :20], max_new_tokens=3)
    assert out.shape == (2, 23) and bool((out[:, :20] == tokens[:, :20]).all())


def _block_args(B, S, DIM, NH, device, seed, DH=64):
    """The block function's 19 arguments, cut from seeded layer arguments:
    conv_act, x_mlstm, z, x_res, then the cell's and the tail's."""
    a = _layer_args(B, S, DIM, NH, device, seed, DH)
    rng = np.random.default_rng(seed + 1)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    return [a[1], mk(B, S, NH * DH), mk(B, S, NH * DH), a[0], *a[5:]]


FAMILY = {"cell": (vil_cell_fwd, vil_cell_plain, 12), "block": (vil_block_fwd, vil_block_plain, 19)}
FAMILY_SHAPES = [(196, 192, 6, "exp"), (6400, 64, 2, "exp"), (77, 64, 2, "sigmoid"),
                 (64, 128, 4, "exp")]
FAMILY_IDS = ["classifier_ragged", "P3", "short_sigmoid", "one_chunk"]


def _family_args(which, B, S, DIM, NH, device, seed, DH=64):
    args = _block_args(B, S, DIM, NH, device, seed, DH)
    return args if which == "block" else [args[0], args[1], *args[4:14]]


@pytest.mark.parametrize("S,DIM,NH,igate_act", FAMILY_SHAPES, ids=FAMILY_IDS)
@pytest.mark.parametrize("which", ["cell", "block"])
def test_vil_cell_and_block_kernels_match_plain(cuda_device, which, S, DIM, NH, igate_act):
    """The classifier's shape (S 196, ragged, 6 heads), ViL-YOLO's P3, an S
    shorter than one chunk and exactly one chunk."""
    fwd, plain, n = FAMILY[which]
    args = _family_args(which, 2, S, DIM, NH, cuda_device, seed=S)
    assert len(args) == n
    before = fwd.launches
    got = fwd(*args, NH, chunk_size=128, igate_act=igate_act)
    want = plain(*args, NH, chunk_size=128, igate_act=igate_act)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL_REL


@pytest.mark.parametrize("which", ["cell", "block"])
def test_vil_cell_and_block_kernels_reject_bad_input(cuda_device, which):
    fwd = FAMILY[which][0]
    args = _family_args(which, 1, 64, 64, 2, cuda_device, seed=0)
    with pytest.raises(TypeError):
        fwd(args[0].double(), *args[1:], 2)
    with pytest.raises(ValueError):  # 4 heads over weights made for 2
        fwd(*args, 4)
    with pytest.raises(ValueError):  # an argument left on the CPU
        fwd(args[0], args[1].cpu(), *args[2:], 2)
    with pytest.raises(ValueError):
        fwd(*args, 2, igate_act="tanh")


@pytest.mark.parametrize("S,igate_act", [(196, "exp"), (77, "sigmoid")])
@pytest.mark.parametrize("which", ["cell", "block"])
def test_vil_cell_and_block_gradients_match_plain(cuda_device, which, S, igate_act):
    """With gradients needed: one forward launch, one chunkwise-backward
    launch in backward(); the gradients match the plain backward on the
    plain forward's activations."""
    fwd = FAMILY[which][0]
    args = _family_args(which, 2, S, 64, 2, cuda_device, seed=S + 2)
    leaves = [a.clone().requires_grad_() for a in args]
    f0, b0 = fwd.launches, mlstm_chunkwise_bwd.launches
    out = fwd(*leaves, 2, chunk_size=128, igate_act=igate_act)
    gout = torch.randn(out.shape, device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(S))
    (out * gout).sum().backward()
    torch.cuda.synchronize()
    assert (fwd.launches, mlstm_chunkwise_bwd.launches) == (f0 + 1, b0 + 1)
    cfg = Cfg(2, 128, igate_act)
    if which == "cell":
        _, acts = _cell_plain(*args, cfg)
        want = cell_bwd(args, acts, gout, cfg, mlstm_chunkwise_bwd_plain)
    else:
        _, acts = _block_plain(args, cfg)
        want = block_bwd(args, acts, gout, cfg, mlstm_chunkwise_bwd_plain)
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        assert _rel(leaf.grad, w) <= TOL_REL, i


def test_vil_family_agrees_three_ways(cuda_device):
    """On one set of arguments: the layer kernel, the block kernel behind
    RMSNorm and proj_up in torch, and the torch tail over the cell kernel's h."""
    from xlstm_yolo_torch.kernels.vil_block import tail_plain
    from xlstm_yolo_torch.kernels.vil_layer import _head

    NH = 6
    a = _layer_args(2, 196, 192, NH, cuda_device, seed=7)
    x, conv_act = a[:2]
    *_, x_mlstm, z = _head(x, *a[2:5], 1e-6)
    layer = vil_layer_fwd(*a, NH)
    block = vil_block_fwd(conv_act, x_mlstm, z, x, *a[5:], NH)
    h = vil_cell_fwd(conv_act, x_mlstm, *a[5:15], NH)
    tail = tail_plain(h, conv_act, z, x, *a[15:], Cfg(NH))
    assert _rel(block, layer) <= TOL_REL and _rel(tail, layer) <= TOL_REL
    assert _rel(tail, block) <= TOL_REL


def _classifier(device, **kw):
    from xlstm_yolo_torch.nn.vil import MatrixLSTMCell
    from xlstm_yolo_torch.nn.vil_extra import VisionLSTM2

    model = VisionLSTM2(dim=64, depth=3, patch_size=16, output_shape=(10,), qkv_block_size=64,
                        resolution=(96, 96), device=device, **kw)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MatrixLSTMCell):
                for lin in (m.igate, m.fgate):
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    return model


def test_vision_lstm2_train_step_launches_cell_kernel(cuda_device):
    """Depth 3 with the decayed schedule: block 0 (rate 0) takes the layer
    kernel, blocks 1 and 2 the cell kernel, every block one chunkwise
    backward; eval launches the layer kernel three times."""
    from xlstm_yolo_torch.utils.loss import classification_loss

    model = _classifier(cuda_device, drop_path_rate=0.5)
    x = torch.randn(4, 96, 96, 3, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    c0 = (vil_layer_fwd.launches, vil_cell_fwd.launches, mlstm_chunkwise_bwd.launches)
    with torch.no_grad():
        model(x)
    assert vil_layer_fwd.launches == c0[0] + 3 and vil_cell_fwd.launches == c0[1]
    model.train()
    c0 = (vil_layer_fwd.launches, vil_cell_fwd.launches, mlstm_chunkwise_bwd.launches)
    logits = model(x, generator=torch.Generator(cuda_device).manual_seed(9))
    classification_loss(logits, torch.tensor([0, 1, 2, 3], device=cuda_device)).backward()
    torch.cuda.synchronize()
    c1 = (vil_layer_fwd.launches, vil_cell_fwd.launches, mlstm_chunkwise_bwd.launches)
    assert tuple(b - a for a, b in zip(c0, c1)) == (1, 2, 3)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
    with pytest.raises(ValueError):
        model(x)  # train mode without a generator


def test_vil_layer_drop_path_on_card_leaves_dropped_rows_to_the_residual(cuda_device):
    """One layer under stochastic depth, through the cell kernel: a dropped
    sample's output is exactly its input and its input gradient exactly the
    output gradient; a kept sample's differ from both."""
    layer = _classifier(cuda_device, drop_path_rate=0.5).block2.fwd.layer.train()
    keep = 1.0 - layer.drop_path.rate
    for seed in range(32):  # the first seed that keeps one sample of four and drops another
        mask = torch.rand(4, generator=torch.Generator(cuda_device).manual_seed(seed),
                          device=cuda_device) < keep
        if mask.any() and not mask.all():
            break
    g = torch.Generator(cuda_device).manual_seed(3)
    x = torch.randn(4, 36, 64, device=cuda_device, generator=g).requires_grad_()
    gout = torch.randn(4, 36, 64, device=cuda_device, generator=g)
    c0 = (vil_cell_fwd.launches, mlstm_chunkwise_bwd.launches)
    out = layer(x, generator=torch.Generator(cuda_device).manual_seed(seed))
    (out * gout).sum().backward()
    torch.cuda.synchronize()
    assert (vil_cell_fwd.launches, mlstm_chunkwise_bwd.launches) == (c0[0] + 1, c0[1] + 1)
    assert torch.equal(out[~mask], x[~mask]) and torch.equal(x.grad[~mask], gout[~mask])
    kept_out = (out[mask] - x[mask]).abs().amax((1, 2))
    kept_grad = (x.grad[mask] - gout[mask]).abs().amax((1, 2))
    assert bool((kept_out > 0).all()) and bool((kept_grad > 0).all())


def _kth_rows(R, N, seed, device):
    """Rows as the assigner's metric has them (mostly zeros, no negatives)
    on even rows and normal draws on odd ones, with ties inside the top k on
    rows 0 and 1 and fewer than 10 distinct values on the last row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, N)).astype(np.float32)
    x[::2] = np.where(rng.random((len(x[::2]), N)) < 0.97, 0.0, np.abs(x[::2]))
    top = np.argsort(-x[:2], axis=1)
    for r in range(min(2, R)):
        x[r, top[r, 1:4]] = x[r, top[r, 0]]  # the four largest tie
        x[r, top[r, 6]] = x[r, top[r, 5]]
    x[-1] = rng.integers(0, 4, N).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("R,N,k", [(7, 300, 10), (16, 131, 3), (256, 8400, 10), (5, 8400, 1),
                                   (9, 1000, 16), (3, 7, 10)])
def test_rowwise_kth_value_kernel_is_exact(cuda_device, R, N, k):
    """K8 selects, it does not round: equal to the suppress chain bit for
    bit, ties inside the top k, N no multiple of 4 or 32, a row with fewer
    than k distinct values (-1e30) and N < k included."""
    x = _kth_rows(R, N, seed=R + N + k, device=cuda_device)
    before = rowwise_kth_value.launches
    got = rowwise_kth_value(x, k)
    want = rowwise_kth_value_plain(x, k)
    torch.cuda.synchronize()
    assert rowwise_kth_value.launches == before + 1
    assert got.shape == (R, 1) and got.dtype == torch.float32
    assert torch.equal(got, want)
    if k > 4:
        assert float(got[-1]) == float(np.float32(NEG_INF))


@pytest.mark.parametrize("R,N,k,rows", [
    (1, 8400, 3, "assigner"), (1000, 8400, 10, "assigner"), (300, 300, 16, "assigner"),
    (256, 8401, 10, "assigner"), (256, 8400, 10, "unaligned"), (1000, 8401, 3, "unaligned"),
    (256, 8400, 10, "zeros"), (3, 8400, 1, "zeros"), (256, 8400, 10, "bf16"),
    (1, 300, 16, "bf16")])
def test_rowwise_kth_value_kernel_new_shapes(cuda_device, R, N, k, rows):
    """K8 on one row and on 1000, on both sides of the R that picks its CTA
    size (512 threads up to 512 rows, 128 above), at N 300 and a ragged N
    8401, on rows that start one element past a 16-byte boundary (a view of
    one flat buffer), on all-zero rows (one distinct value: -1e30 unless k
    is 1) and on bf16 input: equal to the suppress chain bit for bit."""
    x = _kth_rows(R, N, seed=R + N + k, device=cuda_device)
    if rows == "unaligned":
        flat = torch.zeros(R * N + 1, device=cuda_device)
        flat[1:] = x.flatten()
        x = flat[1:].view(R, N)
        assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    elif rows == "zeros":
        x = torch.zeros_like(x)
    elif rows == "bf16":
        x = x.bfloat16()
    before = rowwise_kth_value.launches
    got = rowwise_kth_value(x, k)
    want = rowwise_kth_value_plain(x, k)
    torch.cuda.synchronize()
    assert rowwise_kth_value.launches == before + 1
    assert got.shape == (R, 1) and got.dtype == torch.float32
    assert torch.equal(got, want)
    if rows == "zeros":
        assert float(got.max()) == (0.0 if k == 1 else float(np.float32(NEG_INF)))


def test_rowwise_kth_value_kernel_casts_and_refuses(cuda_device):
    x = _kth_rows(8, 515, seed=0, device=cuda_device)
    for dtype in (torch.bfloat16, torch.float16):
        assert torch.equal(rowwise_kth_value(x.to(dtype), 5),
                           rowwise_kth_value_plain(x.to(dtype), 5))
    assert torch.equal(rowwise_kth_value(x[:, ::2], 3), rowwise_kth_value_plain(x[:, ::2], 3))
    for bad_k in (0, 17):
        with pytest.raises(ValueError):
            rowwise_kth_value(x, bad_k)
    with pytest.raises(TypeError):
        rowwise_kth_value(x.double(), 3)
    with pytest.raises(ValueError):
        rowwise_kth_value(x[0], 3)


def _conv_args(B, H, W, DIM, NH, device, seed, DH=64):
    """The conv-fused layer's 21 arguments from seeded layer arguments: x,
    the norm and proj_up, a seeded depthwise kernel and bias, the rest."""
    a = _layer_args(B, H * W, DIM, NH, device, seed, DH)
    rng = np.random.default_rng(seed + 5)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    return [a[0], *a[2:5], mk(NH * DH, 1, 3, 3) * 0.3, mk(NH * DH) * 0.1, *a[5:]]


@pytest.mark.parametrize("H,W,DIM,NH,igate_act", [
    (80, 80, 64, 2, "exp"), (40, 40, 128, 4, "exp"), (20, 20, 256, 8, "exp"),
    (14, 14, 192, 6, "exp"), (5, 9, 64, 2, "sigmoid"), (1, 70, 64, 2, "exp"),
    (6, 7, 70, 2, "exp")],
    ids=["P3", "P4", "P5", "classifier_ragged", "short_sigmoid", "one_row", "odd_dim"])
def test_vil_conv_kernel_matches_plain_and_layer_kernel(cuda_device, H, W, DIM, NH, igate_act):
    """K6 against its plain version, and against the library conv feeding
    the layer kernel on the same arguments."""
    import torch.nn.functional as F
    from xlstm_yolo_torch.kernels.vil_conv import _conv_pre
    from xlstm_yolo_torch.kernels.vil_layer import _head

    args = _conv_args(2, H, W, DIM, NH, cuda_device, seed=H * W)
    before = vil_layer_conv_fwd.launches, vil_layer_fwd.launches
    got = vil_layer_conv_fwd(*args, NH, (H, W), chunk_size=128, igate_act=igate_act)
    assert (vil_layer_conv_fwd.launches, vil_layer_fwd.launches) == (before[0] + 1, before[1])
    want = vil_layer_conv_plain(*args, NH, (H, W), chunk_size=128, igate_act=igate_act)
    *_, x_mlstm, _ = _head(args[0], *args[1:4], 1e-6)
    conv_act = F.silu(_conv_pre(x_mlstm, args[4], args[5], (H, W)))
    by_layer = vil_layer_fwd(args[0], conv_act, *args[1:4], *args[6:], NH, igate_act=igate_act)
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL_REL
    assert _rel(got, by_layer) <= TOL_REL


def test_vil_conv_kernel_rejects_bad_input(cuda_device):
    args = _conv_args(1, 8, 8, 64, 2, cuda_device, seed=0)
    with pytest.raises(TypeError):
        vil_layer_conv_fwd(args[0].double(), *args[1:], 2, (8, 8))
    with pytest.raises(ValueError):  # 4 heads over weights made for 2
        vil_layer_conv_fwd(*args, 4, (8, 8))
    with pytest.raises(ValueError):  # no grid of 64 tokens
        vil_layer_conv_fwd(*args, 2, (8, 9))
    with pytest.raises(ValueError):  # an argument left on the CPU
        vil_layer_conv_fwd(*args[:4], args[4].cpu(), *args[5:], 2, (8, 8))


@pytest.mark.parametrize("H,W,igate_act", [(14, 14, "exp"), (7, 11, "sigmoid")])
def test_vil_conv_gradients_match_plain(cuda_device, H, W, igate_act):
    """With gradients needed: one forward launch, one chunkwise-backward
    launch in backward(); the 21 gradients match the plain backward on the
    plain forward's activations."""
    args = _conv_args(2, H, W, 64, 2, cuda_device, seed=H + W)
    leaves = [a.clone().requires_grad_() for a in args]
    f0, b0 = vil_layer_conv_fwd.launches, mlstm_chunkwise_bwd.launches
    out = vil_layer_conv_fwd(*leaves, 2, (H, W), chunk_size=128, igate_act=igate_act)
    gout = torch.randn(out.shape, device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(H))
    (out * gout).sum().backward()
    torch.cuda.synchronize()
    assert (vil_layer_conv_fwd.launches, mlstm_chunkwise_bwd.launches) == (f0 + 1, b0 + 1)
    cfg = Cfg(2, 128, igate_act, seqlens=(H, W))
    _, acts = _conv_plain(args, cfg)
    want = conv_layer_bwd(args, acts, gout, cfg, mlstm_chunkwise_bwd_plain)
    assert len(want) == len(leaves) == 21
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        assert _rel(leaf.grad, w) <= TOL_REL, i


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_vil_layer_forward_conv_fused_on_card(cuda_device, direction):
    """``ViLLayer.forward_conv_fused`` with the layer's own weights equals
    ``ViLLayer.forward`` (library conv + the layer kernel), output and
    gradients, in both directions."""
    from xlstm_yolo_torch.nn.modules import init_tree
    from xlstm_yolo_torch.nn.vil import ViLLayer

    layer = ViLLayer(64, direction=direction, qkv_block_size=64, seqlens=(9, 13))
    init_tree(layer, 0)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for lin in (layer.mlstm_cell.igate, layer.mlstm_cell.fgate):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
        layer.conv.conv.bias.copy_(torch.randn(128, generator=g) * 0.1)
    layer.to(cuda_device)
    x = torch.randn(2, 117, 64, generator=g).to(cuda_device)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    want = layer(xa)
    want.square().sum().backward()
    grads = {n: p.grad.clone() for n, p in layer.named_parameters()}
    layer.zero_grad()
    before = vil_layer_conv_fwd.launches
    got = layer.forward_conv_fused(xb)
    got.square().sum().backward()
    torch.cuda.synchronize()
    assert vil_layer_conv_fwd.launches == before + 1
    assert _rel(got, want) <= TOL_REL and _rel(xb.grad, xa.grad) <= TOL_REL
    for n, p in layer.named_parameters():
        assert _rel(p.grad, grads[n]) <= TOL_REL, n


def _tile_lib():
    import ctypes

    from xlstm_yolo_torch.kernels._build import CudaLibrary

    P, I = ctypes.c_void_p, ctypes.c_int
    return CudaLibrary("tile_mma_test.cu", {
        "tile_mma_test_f32": (I, [P, P, P, I, I, I, P]),
        "tile_mma_error_string": (ctypes.c_char_p, [I])}).load()


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["AB", "AtB", "ABt", "AtBt"])
@pytest.mark.parametrize("K", [64, 192])
def test_tile_product_is_fp32_accurate(cuda_device, K, ta, tb):
    """The shared 3xTF32 tile product (csrc/tile_mma.cuh) through its C
    entry: C (64 x 64) = op(A) op(B) against an fp64 product, with TF32 off
    in torch; 1e-5 of the output's max, where one TF32 pass keeps about
    three digits."""
    lib = _tile_lib()
    g = torch.Generator(cuda_device).manual_seed(K + 2 * ta + tb)
    a = torch.randn((K, 64) if ta else (64, K), device=cuda_device, generator=g)
    b = torch.randn((64, K) if tb else (K, 64), device=cuda_device, generator=g)
    c = torch.empty(64, 64, device=cuda_device)
    err = lib.tile_mma_test_f32(a.data_ptr(), b.data_ptr(), c.data_ptr(), K, int(ta), int(tb),
                                torch.cuda.current_stream(cuda_device).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0, lib.tile_mma_error_string(err)
    want = (a.double().t() if ta else a.double()) @ (b.double().t() if tb else b.double())
    assert ((c.double() - want).abs().max() / want.abs().max()).item() <= 1e-5


# scale x's P5 at 640 px (20 x 20 tokens, DIM 640, INNER 1280, 20 heads), and a
# ragged S at the same widths (a 10 x 23 grid)
WIDE_SHAPES = [(20, 20), (10, 23)]


@pytest.mark.parametrize("H,W", WIDE_SHAPES, ids=["x_P5", "x_ragged"])
@pytest.mark.parametrize("which", ["layer", "cell", "block", "conv", "bwd"])
def test_vil_kernels_at_scale_x_width_match_plain(cuda_device, which, H, W):
    """K3, K4, K7, K6 and K2 at the widest ViL stage of the flagship YAML."""
    S, DIM, NH = H * W, 640, 20
    if which == "layer":
        args = _layer_args(2, S, DIM, NH, cuda_device, seed=S)
        fwd, got = vil_layer_fwd, lambda: vil_layer_fwd(*args, NH, chunk_size=128)
        want = (vil_layer_ref(*args, NH, chunk_size=128),)
    elif which in FAMILY:
        fwd, plain, _ = FAMILY[which]
        args = _family_args(which, 2, S, DIM, NH, cuda_device, seed=S)
        got = lambda: fwd(*args, NH, chunk_size=128)
        want = (plain(*args, NH, chunk_size=128),)
    elif which == "conv":
        args = _conv_args(2, H, W, DIM, NH, cuda_device, seed=S)
        fwd, got = vil_layer_conv_fwd, lambda: vil_layer_conv_fwd(*args, NH, (H, W))
        want = (vil_layer_conv_plain(*args, NH, (H, W)),)
    else:
        q, k, v, i, f, dh = _cell_args(2, S, NH, cuda_device, seed=S)
        heads = lambda t: t.reshape(2, S, NH, 64).transpose(1, 2)
        carry = chunk_carry_states(heads(k), heads(v), i, f, 64)
        fwd = mlstm_chunkwise_bwd
        got = lambda: mlstm_chunkwise_bwd(q, k, v, i, f, dh, NH, carry=carry)
        want = mlstm_chunkwise_bwd_plain(q, k, v, i, f, dh, NH)
    before = fwd.launches
    out = got()
    out = out if isinstance(out, tuple) else (out,)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    for n, (g_, w) in enumerate(zip(out, want)):
        assert g_.shape == w.shape and bool(torch.isfinite(g_).all()), n
        assert _rel(g_, w) <= TOL_REL, n


# ---- bf16: the TPU kernels' default arithmetic (bf16 operands, fp32 accumulation)

# bf16 outputs against the plain version's fp32 values: relative L2 of the two
# rounded to bf16 (1e-3 forward, 3e-3 gradients) and the largest error beyond
# the bf16 rounding (5e-3 of the max for a kernel's own outputs, 1e-2 for the
# layer's gradients, which pass through more bf16 sums). A max alone is no
# gate: two bf16 pipelines that sum in other orders round some intermediates
# the other way; the plain layer against itself on inputs one fp32 ulp apart
# is 3.0e-3 of the max beyond rounding at P3 (NVIDIA H100 80GB HBM3, 700 W).
TOL_BF16_FWD, TOL_BF16_GRAD = 1e-3, 3e-3
MAX_EXCESS, MAX_EXCESS_GRAD = 5e-3, 1e-2


def _bf16_ulp(t):
    """One bf16 unit in the last place at each |t|: 2^(e - 8) for |t| in
    [2^(e-1), 2^e) (8 significant bits)."""
    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _rel_bf16(got, want32):
    """(relative L2 error, largest error beyond half a bf16 ulp over the max)
    of a bf16 output against the plain version's fp32 value before that
    rounding; an fp32 output against it plainly."""
    g, w = got.float(), want32.float()
    if got.dtype != torch.bfloat16:
        return ((g - w).norm() / w.norm()).item(), _rel(g, w)
    excess = ((g - w).abs() - 0.5 * _bf16_ulp(torch.maximum(g.abs(), w.abs()))).clamp(min=0)
    return (((g - w.bfloat16().float()).norm() / w.norm()).item(),
            (excess.max() / w.abs().max()).item())


# the bf16 tile layer's causal modes (tile::Causal; the triangular k ranges are
# single-tile modes, at K 64)
TILE_MODES = {"full": 0, "out_lower": 1, "k_le_m": 2, "k_ge_m": 3}


def _tile16_reference(a, b, K, ta, tb, sa, mode, nlim):
    """fp64 product of the operands as the bf16 tile layer reads them (op(A)
    scaled by row, then rounded to bf16; op(B) rounded), with the tile
    layer's causal skips applied at its 16 x 8 fragment granularity."""
    opa = (a.t() if ta else a).float()
    if sa is not None:
        opa = opa * sa[:, None]
    opa = opa.bfloat16().double()
    opb = (b.t() if tb else b).bfloat16().double()
    m = torch.arange(64, device=a.device)
    m0 = (m // 16) * 16  # the first row of the warp that owns row m
    if mode == "k_le_m":  # the k loop runs to the warp's last row
        opa = opa * (torch.arange(K, device=a.device)[None, :] < (m0 + 16)[:, None])
    if mode == "k_ge_m":  # and from its first
        opa = opa * (torch.arange(K, device=a.device)[None, :] >= m0[:, None])
    want = opa @ opb
    nb = (m // 8) * 8  # the first column of the 8-column fragment of column n
    keep = nb[None, :] < nlim
    if mode == "out_lower":  # fragments wholly above the warp's rows are skipped
        keep = keep & (nb[None, :] <= (m0 + 15)[:, None])
    return want * keep


@pytest.mark.parametrize("K,mode,nlim", [
    (64, "full", 64), (192, "full", 64), (64, "full", 24), (192, "full", 24),
    (64, "out_lower", 64), (192, "out_lower", 64), (64, "k_le_m", 64), (64, "k_ge_m", 64),
], ids=lambda v: str(v))
@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "prescaled"])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["AB", "AtB", "ABt", "AtBt"])
def test_tile_product_bf16_is_exact_on_rounded_operands(cuda_device, K, ta, tb, scaled, mode,
                                                         nlim):
    """The bf16 tile layer (csrc/tile_bf16.cuh: bf16 tiles in shared memory,
    ldmatrix, .trans for a k-major tile, m16n8k16 with fp32 accumulators)
    against an fp64 product of the same bf16 operands, in each transpose
    mode, with op(A) scaled by row before its rounding (the kernels'
    pre-scaled operands) or not, in each causal mode and with a column
    limit: 1e-5 of the output's max (the products are exact, the fp32 sums
    round), which also shows the fragment layouts right: a wrong pairing of
    k indices or a wrong transpose is off by O(1)."""
    lib = _tile_lib_bf16()
    g = torch.Generator(cuda_device).manual_seed(K + 2 * ta + tb + 100)
    a = torch.randn((K, 64) if ta else (64, K), device=cuda_device, generator=g)
    b = torch.randn((64, K) if tb else (K, 64), device=cuda_device, generator=g)
    sa = torch.rand(64, device=cuda_device, generator=g) * 3 + 0.1 if scaled else None
    c = torch.empty(64, 64, device=cuda_device)
    err = lib.tile_mma_test_bf16(a.data_ptr(), b.data_ptr(), c.data_ptr(), K, int(ta), int(tb),
                                 None if sa is None else sa.data_ptr(), TILE_MODES[mode], nlim,
                                 torch.cuda.current_stream(cuda_device).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0, lib.tile_mma_error_string(err)
    want = _tile16_reference(a, b, K, ta, tb, sa, mode, nlim)
    assert ((c.double() - want).abs().max() / want.abs().max()).item() <= 1e-5


def _tile_lib_bf16():
    import ctypes

    from xlstm_yolo_torch.kernels._build import CudaLibrary

    P, I = ctypes.c_void_p, ctypes.c_int
    return CudaLibrary("tile_mma_test.cu", {
        "tile_mma_test_bf16": (I, [P, P, P, I, I, I, P, I, I, P]),
        "tile_mma_error_string": (ctypes.c_char_p, [I])}).load()


def _nudged(t, toward=float("inf")):
    """fp32 values one ulp up (or toward ``toward``; bf16 ones as they are):
    the plain version on these gives its own rounding noise."""
    if t.dtype != torch.float32:
        return t
    return torch.nextafter(t, torch.full_like(t, toward))


def _bf16_layer_args(B, S, DIM, NH, device, seed, DH=64):
    args = _layer_args(B, S, DIM, NH, device, seed, DH)
    return [args[0].bfloat16(), args[1].bfloat16(), *args[2:]]


@pytest.mark.parametrize("S,DIM,NH", [(6400, 64, 2), (1600, 128, 4), (400, 256, 8), (77, 64, 2)],
                         ids=["P3", "P4", "P5", "short"])
def test_vil_layer_bf16_kernel_matches_plain(cuda_device, S, DIM, NH):
    """K3 in bf16 (vil_layer_fwd_bf16) at the ViL-YOLO-n stages and an S
    shorter than a chunk against its plain bf16 version (the same rounding
    points, at the kernel's chunk 64): ``_rel_bf16`` within TOL_BF16_FWD and
    MAX_EXCESS. A bf16 call launches the bf16 kernel and never the fp32
    one."""
    args = _bf16_layer_args(2, S, DIM, NH, cuda_device, seed=S + 5)
    before = (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16)
    got = vil_layer_fwd(*args, NH)
    want = vil_layer_ref(*args, NH, chunk_size=64, keep_fp32=True)
    torch.cuda.synchronize()
    assert (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16) == (before[0], before[1] + 1)
    assert got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    rel_l2, excess = _rel_bf16(got, want)
    assert rel_l2 <= TOL_BF16_FWD and excess <= MAX_EXCESS, (rel_l2, excess)


@pytest.mark.parametrize("S,DIM,NH", [(1600, 128, 4), (200, 64, 2)], ids=["P4", "ragged"])
def test_vil_layer_bf16_grads_match_plain(cuda_device, S, DIM, NH):
    """The bf16 layer under grad: K3 in bf16 (saving q, k, v, h in bf16),
    then K2 in bf16 inside the hand backward, against the plain bf16
    forward and backward on the same arguments (the plain K2 recomputes
    the same state from the bf16 k and v, the kernel reads the forward's):
    every gradient within ``_rel_bf16``'s TOL_BF16_GRAD and MAX_EXCESS_GRAD,
    or within twice the plain version's own distance to itself on weights
    one fp32 ulp apart where that is larger (the gate biases' gradients are
    sums of 2 x S terms that cancel, and vary with the last bit of any
    weight); those of x and conv_act in bf16. Only the bf16 kernels
    launch. The output gradient comes from a generator of its own, seeded
    as the arguments are, so the draw does not depend on the tests before
    it (tools/bf16_grad_spread.py measures the spread over draws)."""
    _check_bf16_layer_grads(cuda_device, S, DIM, NH, seed=S + 9)


def _check_bf16_layer_grads(device, S, DIM, NH, seed, nudges=(float("inf"),), DH=64, B=2):
    """``test_vil_layer_bf16_grads_match_plain``'s check; the noise floor is
    the plain version's largest distance to itself over ``nudges`` (the
    directions of the one-ulp nudge)."""
    args = _bf16_layer_args(B, S, DIM, NH, device, seed=seed, DH=DH)
    leaves = [a.clone().requires_grad_() for a in args]
    g = torch.Generator(device).manual_seed(seed)
    gout = torch.randn(B, S, DIM, device=device, generator=g).bfloat16()
    counts = lambda: (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16,
                      mlstm_chunkwise_bwd.launches, mlstm_chunkwise_bwd.launches_bf16)
    before = counts()
    out = vil_layer_fwd(*leaves, NH)
    (out.float() * gout.float()).sum().backward()
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1] + 1, before[2], before[3] + 1)
    _, acts = _layer_plain(args, Cfg(NH, 64))
    want = vil_layer_bwd_ref(args, acts, gout, NH, chunk_size=64)
    noises = []
    for toward in nudges:
        nudged = [_nudged(a, toward) for a in args]
        _, acts_n = _layer_plain(nudged, Cfg(NH, 64))
        noises.append(vil_layer_bwd_ref(nudged, acts_n, gout, NH, chunk_size=64))
    assert leaves[0].grad.dtype == leaves[1].grad.dtype == torch.bfloat16
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        rel_l2, excess = _rel_bf16(leaf.grad, w)
        floors = [_rel_bf16(noise[i].to(leaf.grad.dtype), w) for noise in noises]
        floor_l2, floor_max = max(f[0] for f in floors), max(f[1] for f in floors)
        assert rel_l2 <= max(TOL_BF16_GRAD, 2 * floor_l2), (i, rel_l2, floor_l2)
        assert excess <= max(MAX_EXCESS_GRAD, 2 * floor_max), (i, excess, floor_max)


@pytest.mark.parametrize("S", [256, 400])
def test_mlstm_bwd_bf16_kernel_matches_plain(cuda_device, S):
    """K2 in bf16 (mlstm_bwd_bf16) on bf16 q/k/v and the carry states the
    bf16 layer kernel leaves, against its plain bf16 version: dq/dk/dv come
    back bf16, each gradient within ``_rel_bf16``'s TOL_BF16_GRAD and
    MAX_EXCESS; the fp32 entry does not launch."""
    from xlstm_yolo_torch.kernels.vil_layer import _launch

    NH = 2
    args = _bf16_layer_args(2, S, 64, NH, cuda_device, seed=S + 13)
    _, (_, q, k, v, ig, fg), carry = _launch(args, Cfg(NH), True)
    dh = torch.randn(2, S, NH * 64, device=cuda_device)
    before = (mlstm_chunkwise_bwd.launches, mlstm_chunkwise_bwd.launches_bf16)
    got = mlstm_chunkwise_bwd(q, k, v, ig, fg, dh, NH, carry=carry)
    want = mlstm_chunkwise_bwd_plain(q, k, v, ig, fg, dh, NH, keep_fp32=True)
    torch.cuda.synchronize()
    assert (mlstm_chunkwise_bwd.launches, mlstm_chunkwise_bwd.launches_bf16) == \
        (before[0], before[1] + 1)
    assert [g.dtype for g in got[:3]] == [torch.bfloat16] * 3
    for name, g_, w in zip(("dq", "dk", "dv", "di", "df"), got, want):
        assert bool(torch.isfinite(g_).all()), name
        rel_l2, excess = _rel_bf16(g_, w)
        assert rel_l2 <= TOL_BF16_GRAD and excess <= MAX_EXCESS, (name, rel_l2, excess)


@pytest.mark.parametrize("H,W", WIDE_SHAPES, ids=["x_P5", "x_ragged"])
@pytest.mark.parametrize("which", ["layer", "bwd", "grads"])
def test_bf16_kernels_at_scale_x_width_match_plain(cuda_device, which, H, W):
    """K3 and K2 in bf16 at the widest ViL stage of the flagship YAML (DIM
    640, INNER 1280, 20 heads): the forward, K2 on what the forward saves,
    and the layer's gradients, each held as at ViL-YOLO-n's widths. Every
    stage's shared memory is fixed by its tiles, so the width changes only
    the grids and the K loops. At these widths one nudge's noise floor
    scatters as much as the kernels' own distance (x's gradient over 10
    draws at x_ragged, tools/bf16_grad_spread.py: 0.022-0.062 against
    0.018-0.054): the gradients' floor is the larger of the nudges up and
    down."""
    S, DIM, NH = H * W, 640, 20
    if which == "grads":
        _check_bf16_layer_grads(cuda_device, S, DIM, NH, seed=S + 9,
                                nudges=(float("inf"), float("-inf")))
        return
    args = _bf16_layer_args(2, S, DIM, NH, cuda_device, seed=S + 5)
    if which == "layer":
        before = vil_layer_fwd.launches_bf16
        got = (vil_layer_fwd(*args, NH),)
        want = (vil_layer_ref(*args, NH, chunk_size=64, keep_fp32=True),)
        fwd, tol, tol_max = vil_layer_fwd, TOL_BF16_FWD, MAX_EXCESS
    else:
        from xlstm_yolo_torch.kernels.vil_layer import _launch

        _, (_, q, k, v, ig, fg), carry = _launch(args, Cfg(NH), True)
        dh = torch.randn(2, S, NH * 64, device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(S))
        before = mlstm_chunkwise_bwd.launches_bf16
        got = mlstm_chunkwise_bwd(q, k, v, ig, fg, dh, NH, carry=carry)
        want = mlstm_chunkwise_bwd_plain(q, k, v, ig, fg, dh, NH, keep_fp32=True)
        fwd, tol, tol_max = mlstm_chunkwise_bwd, TOL_BF16_GRAD, MAX_EXCESS
    torch.cuda.synchronize()
    assert fwd.launches_bf16 == before + 1
    for n, (g_, w) in enumerate(zip(got, want)):
        assert g_.shape == w.shape and bool(torch.isfinite(g_).all()), n
        rel_l2, excess = _rel_bf16(g_, w)
        assert rel_l2 <= tol and excess <= tol_max, (n, rel_l2, excess)


def test_bf16_kernels_refuse_what_they_do_not_take(cuda_device):
    """No quiet upcast: the cell and block functions have no bf16 kernel yet
    and raise on bf16 activations on the card; K2 in bf16 takes head dim 64
    only."""
    args = _bf16_layer_args(1, 64, 64, 2, cuda_device, seed=3)
    conv_act = args[1]
    with pytest.raises(TypeError, match="no CUDA kernel"):
        vil_cell_fwd(conv_act, conv_act, *args[5:15], 2)
    q = torch.zeros(1, 64, 128, device=cuda_device, dtype=torch.bfloat16)
    g = torch.zeros(1, 1, 64, device=cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        mlstm_chunkwise_bwd(q, q, q, g, g, q.float(), 1, carry=None)


def _plain_vil():
    """The ViL layer, cell and block functions with their plain versions
    forced in on the card (``chip_smoke.plain_vil_kernels``)."""
    from unittest import mock

    import xlstm_yolo_torch.kernels.vil_cell as vc

    return mock.patch.object(vc, "_on_card", lambda t: False)


def test_trainer_epoch_on_card_matches_plain(cuda_device, tmp_path):
    """One epoch of ``Trainer.train`` (vil_yolon, 16 PNGs of 320 x 240 at
    320 px, batch 8, the defaults: bf16 AMP, mosaic, HSV, flip), then its
    validation: 3 bf16 layer and 3 bf16 backward launches a step, 3 fp32
    layer launches a validation batch; the CSV's losses within 1e-2
    (relative; no optimizer step is taken in 2 steps at accumulation 8, so
    both steps see the initial weights through bf16 pipelines that round
    in other orders) and its metrics within 1e-3 of the same run with the
    plain versions forced in."""
    import csv

    from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset
    from xlstm_yolo_torch.engine.trainer import Trainer
    from xlstm_yolo_torch.nn.tasks import TaskModel

    data = make_synthetic_dataset(tmp_path / "ds", n_train=16, n_val=8, width=320, height=240)
    rows = {}
    for kind in ("kernels", "plain"):
        before = (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16,
                  mlstm_chunkwise_bwd.launches_bf16)
        tr = Trainer(TaskModel("vil_yolon.yaml", nc=3, device="cuda"),
                     overrides={"data": data, "epochs": 1, "batch": 8, "imgsz": 320,
                                "close_mosaic": 0, "project": str(tmp_path), "name": kind})
        with _plain_vil() if kind == "plain" else nullcontext():
            tr.train()
        torch.cuda.synchronize()
        launches = (vil_layer_fwd.launches - before[0], vil_layer_fwd.launches_bf16 - before[1],
                    mlstm_chunkwise_bwd.launches_bf16 - before[2])
        assert launches == ((3, 6, 6) if kind == "kernels" else (0, 0, 0)), (kind, launches)
        with open(tmp_path / kind / "results.csv") as f:
            rows[kind] = list(csv.DictReader(f))[0]
    got, want = rows["kernels"], rows["plain"]
    for k in want:
        if k.startswith("train/"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-2 * abs(float(want[k])), k
        elif k.startswith("metrics/") and not k.endswith("img_s"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-3, k


def test_validator_on_card_matches_plain(cuda_device, tmp_path):
    """``Validator`` at 320 px with the kernels and with the plain versions
    forced in, on a model whose detections are not degenerate
    (``chip_smoke.shaped_detector``) over 16 PNGs labelled with its own
    jittered detections (320 label slots an image): mAP50 and mAP50-95 within 1e-3, mAP50-95 in
    [0.2, 0.95]; 3 fp32 layer launches a batch of 8."""
    from chip_smoke import shaped_detector, write_own_labels

    from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset
    from xlstm_yolo_torch.engine.validator import Validator

    data = make_synthetic_dataset(tmp_path / "ds", n_train=1, n_val=16, width=320, height=240)
    model = shaped_detector("cuda")
    write_own_labels(model, data, imgsz=320)
    out = {}
    for kind in ("kernels", "plain"):
        before = vil_layer_fwd.launches
        with _plain_vil() if kind == "plain" else nullcontext():
            out[kind] = Validator(model, imgsz=320, batch=8, max_labels=320)(data)
        assert vil_layer_fwd.launches - before == (6 if kind == "kernels" else 0)
    for k in ("mAP50", "mAP50-95"):
        assert abs(out["kernels"][k] - out["plain"][k]) <= 1e-3, (k, out)
    assert 0.2 <= out["kernels"]["mAP50-95"] <= 0.95, out


def _aug_batch(B, S, M, seed, device="cpu"):
    """Seeded uint8 images and 1 to 3 boxes an image of 20 px to S/3 a side."""
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8))
    cb = torch.zeros(B, M, 5)
    mask = torch.zeros(B, M, dtype=torch.bool)
    for b in range(B):
        for j in range(int(rng.integers(1, 4))):
            x1, y1 = rng.uniform(0, S * 2 / 3, 2)
            w, h = rng.uniform(20, S / 3, 2)
            cb[b, j] = torch.tensor([j, x1, y1, x1 + w, y1 + h])
            mask[b, j] = True
    return {"img": imgs.to(device), "cls_boxes": cb.to(device), "mask": mask.to(device)}


@pytest.mark.parametrize("mosaic,mosaic_p", [(1.0, 1.0), (0.5, 0.5), (0.5, 0.0), (0.0, 0.0)],
                         ids=["mosaic", "half", "closed", "no_mosaic"])
def test_device_augment_on_card_matches_cpu(cuda_device, mosaic, mosaic_p):
    """``device_augment.apply`` at batch 8 and 640 px on the card against
    the CPU, given the same draws (made on the card): images within 0.1 of
    255, boxes within 1e-3 px where the mask is set, masks equal (the CPU
    parity test's tolerances)."""
    from xlstm_yolo_torch.data import device_augment as DA

    b = _aug_batch(8, 640, 32, seed=3)
    hyp = DA.aug_hyp({"mosaic": mosaic, "degrees": 10.0, "shear": 5.0, "translate": 0.2})
    d = DA.draw(8, 640, hyp, mosaic_p, DA.step_generator(0, 1, cuda_device))
    assert d.fwd.device.type == d.mosaic.device.type == cuda_device.type
    card = DA.apply(b["img"].to(cuda_device), b["cls_boxes"].to(cuda_device),
                    b["mask"].to(cuda_device), d, hyp)
    cpu = DA.apply(b["img"], b["cls_boxes"], b["mask"], d.to("cpu"), hyp)
    img, cb, mk = (t.cpu() for t in card)
    assert img.shape == (8, 640, 640, 3) and torch.isfinite(img).all()
    assert torch.equal(mk, cpu[2]) and mk.any()
    assert (img - cpu[0]).abs().max().item() <= 0.1
    assert (cb - cpu[1])[mk].abs().max().item() <= 1e-3


def _step_launches():
    return (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16, mlstm_chunkwise_bwd.launches,
            mlstm_chunkwise_bwd.launches_bf16)


def test_train_step_with_device_augment_launches_as_without(cuda_device):
    """An AMP ``TrainStep`` of vil_yolon (batch 2, 320 px) launches 3 bf16
    layer and 3 bf16 backward kernels a step and no fp32 one, with the
    augmentation on the card and without it."""
    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.nn.tasks import TaskModel

    batch = _aug_batch(2, 320, 16, seed=4, device=cuda_device)
    for augment in (None, {"mosaic": 1.0}):
        step = TrainStep(TaskModel("vil_yolon.yaml", device=cuda_device), augment=augment)
        before = _step_launches()
        loss, _ = step(batch)
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        assert tuple(a - b for a, b in zip(_step_launches(), before)) == (0, 3, 0, 3), augment


@pytest.mark.parametrize("size", [320, 960])
def test_multi_scale_step_on_card(cuda_device, size):
    """A 640 px batch rescaled on the card to the extremes of
    ``multi_scale``'s bucket, then an AMP step with the augmentation: the
    images and boxes at the new size, a finite loss, 3 + 3 bf16 launches
    (the ViL stages at S 14400 / 3600 / 900 at 960 px, 1600 / 400 / 100 at
    320)."""
    from xlstm_yolo_torch.engine.trainer import TrainStep, ms_rescale
    from xlstm_yolo_torch.nn.tasks import TaskModel

    batch = _aug_batch(2, 640, 16, seed=5, device=cuda_device)
    scaled = ms_rescale(batch, size, 640)
    assert scaled["img"].shape == (2, size, size, 3) and scaled["img"].dtype == torch.float32
    torch.testing.assert_close(scaled["cls_boxes"][..., 1:],
                               batch["cls_boxes"][..., 1:] * size / 640)
    step = TrainStep(TaskModel("vil_yolon.yaml", device=cuda_device), augment={"mosaic": 1.0})
    before = _step_launches()
    loss, _ = step(scaled)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert tuple(a - b for a, b in zip(_step_launches(), before)) == (0, 3, 0, 3)


# ---- head dims below 64: the JAX package's ViL block defaults (16, and 4 in
# VisionLSTM2) and the two between. INNER 96 over 96 / DH heads: one whole
# 64-channel head group and a partial one, proj_up's 192 columns in three
# tiles; DIM 48 (rows not 64 wide). S 77 (ragged, B 2) and 64 (one full
# chunk, B 1); the conv-fused layer on a 7 x 11 and an 8 x 8 grid.

SMALL_DHS = [4, 8, 16, 32]
SMALL_S = [(77, 2, (7, 11)), (64, 1, (8, 8))]
SMALL_S_IDS = ["ragged", "one_chunk"]


def _small(which, B, S, grid, DH, device, seed):
    """(kernel, plain, arguments, trailing arguments) of one family member at
    head dim DH, INNER 96."""
    NH = 96 // DH
    if which == "layer":
        return vil_layer_fwd, vil_layer_ref, _layer_args(B, S, 48, NH, device, seed, DH), (NH,)
    if which == "conv":
        return (vil_layer_conv_fwd, vil_layer_conv_plain,
                _conv_args(B, *grid, 48, NH, device, seed, DH), (NH, grid))
    fwd, plain, _ = FAMILY[which]
    return fwd, plain, _family_args(which, B, S, 48, NH, device, seed, DH), (NH,)


@pytest.mark.parametrize("S,B,grid", SMALL_S, ids=SMALL_S_IDS)
@pytest.mark.parametrize("DH", SMALL_DHS)
@pytest.mark.parametrize("which", ["layer", "cell", "block", "conv"])
def test_vil_family_small_head_dims_match_plain(cuda_device, which, DH, S, B, grid):
    """K3, K4, K7 and K6 in fp32 at head dims 4 to 32 (the stages'
    instantiations at DH, the heads of a 64-channel group packed in the
    prologue) against their plain versions: one launch each, within
    TOL_REL."""
    fwd, plain, args, extra = _small(which, B, S, grid, DH, cuda_device, seed=DH + S)
    before = fwd.launches
    got = fwd(*args, *extra, chunk_size=64)
    want = plain(*args, *extra, chunk_size=64)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL_REL


@pytest.mark.parametrize("S,B,grid", SMALL_S, ids=SMALL_S_IDS)
@pytest.mark.parametrize("DH", SMALL_DHS)
@pytest.mark.parametrize("which", ["layer", "cell", "block", "conv"])
def test_vil_family_small_head_dims_grads_match_plain(cuda_device, which, DH, S, B, grid):
    """Under grad at head dims 4 to 32: one forward launch, and one launch
    of K2 in fp32 at the same head dim in backward(); every gradient within
    TOL_REL of the plain backward on the plain forward's activations."""
    from xlstm_yolo_torch.kernels.vil_layer import layer_bwd

    fwd, _, args, extra = _small(which, B, S, grid, DH, cuda_device, seed=DH + S + 1)
    NH = extra[0]
    leaves = [a.clone().requires_grad_() for a in args]
    f0, b0 = fwd.launches, mlstm_chunkwise_bwd.launches
    out = fwd(*leaves, *extra, chunk_size=64)
    gout = torch.randn(out.shape, device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(DH + S))
    (out * gout).sum().backward()
    torch.cuda.synchronize()
    assert (fwd.launches, mlstm_chunkwise_bwd.launches) == (f0 + 1, b0 + 1)
    plain_fwd, bwd = {"layer": (_layer_plain, layer_bwd), "cell": (_cell_plain, None),
                      "block": (_block_plain, block_bwd), "conv": (_conv_plain, conv_layer_bwd)}[which]
    cfg = Cfg(NH, 64, seqlens=grid if which == "conv" else None)
    if which == "cell":
        _, acts = _cell_plain(*args, cfg)
        want = cell_bwd(args, acts, gout, cfg, mlstm_chunkwise_bwd_plain)
    else:
        _, acts = plain_fwd(args, cfg)
        want = bwd(args, acts, gout, cfg, mlstm_chunkwise_bwd_plain)
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        assert _rel(leaf.grad, w) <= TOL_REL, i


@pytest.mark.parametrize("S,B", [(77, 2), (64, 1), (200, 2)], ids=["ragged", "one_chunk", "P5_like"])
@pytest.mark.parametrize("DH", SMALL_DHS)
def test_mlstm_bwd_small_head_dims_match_plain(cuda_device, DH, S, B):
    """K2 in fp32 at head dims 4 to 32 on the carry states of phase 1
    (``chunk_carry_states``): one launch, every gradient within TOL_REL."""
    NH = 96 // DH
    g = torch.Generator().manual_seed(DH + S)
    mk = lambda *s: torch.randn(*s, generator=g).to(cuda_device)
    q = mk(B, S, 96)
    k, v = q + 0.3 * mk(B, S, 96), mk(B, S, 96)
    i, f, dh = mk(B, NH, S) - 3.0, mk(B, NH, S) + 3.0, mk(B, S, 96)
    heads = lambda t: t.reshape(B, S, NH, DH).transpose(1, 2)
    carry = chunk_carry_states(heads(k), heads(v), i, f, 64)
    before = mlstm_chunkwise_bwd.launches
    got = mlstm_chunkwise_bwd(q, k, v, i, f, dh, NH, carry=carry)
    want = mlstm_chunkwise_bwd_plain(q, k, v, i, f, dh, NH)
    torch.cuda.synchronize()
    assert mlstm_chunkwise_bwd.launches == before + 1
    for name, g_, w in zip("qkvif", got, want):
        assert bool(torch.isfinite(g_).all()), name
        assert _rel(g_, w) <= TOL_REL, name


@pytest.mark.parametrize("S,B", [(77, 2), (64, 1)], ids=SMALL_S_IDS)
@pytest.mark.parametrize("DH", SMALL_DHS)
def test_vil_layer_bf16_small_head_dims_match_plain(cuda_device, DH, S, B):
    """K3 in bf16 at head dims 4 to 32 against its plain bf16 version, as
    ``test_vil_layer_bf16_kernel_matches_plain`` holds it at 64."""
    NH = 96 // DH
    args = _bf16_layer_args(B, S, 48, NH, cuda_device, seed=DH + S + 5, DH=DH)
    before = (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16)
    got = vil_layer_fwd(*args, NH)
    want = vil_layer_ref(*args, NH, chunk_size=64, keep_fp32=True)
    torch.cuda.synchronize()
    assert (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16) == (before[0], before[1] + 1)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    rel_l2, excess = _rel_bf16(got, want)
    assert rel_l2 <= TOL_BF16_FWD and excess <= MAX_EXCESS, (rel_l2, excess)


@pytest.mark.parametrize("S,B", [(77, 2), (64, 1)], ids=SMALL_S_IDS)
@pytest.mark.parametrize("DH", SMALL_DHS)
def test_vil_layer_bf16_small_head_dims_grads_match_plain(cuda_device, DH, S, B):
    """The bf16 layer under grad at head dims 4 to 32: K3 and K2 in bf16 at
    that head dim, every gradient held as
    ``test_vil_layer_bf16_grads_match_plain`` holds it at 64."""
    _check_bf16_layer_grads(cuda_device, S, 48, 96 // DH, seed=DH + S + 9, DH=DH, B=B)


@pytest.mark.parametrize("S,B", [(77, 2), (64, 1)], ids=SMALL_S_IDS)
@pytest.mark.parametrize("DH", SMALL_DHS)
def test_mlstm_bwd_bf16_small_head_dims_match_plain(cuda_device, DH, S, B):
    """K2 in bf16 at head dims 4 to 32 on the bf16 layer kernel's saved
    activations and carry states, as ``test_mlstm_bwd_bf16_kernel_matches_plain``
    holds it at 64."""
    from xlstm_yolo_torch.kernels.vil_layer import _launch

    NH = 96 // DH
    args = _bf16_layer_args(B, S, 48, NH, cuda_device, seed=DH + S + 13, DH=DH)
    _, (_, q, k, v, ig, fg), carry = _launch(args, Cfg(NH), True)
    dh = torch.randn(B, S, 96, device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(DH + S))
    before = (mlstm_chunkwise_bwd.launches, mlstm_chunkwise_bwd.launches_bf16)
    got = mlstm_chunkwise_bwd(q, k, v, ig, fg, dh, NH, carry=carry)
    want = mlstm_chunkwise_bwd_plain(q, k, v, ig, fg, dh, NH, keep_fp32=True)
    torch.cuda.synchronize()
    assert (mlstm_chunkwise_bwd.launches, mlstm_chunkwise_bwd.launches_bf16) == \
        (before[0], before[1] + 1)
    for name, g_, w in zip(("dq", "dk", "dv", "di", "df"), got, want):
        assert bool(torch.isfinite(g_).all()), name
        rel_l2, excess = _rel_bf16(g_, w)
        assert rel_l2 <= TOL_BF16_GRAD and excess <= MAX_EXCESS, (name, rel_l2, excess)


@pytest.mark.parametrize("DH", [12, 128])
def test_vil_kernels_refuse_other_head_dims(cuda_device, DH):
    """Head dim 12 (no instantiation) and 128 (K2 fp32 takes it for the
    language model, the ViL family does not) raise a clear ValueError on the
    card, with arguments made consistently at that head dim; nothing falls
    back to the plain version. K2 refuses 12 in fp32 and both in bf16."""
    NH = 2
    launches = lambda: (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16, vil_cell_fwd.launches,
                        vil_block_fwd.launches, vil_layer_conv_fwd.launches)
    before = launches()
    layer = _layer_args(1, 64, 48, NH, cuda_device, seed=DH, DH=DH)
    with pytest.raises(ValueError, match="head dim"):
        vil_layer_fwd(*layer, NH)
    with pytest.raises(ValueError, match="head dim"):
        vil_layer_fwd(*_bf16_layer_args(1, 64, 48, NH, cuda_device, seed=DH, DH=DH), NH)
    for which in ("cell", "block"):
        with pytest.raises(ValueError, match="head dim"):
            FAMILY[which][0](*_family_args(which, 1, 64, 48, NH, cuda_device, DH, DH), NH)
    with pytest.raises(ValueError, match="head dim"):
        vil_layer_conv_fwd(*_conv_args(1, 8, 8, 48, NH, cuda_device, DH, DH), NH, (8, 8))
    assert launches() == before
    INNER = NH * DH
    t = torch.zeros(1, 64, INNER, device=cuda_device, dtype=torch.bfloat16)
    gate = torch.zeros(1, NH, 64, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        mlstm_chunkwise_bwd(t, t, t, gate, gate, t.float(), NH, carry=None)
    if DH == 12:
        with pytest.raises(ValueError, match="head dim"):
            mlstm_chunkwise_bwd(t.float(), t.float(), t.float(), gate, gate, t.float(), NH,
                                carry=None)


# the outnorm's affine among each member's arguments: (scale, bias) positions
OUTNORM_AT = {"layer": 15, "layer_bf16": 15, "block": 14, "conv": 16}
# (S, DIM, NH, head dim, conv grid): ViL-YOLO-n's P3 at head dim 64, its P5 at 16
NO_OUTNORM_SHAPES = [(6400, 64, 2, 64, (80, 80)), (400, 256, 32, 16, (20, 20))]


def _without_outnorm(which, B, S, DIM, NH, DH, grid, device, seed):
    """(kernel, plain, arguments with the outnorm affine None, trailing
    arguments) of one member with the tail."""
    if which == "conv":
        args = _conv_args(B, *grid, DIM, NH, device, seed, DH)
        fwd, plain, extra = vil_layer_conv_fwd, vil_layer_conv_plain, (NH, grid)
    elif which == "block":
        args = _block_args(B, S, DIM, NH, device, seed, DH)
        fwd, plain, extra = vil_block_fwd, vil_block_plain, (NH,)
    else:
        make = _bf16_layer_args if which == "layer_bf16" else _layer_args
        args = make(B, S, DIM, NH, device, seed, DH)
        fwd, plain, extra = vil_layer_fwd, vil_layer_ref, (NH,)
    at = OUTNORM_AT[which]
    args[at] = args[at + 1] = None
    return fwd, plain, args, extra


@pytest.mark.parametrize("S,DIM,NH,DH,grid", NO_OUTNORM_SHAPES, ids=["P3_DH64", "P5_DH16"])
@pytest.mark.parametrize("which", ["layer", "layer_bf16", "block", "conv"])
def test_vil_kernels_without_outnorm_match_plain(cuda_device, which, S, DIM, NH, DH, grid):
    """K3 (fp32 and bf16), K7 and K6 with ``use_outnorm=False``: the tail
    adds h itself, ``(h + skip conv_act) silu(z)``; the outnorm's affine is
    not read (None, a null pointer). One launch each, within the existing
    tolerances of its plain version; with the outnorm, the same arguments
    give another output (the flag is not ignored)."""
    fwd, plain, args, extra = _without_outnorm(which, 2, S, DIM, NH, DH, grid, cuda_device,
                                               seed=S + DH)
    bf = which == "layer_bf16"
    count = (lambda: fwd.launches_bf16) if bf else (lambda: fwd.launches)
    before = count()
    got = fwd(*args, *extra, use_outnorm=False)
    want = plain(*args, *extra, chunk_size=64, use_outnorm=False,
                 **({"keep_fp32": True} if bf else {}))
    torch.cuda.synchronize()
    assert count() == before + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    if bf:
        rel_l2, excess = _rel_bf16(got, want)
        assert rel_l2 <= TOL_BF16_FWD and excess <= MAX_EXCESS, (rel_l2, excess)
    else:
        assert _rel(got, want) <= TOL_REL
    at = OUTNORM_AT[which]
    args[at] = torch.ones(NH * DH, device=cuda_device)
    args[at + 1] = torch.zeros(NH * DH, device=cuda_device)
    assert _rel(fwd(*args, *extra).float(), want) > 10 * TOL_REL


@pytest.mark.parametrize("S,DIM,NH,DH,grid", NO_OUTNORM_SHAPES, ids=["P3_DH64", "P5_DH16"])
@pytest.mark.parametrize("which", ["layer", "block", "conv"])
def test_vil_kernels_without_outnorm_grads_match_plain(cuda_device, which, S, DIM, NH, DH, grid):
    """Under grad without the outnorm: one forward launch and one K2
    launch; every gradient within TOL_REL of the plain backward (the tail's
    without the norm) on the plain forward's activations; None for the
    affine."""
    from xlstm_yolo_torch.kernels.vil_layer import layer_bwd

    fwd, _, args, extra = _without_outnorm(which, 2, S, DIM, NH, DH, grid, cuda_device,
                                           seed=S + DH + 1)
    leaves = [None if a is None else a.clone().requires_grad_() for a in args]
    f0, b0 = fwd.launches, mlstm_chunkwise_bwd.launches
    out = fwd(*leaves, *extra, use_outnorm=False)
    gout = torch.randn(out.shape, device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(S + DH))
    (out * gout).sum().backward()
    torch.cuda.synchronize()
    assert (fwd.launches, mlstm_chunkwise_bwd.launches) == (f0 + 1, b0 + 1)
    plain_fwd, bwd = {"layer": (_layer_plain, layer_bwd), "block": (_block_plain, block_bwd),
                      "conv": (_conv_plain, conv_layer_bwd)}[which]
    cfg = Cfg(NH, 64, seqlens=grid if which == "conv" else None, outnorm=False)
    _, acts = plain_fwd(args, cfg)
    want = bwd(args, acts, gout, cfg, mlstm_chunkwise_bwd_plain)
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        if leaf is None:
            assert w is None, i
            continue
        assert _rel(leaf.grad, w) <= TOL_REL, i


def test_vil_block_pair_without_outnorm_or_biases_on_card(cuda_device):
    """``ViLBlockPair(use_outnorm=False, proj_bias=False)`` at ViL-YOLO-n's
    P3 width (dim 64, head dim 64, an 80 x 80 grid), batch 2: the output and
    the input and parameter gradients against the same pair with the plain
    versions forced in; one K3 and one K2 launch."""
    from xlstm_yolo_torch.nn.modules import init_tree
    from xlstm_yolo_torch.nn.vil import ViLBlockPair

    pair = ViLBlockPair(64, qkv_block_size=64, seqlens=(80, 80), chunk_size=128,
                        use_outnorm=False, proj_bias=False)
    init_tree(pair, 0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for lin in (pair.fwd.layer.mlstm_cell.igate, pair.fwd.layer.mlstm_cell.fgate):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    pair = pair.to(cuda_device).train()
    assert not any(n.endswith("bias") and "proj" in n for n, _ in pair.named_parameters())
    x = torch.randn(2, 6400, 64, generator=g).to(cuda_device)
    gout = torch.randn(2, 6400, 64, generator=g).to(cuda_device)
    runs = []
    for plain in (False, True):
        pair.zero_grad()
        xt = x.clone().requires_grad_()
        f0, b0 = vil_layer_fwd.launches, mlstm_chunkwise_bwd.launches
        with _plain_vil() if plain else nullcontext():
            out = pair(xt)
            (out * gout).sum().backward()
        torch.cuda.synchronize()
        launched = (vil_layer_fwd.launches - f0, mlstm_chunkwise_bwd.launches - b0)
        assert launched == ((0, 0) if plain else (1, 1))
        grads = {n: p.grad.clone() for n, p in pair.named_parameters()}
        runs.append((out.detach(), xt.grad, grads))
    (out_k, dx_k, g_k), (out_p, dx_p, g_p) = runs
    assert _rel(out_k, out_p) <= TOL_REL and _rel(dx_k, dx_p) <= TOL_REL
    for n, w in g_p.items():
        assert _rel(g_k[n], w) <= TOL_REL, n


# ---- rect validation's grids and the trainer's profile (the detect task's keys)

RECT_GRIDS = [(28, 40, 128, 4), (14, 20, 256, 8), (40, 28, 128, 4)]


@pytest.mark.parametrize("H,W,DIM,NH", RECT_GRIDS, ids=["P4_28x40", "P5_14x20", "P4_40x28"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_vil_layer_kernels_at_rect_grids_match_plain(cuda_device, dtype, H, W, DIM, NH):
    """K3 and K3 bf16 at the token counts of rect buckets (bucket (448,
    640) at P4 and P5, and P4 of its portrait twin): S = H * W, 17.5 and
    4.4 chunks of 64, against their plain versions with this file's
    tolerances."""
    S = H * W
    if dtype == "fp32":
        args = _layer_args(2, S, DIM, NH, cuda_device, seed=S + 3)
        got = vil_layer_fwd(*args, NH, chunk_size=128)
        assert _rel(got, vil_layer_ref(*args, NH, chunk_size=128)) <= TOL_REL
    else:
        args = _bf16_layer_args(2, S, DIM, NH, cuda_device, seed=S + 4)
        got = vil_layer_fwd(*args, NH)
        rel_l2, excess = _rel_bf16(got, vil_layer_ref(*args, NH, chunk_size=64, keep_fp32=True))
        assert rel_l2 <= TOL_BF16_FWD and excess <= MAX_EXCESS, (rel_l2, excess)


@pytest.mark.parametrize("hw", [(448, 640), (640, 384)], ids=["wide", "tall"])
def test_vil_yolo_forward_at_rect_bucket_matches_plain(cuda_device, hw):
    """ViL-YOLO-n's eval forward at a rect bucket's shape (its ViL stages
    on H != W grids: P3 56 x 80, P4 28 x 40, P5 14 x 20 for (448, 640)): 3
    layer launches, candidates within 1e-3 of the plain-forced model's."""
    from xlstm_yolo_torch.nn.tasks import TaskModel

    model = TaskModel("vil_yolon.yaml", device=cuda_device)
    x = torch.rand(2, *hw, 3, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    with torch.inference_mode():
        before = vil_layer_fwd.launches
        got = model.predictions(x)
        assert vil_layer_fwd.launches == before + 3
        with _plain_vil():
            want = model.predictions(x)
    assert got.shape == want.shape == (2, sum((hw[0] // s) * (hw[1] // s) for s in (8, 16, 32)),
                                       84)
    assert _rel(got, want) <= TOL_REL


def test_trainer_profile_names_the_bf16_kernels(cuda_device, tmp_path):
    """``profile=True`` on the card (vil_yolon, 12 PNGs at 320 px, batch 4,
    ``mosaic_n=9``, AMP): the trace's three ``train_step`` spans each
    launch stages of the bf16 layer kernel (``vil16_*``) and of the bf16
    backward (``bwd16_*``), and none of the fp32 ones (``read_step_trace``)."""
    import xlstm_yolo_torch.kernels.mlstm_bwd as K2
    import xlstm_yolo_torch.kernels.vil_layer as K3
    from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset
    from xlstm_yolo_torch.engine.trainer import Trainer, read_step_trace
    from xlstm_yolo_torch.nn.tasks import TaskModel

    data = make_synthetic_dataset(tmp_path / "ds", n_train=12, n_val=1, width=320, height=240)
    tr = Trainer(TaskModel("vil_yolon.yaml", nc=3, device="cuda"),
                 overrides={"data": data, "epochs": 1, "batch": 4, "imgsz": 320, "val": False,
                            "profile": True, "mosaic_n": 9, "close_mosaic": 0,
                            "project": str(tmp_path), "name": "prof"})
    tr.train()
    t = read_step_trace(tr.trace.path)
    assert t["spans"] == 3 and min(t["busy_ms"]) > 0
    for ks in t["steps"]:
        names = [k["name"] for k in ks]
        assert any(K3.STAGES_BF16 in k for k in names)
        assert any(K2.STAGES_BF16 in k for k in names)
        assert not any(f in k for k in names for f in K3.STAGES + K2.STAGES)


XL_SMALL = dict(vocab_size=64, embedding_dim=128, num_blocks=2, num_heads=2, chunk_size=16)


def test_xlstm_large_graph_decode_matches_eager_generate(cuda_device):
    """``generate_scan``'s CUDA-graph replay gives eager ``generate``'s
    tokens, and each replayed step's logits are within 1e-5 of the eager
    step's on the same state (DQK 32, DV 64, a 24-token prompt)."""
    from xlstm_yolo_torch.nn import xlstm_large as XL

    model = XL.xLSTMLarge(**XL_SMALL, device="cuda", seed=0)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 24))).cuda()
    want = XL.generate(model, prompt, max_new_tokens=12)
    assert torch.equal(XL.generate_scan(model, prompt, max_new_tokens=12), want)
    last, state = XL.prefill(model, prompt)
    graph, eager = (XL.DecodeGraph(model, 2, 12, graph=g) for g in (True, False))
    assert graph.graph is not None and eager.graph is None
    for dec in (graph, eager):
        dec.reset(last, state)
    for _ in range(12):
        graph.step()
        eager.step()
        assert (graph.last - eager.last).abs().max().item() <= 1e-5 * eager.last.abs().max().item()
    torch.testing.assert_close(graph.out, want[:, 24:], rtol=0, atol=0)


def test_xlstm_large_graph_sampling_is_seeded(cuda_device):
    """Sampling inside the graph draws from the generator it was given:
    the same seed gives the same tokens, another seed others."""
    from xlstm_yolo_torch.nn import xlstm_large as XL

    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        pytest.skip("this PyTorch cannot register a generator with a CUDA graph")
    model = XL.xLSTMLarge(**XL_SMALL, device="cuda", seed=1)
    prompt = [[1, 2, 3, 4, 5, 6, 7, 8]]

    def sample(seed):
        return XL.generate_scan(model, prompt, 10, temperature=1.0,
                                generator=torch.Generator(device="cuda").manual_seed(seed))

    assert torch.equal(sample(3), sample(3))
    assert not torch.equal(sample(3), sample(4))


def _yolo11_block(name):
    from xlstm_yolo_torch.nn import heads as TH
    from xlstm_yolo_torch.nn import modules as TM

    return {"C3k": (lambda: TM.C3k(32, 48, n=2), (2, 32, 16, 16)),
            "C3k2": (lambda: TM.C3k2(32, 64, n=2, c3k=True, e=0.25), (2, 32, 16, 16)),
            "C3k2_bottleneck": (lambda: TM.C3k2(32, 64, n=2, e=0.25), (2, 32, 16, 16)),
            "Attention": (lambda: TM.Attention(128, num_heads=2), (2, 128, 20, 20)),
            "C2PSA": (lambda: TM.C2PSA(256, 256, n=1), (2, 256, 20, 20)),
            "Detect": (lambda: TH.Detect(nc=80, ch=(64, 128, 256), legacy=False),
                       [(2, 64, 80, 80), (2, 128, 40, 40), (2, 256, 20, 20)])}[name]


@pytest.mark.parametrize("name", ["C3k", "C3k2", "C3k2_bottleneck", "Attention", "C2PSA",
                                  "Detect"])
def test_yolo11_blocks_on_card_match_cpu(cuda_device, name):
    """Each YOLO11 block (plain torch ops, no kernel of the port's) in eval
    mode on the card against the same module on the CPU, at yolo11n's P5
    widths and grids, within 1e-4 of the output's max."""
    from xlstm_yolo_torch.nn.modules import init_tree

    make, shapes = _yolo11_block(name)
    cpu = make()
    init_tree(cpu, 0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    cpu.eval()
    card = copy.deepcopy(cpu).cuda()
    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for s in (shapes if isinstance(shapes, list) else [shapes])]
    with torch.no_grad():
        want = cpu(xs if isinstance(shapes, list) else xs[0])
        got = card([x.cuda() for x in xs] if isinstance(shapes, list) else xs[0].cuda())
    pairs = ([t for pair in zip(got, want) for t in zip(*pair)] if isinstance(shapes, list)
             else [(got, want)])
    for gt, wt in pairs:
        assert _rel(gt.cpu(), wt) <= 1e-4


def _zoo_block(name):
    from xlstm_yolo_torch.nn import heads as TH
    from xlstm_yolo_torch.nn import modules as TM

    cb = [[(2, 16, 40, 40), (2, 32, 40, 40)], [(2, 32, 10, 10)], (2, 32, 20, 20)]
    return {"ConvTransposeBN": (lambda: TM.ConvTransposeBN(64, 64, 2, 2), (2, 64, 40, 40)),
            "C3Ghost": (lambda: TM.C3Ghost(32, 64, n=2), (2, 32, 40, 40)),
            "GhostBottleneck_s2": (lambda: TM.GhostBottleneck(32, 64, 3, 2), (2, 32, 40, 40)),
            "ADown": (lambda: TM.ADown(64, 128), (2, 64, 41, 41)),
            "AConv": (lambda: TM.AConv(64, 96), (2, 64, 41, 41)),
            "RepNCSPELAN4": (lambda: TM.RepNCSPELAN4(64, 128, 64, 32, 2), (2, 64, 40, 40)),
            "SPPELAN": (lambda: TM.SPPELAN(128, 128, 64), (2, 128, 20, 20)),
            "CBFuse": (lambda: TM.CBFuse((1, 0)), cb),
            "C2fCIB_lk": (lambda: TM.C2fCIB(64, 64, n=2, shortcut=True, lk=True),
                          (2, 64, 20, 20)),
            "PSA": (lambda: TM.PSA(256, 256), (2, 256, 20, 20)),
            "A2C2f": (lambda: TM.A2C2f(64, 128, n=2, a2=True, area=4), (2, 64, 40, 40)),
            "v10Detect": (lambda: TH.v10Detect(nc=80, ch=(64, 128, 256)),
                          [(2, 64, 80, 80), (2, 128, 40, 40), (2, 256, 20, 20)])}[name]


def _leaves(x):
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return [x]


@pytest.mark.parametrize("name", ["ConvTransposeBN", "C3Ghost", "GhostBottleneck_s2", "ADown",
                                  "AConv", "RepNCSPELAN4", "SPPELAN", "CBFuse", "C2fCIB_lk",
                                  "PSA", "A2C2f", "v10Detect"])
def test_detect_zoo_blocks_on_card_match_cpu(cuda_device, name):
    """Blocks of the rest of the detect zoo (plain torch ops, no kernel of
    the port's) in eval mode on the card against the same module on the
    CPU, at the widths and grids of the zoo's small models, within 1e-4 of
    each output's max; ConvTransposeBN also folded (``fuse_conv_bn``)."""
    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn
    from xlstm_yolo_torch.nn.modules import init_tree

    make, shapes = _zoo_block(name)
    cpu = make()
    init_tree(cpu, 0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    cpu.eval()
    rng = np.random.default_rng(2)

    def build(s):
        if isinstance(s, list):
            return [build(t) for t in s]
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))

    def to_card(x):
        return [to_card(t) for t in x] if isinstance(x, list) else x.cuda()

    x = build(shapes)
    for model in ([cpu, fuse_conv_bn(copy.deepcopy(cpu))] if name == "ConvTransposeBN" else [cpu]):
        card = copy.deepcopy(model).cuda()
        with torch.no_grad():
            want, got = _leaves(model(x)), _leaves(card(to_card(x)))
        assert len(got) == len(want) > 0
        for gt, wt in zip(got, want):
            assert _rel(gt.cpu(), wt) <= 1e-4


# the ViL classifier at 224 px (vil_yolo.yaml rows 0-9 at scale n under Classify):
# its three ViL stages' grids (S, DIM, NH of 64)
CLASSIFY_GRIDS = [(784, 64, 2), (196, 128, 4), (49, 256, 8)]


@pytest.mark.parametrize("S,DIM,NH", CLASSIFY_GRIDS, ids=["P3_S784", "P4_S196", "P5_S49"])
@pytest.mark.parametrize("which", ["layer", "layer_bf16", "bwd", "bwd_bf16"])
def test_vil_kernels_at_classify_grids_match_plain(cuda_device, which, S, DIM, NH):
    """K3 and K2, fp32 and bf16, at the ViL classifier's grids at 224 px
    (28 x 28: twelve chunks of 64 and a partial one; 14 x 14; 7 x 7, shorter
    than one chunk), batch 4, against their plain versions: fp32 within
    TOL_REL of each output's max, bf16 by ``_rel_bf16`` (TOL_BF16_FWD /
    TOL_BF16_GRAD and MAX_EXCESS); each call launches its own entry once."""
    from xlstm_yolo_torch.kernels.vil_layer import _launch

    bf16 = which.endswith("bf16")
    args = (_bf16_layer_args if bf16 else _layer_args)(4, S, DIM, NH, cuda_device, seed=S + 41)
    if which.startswith("layer"):
        before = (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16)
        got = [vil_layer_fwd(*args, NH, chunk_size=128)]
        want = [vil_layer_ref(*args, NH, chunk_size=64 if bf16 else 128, keep_fp32=bf16)]
        after = (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16)
    else:
        _, (_, q, k, v, ig, fg), carry = _launch(args, Cfg(NH), bf16)
        dh = torch.randn(4, S, NH * 64, device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(S))
        before = (mlstm_chunkwise_bwd.launches, mlstm_chunkwise_bwd.launches_bf16)
        got = mlstm_chunkwise_bwd(q, k, v, ig, fg, dh, NH, carry=carry)
        want = mlstm_chunkwise_bwd_plain(q, k, v, ig, fg, dh, NH, keep_fp32=bf16)
        after = (mlstm_chunkwise_bwd.launches, mlstm_chunkwise_bwd.launches_bf16)
    torch.cuda.synchronize()
    assert after == ((before[0], before[1] + 1) if bf16 else (before[0] + 1, before[1]))
    for i, (g_, w) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g_).all()), i
        if bf16:
            rel_l2, excess = _rel_bf16(g_, w)
            tol = TOL_BF16_FWD if which == "layer_bf16" else TOL_BF16_GRAD
            assert rel_l2 <= tol and excess <= MAX_EXCESS, (i, rel_l2, excess)
        else:
            assert _rel(g_, w) <= TOL_REL, i


@contextmanager
def _pool_choices(log: list, replay: list | None = None):
    """``F.max_pool2d`` recording each call's argmax into ``log`` or, given
    ``replay`` (another run's log), gathering its input at those indices:
    the same function on the other run's routing."""
    from unittest import mock

    import torch.nn.functional as F

    real = F.max_pool2d

    def pool(x, k, s=None, p=0):
        if replay is None:
            y, idx = real(x, k, s, p, return_indices=True)
        else:
            idx = replay[len(log)].to(x.device)
            y = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        log.append(idx.cpu())
        return y

    with mock.patch.object(F, "max_pool2d", pool):
        yield


def test_vil_classifier_step_on_card_matches_cpu(cuda_device):
    """The ViL classifier (1000 classes, 224 px, batch 2, seeded gate
    kernels): one fp32 train-mode forward, cross-entropy and backward on
    the card (K3 and K2 once a ViL stage) against the same step on the CPU
    (the plain versions), the CPU's SPPF pools on the card's argmax (a flip
    under the other rounding moves a gradient by far more than the
    tolerance): the loss within TOL_REL, every gradient within TOL_REL of
    its own max (a gradient that is zero up to rounding, behind a
    train-mode BatchNorm, of the model's largest); then eval
    probabilities within TOL_REL."""
    from xlstm_yolo_torch.cfg import load_model_yaml
    from xlstm_yolo_torch.nn.tasks import TaskModel
    from xlstm_yolo_torch.nn.vil import MatrixLSTMCell

    cfg, _ = load_model_yaml("vil_yolon.yaml")
    graph = {"nc": 1000, "scales": cfg["scales"], "backbone": copy.deepcopy(cfg["backbone"]),
             "head": [[-1, 1, "Classify", ["nc"]]]}
    cpu = TaskModel(graph, scale="n", device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, MatrixLSTMCell):
                for lin in (m.igate, m.fgate):
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    rng = np.random.default_rng(3)
    batch = {"img": torch.from_numpy(rng.uniform(0, 1, (2, 224, 224, 3)).astype(np.float32)),
             "label": torch.tensor([7, 912])}
    steps, card_pools = {}, []
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(cpu).to(dev).train()
        before = (vil_layer_fwd.launches, mlstm_chunkwise_bwd.launches)
        with _pool_choices(card_pools if dev == "cuda" else [],
                           None if dev == "cuda" else card_pools):
            total, _ = m.loss({k: t.to(dev) for k, t in batch.items()})
            total.backward()
        launched = (vil_layer_fwd.launches - before[0], mlstm_chunkwise_bwd.launches - before[1])
        with torch.no_grad():
            probs = m.eval().predictions_full(batch["img"].to(dev))["probs"].cpu()
        steps[dev] = (float(total), {n: p.grad.cpu() for n, p in m.named_parameters()}, probs,
                      launched)
    assert steps["cuda"][3] == (3, 3) and steps["cpu"][3] == (0, 0)
    assert abs(steps["cuda"][0] - steps["cpu"][0]) <= TOL_REL * abs(steps["cpu"][0])
    grads_k, grads_p = steps["cuda"][1], steps["cpu"][1]
    gmax = max(t.abs().max().item() for t in grads_p.values())
    for n, gp in grads_p.items():
        scale = gp.abs().max().item()
        err = (grads_k[n] - gp).abs().max().item()
        assert err <= TOL_REL * (scale if scale >= 1e-6 * gmax else gmax), n
    assert _rel(steps["cuda"][2], steps["cpu"][2]) <= TOL_REL


# RT-DETR at rtdetr-l's widths, 640 px: three levels of 256 channels at
# strides 8, 16, 32; 8 heads of 32, 3 levels x 4 points, 300 queries
RTDETR_SHAPES = [(80, 80), (40, 40), (20, 20)]


def test_rtdetr_deform_sample_on_card_matches_cpu(cuda_device):
    """``deform_sample`` (the JAX gather written in torch) at rtdetr-l's
    shapes, locations inside and outside [0, 1]: the output and the
    gradients with respect to the value, the locations and the weights on
    the card within 1e-4 of the CPU's, each tensor of its own max."""
    from xlstm_yolo_torch.nn.rtdetr import deform_sample

    rng = np.random.default_rng(3)
    n = sum(h * w for h, w in RTDETR_SHAPES)
    cpu = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(2, n, 8, 32)), rng.uniform(-0.2, 1.2, (2, 300, 8, 3, 4, 2)),
        rng.uniform(0, 1, (2, 300, 8, 12)))]
    cot = torch.from_numpy(rng.normal(size=(2, 300, 256)).astype(np.float32))
    outs, grads = [], []
    for dev in ("cpu", "cuda"):
        args = [a.detach().to(dev).requires_grad_() for a in cpu]
        out = deform_sample(args[0], RTDETR_SHAPES, args[1], args[2])
        (out * cot.to(dev)).sum().backward()
        outs.append(out.detach().cpu())
        grads.append([a.grad.cpu() for a in args])
    assert _rel(outs[1], outs[0]) <= 1e-4
    for got, want in zip(grads[1], grads[0]):
        assert _rel(got, want) <= 1e-4


def test_rtdetr_selection_on_card_matches_cpu(cuda_device):
    """``ranked`` (a stable descending sort) picks the same indices in the
    same order on the card as on the CPU, ties included: 8400 anchor
    scores of which a tenth share one value, and 300 x 80 postprocess
    scores on a coarse grid."""
    from xlstm_yolo_torch.nn.rtdetr import ranked

    rng = np.random.default_rng(4)
    scores = rng.normal(size=(8, 8400)).astype(np.float32)
    scores[:, rng.choice(8400, 840, replace=False)] = 1.5
    coarse = rng.integers(0, 50, (8, 24000)).astype(np.float32) / 50
    for x, k in ((scores, 300), (coarse, 300)):
        t = torch.from_numpy(x)
        assert torch.equal(ranked(t.cuda(), k).cpu(), ranked(t, k))


def test_rtdetr_decoder_on_card_matches_cpu(cuda_device, monkeypatch):
    """An ``RTDETRDecoder`` at rtdetr-l's widths (80 classes, hd 256, 6
    layers) on seeded 640-px maps at batch 2, in eval (BatchNorm folded) and
    in train mode with 3 denoising groups of 8 ground-truth slots, the card
    taking the CPU's discrete choices (the query selection and the
    sampler's grid cells; how many the card, left to its own, takes
    otherwise is printed). In fp64 every output within 1e-9 of the CPU's;
    in fp32 the encoder's outputs and the first layer's boxes within 1e-4
    (each of its own max). The six layers amplify a difference about
    fivefold each on these weights: the last layer's fp32 boxes stand 1e-2
    from fp64 on either device, so fp32 is held where that leaves room."""
    import xlstm_yolo_torch.nn.rtdetr as R
    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn
    from xlstm_yolo_torch.nn.modules import init_tree

    base = R.RTDETRDecoder(nc=80, ch=(256, 256, 256))
    init_tree(base, 0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in base.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    rng = np.random.default_rng(5)
    feats = [torch.from_numpy(rng.normal(size=(2, 256, h, w)).astype(np.float32))
             for h, w in RTDETR_SHAPES]
    gt = torch.from_numpy(rng.uniform(0.2, 0.8, (2, 8, 4)).astype(np.float32))
    gt[..., 2:] *= 0.3
    dn = R.get_cdn_group(torch.from_numpy(rng.integers(0, 80, (2, 8))), gt, torch.ones(2, 8), 80,
                         torch.Generator().manual_seed(2))[:2]
    real = {"ranked": R.ranked, "cell": R.cell}

    def recording(name, log):
        return lambda *a: log.append(real[name](*a)) or log[-1]

    def replaying(log):
        it = iter(log)
        return lambda *a: (lambda t: t.to(a[0].device, a[0].dtype) if t.is_floating_point()
                           else t.to(a[0].device))(next(it))

    for train in (False, True):
        model = copy.deepcopy(base).train() if train else fuse_conv_bn(copy.deepcopy(base).eval())
        for dt in (torch.float64, torch.float32):
            kw = {"dn": (*dn, 3)} if train else {}
            logs, own = {n: [] for n in real}, {n: [] for n in real}
            for name in real:
                monkeypatch.setattr(R, name, recording(name, logs[name]))
            with torch.no_grad():
                want = copy.deepcopy(model).to(dt)([f.to(dt) for f in feats], **kw)
            card = copy.deepcopy(model).cuda().to(dt)
            card_in = [f.cuda().to(dt) for f in feats]
            card_kw = {"dn": (dn[0].cuda(), dn[1].cuda(), 3)} if train else {}
            for name in real:
                monkeypatch.setattr(R, name, recording(name, own[name]))
            with torch.no_grad():
                card(card_in, **card_kw)
            differ = {name: sum(int((a.cpu() != b).sum()) for a, b in zip(own[name], logs[name]))
                      for name in real}
            print(f"{'train' if train else 'eval'} {dt}: the card's own choices differ in "
                  f"{differ}")
            for name in real:
                monkeypatch.setattr(R, name, replaying(logs[name]))
            with torch.no_grad():
                got = card(card_in, **card_kw)
            if dt == torch.float64:
                for k, w in want.items():
                    if w is not None:
                        assert _rel(got[k].cpu(), w) <= 1e-9, k
            else:
                for k in ("enc_boxes", "enc_scores"):
                    assert _rel(got[k].cpu(), want[k]) <= 1e-4, k
                assert _rel(got["aux_boxes"][0].cpu(), want["aux_boxes"][0]) <= 1e-4


def _world_block(name):
    from xlstm_yolo_torch.nn import world as TW

    feats = [(2, 128, 80, 80), (2, 256, 40, 40), (2, 512, 20, 20)]
    return {"C2fAttn": (lambda: TW.C2fAttn(256, 256, n=3, ec=128, nh=4), [(2, 256, 80, 80)]),
            "ImagePoolingAttn": (lambda: TW.ImagePoolingAttn((128, 256, 512), ec=256), feats),
            "WorldDetect": (lambda: TW.WorldDetect(512, ch=(128, 256, 512)), feats),
            "WorldDetect_bn": (lambda: TW.WorldDetect(512, ch=(128, 256, 512), with_bn=True),
                               feats)}[name]


@pytest.mark.parametrize("name", ["C2fAttn", "ImagePoolingAttn", "WorldDetect", "WorldDetect_bn"])
def test_world_blocks_on_card_match_cpu(cuda_device, name):
    """YOLO-World's blocks (plain torch) at yolov8l-world's widths, fp32, on
    the card against the CPU: forward and the gradients of every parameter
    and input, with an 80-text guide whose last 40 slots are padding (one
    shared embedding: the max over texts ties there), each within 1e-4 of
    its own max (a gradient that is zero up to rounding, its max below 1e-6
    of the module's largest, as ``chip_smoke.grad_errors``: of that
    largest)."""
    from xlstm_yolo_torch.nn.modules import init_tree

    make, shapes = _world_block(name)
    cpu = make()
    init_tree(cpu, 0)
    rng = np.random.default_rng(3)
    guide = rng.normal(size=(2, 80, 512)).astype(np.float32)
    guide[:, 40:] = guide[:, 40:41]
    xs = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]
    card = copy.deepcopy(cpu).cuda()
    outs, grads = [], []
    for mod, dev in ((cpu, "cpu"), (card, "cuda")):
        mod.eval()
        ins = [x.clone().to(dev).requires_grad_(True) for x in xs]
        g = torch.from_numpy(guide).clone().to(dev).requires_grad_(True)
        out = _leaves(mod(ins if len(ins) > 1 else ins[0], g))
        r = [torch.from_numpy(np.random.default_rng(4 + i).normal(size=tuple(o.shape))
                              .astype(np.float32)).to(dev) for i, o in enumerate(out)]
        sum((o * w).sum() for o, w in zip(out, r)).backward()
        outs.append([o.detach().cpu() for o in out])
        grads.append([t.grad.cpu() for t in [*ins, g, *mod.parameters()]])
    for got, want in zip(outs[1], outs[0]):
        assert _rel(got, want) <= 1e-4
    gmax = max(float(w.abs().max()) for w in grads[0])
    for got, want in zip(grads[1], grads[0]):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * (scale if scale >= 1e-6 * gmax else gmax)


def test_clip_text_tower_on_card_matches_cpu(cuda_device, tmp_path):
    """The CLIP text tower at ViT-B/32's text widths (vocab 49,408, context
    77, width 512, 8 heads, 12 layers), seeded, fp32: 80 prompts' features
    on the card within 1e-5 of the CPU's max."""
    from xlstm_yolo_torch.nn.clip_text import ClipTextEncoder

    bpe = tmp_path / "bpe.txt"
    bpe.write_text("#version: test\nt h\nth e</w>\np e\npe r\nper s\npers o\nperso n</w>\n")
    texts = [f"a photo of a person number {i}" for i in range(80)]
    cpu = ClipTextEncoder(bpe, device="cpu", n_merges=None)
    card = ClipTextEncoder(bpe, device="cuda", n_merges=None)
    want, got = cpu.features(texts), card.features(texts).cpu()
    assert got.shape == (80, 512)
    assert _rel(got, want) <= 1e-5


def _perturbed(model, seed, std=0.02):
    """Seeded noise on every parameter (the rel-pos and temporal tables
    start at zero)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * std)
    return model


def test_sam_decoder_on_card_matches_cpu(cuda_device):
    """SAM's prompt encoder and two-way decoder at ViT-B's prompt width
    (256, 8 heads) on a 64 x 64 embedding, points with a padded label and
    a box, batch 2, fp32: masks and IoU within 1e-3 of their max."""
    from xlstm_yolo_torch.models_sam import SAM

    cpu = _perturbed(SAM(img_size=128, encoder_dim=64, encoder_depth=1, device="cpu"), 0)
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.normal(size=(2, 64, 64, 256)).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(0, 128, (2, 3, 2)).astype(np.float32))
    lab = torch.tensor([[1, 0, -1], [0, 1, 1]])
    box = torch.tensor([[[10.0, 12.0], [90.0, 100.0]], [[3.0, 30.0], [60.0, 120.0]]])
    with torch.inference_mode():
        want = cpu.decode(emb, pts, lab, box)
        got = card.decode(*(t.to(cuda_device) for t in (emb, pts, lab, box)))
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w) <= TOL_REL


def test_sam2_track_step_on_card_matches_cpu(cuda_device):
    """SAM2's ``track_step`` at Hiera-T widths, 256 px, batch 2 with a point
    each: one row with no valid slot (``x + no_mem_embed``), one with some;
    masks, IoU and the new memory within 1e-3 of their max."""
    from xlstm_yolo_torch.models_sam2 import SAM2

    cpu = _perturbed(SAM2(img_size=256, device="cpu"), 1)
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(1)
    hw = (256 // 16) ** 2
    args = (torch.from_numpy(rng.random((2, 256, 256, 3)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(2, 7, hw, 64)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 9, (2, 7)).astype(np.int32)),
            torch.tensor([[False] * 7, [True, False, True, True, False, False, True]]),
            torch.tensor([[[60.0, 80.0]], [[200.0, 40.0]]]), torch.tensor([[1.0], [0.0]]))
    with torch.inference_mode():
        want = cpu.track_step(*args)
        got = card.track_step(*(t.to(cuda_device) for t in args))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g.cpu(), w) <= TOL_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_vil_layer_op_opcheck_on_card(cuda_device, dtype):
    """The registered op ``xlstm_yolo::vil_layer_fwd`` on CUDA tensors at P4's
    shape: schema, fake tensor, autograd registration and AOT dispatch
    (``torch.library.opcheck``); the op launches the kernel of the
    activations' dtype."""
    from xlstm_yolo_torch.kernels.vil_cell import OPS, cfg_args

    args = _layer_args(2, 1600, 128, 4, cuda_device, seed=11)
    args[:2] = [a.to(dtype) for a in args[:2]]
    before = (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16)
    torch.library.opcheck(OPS["vil_layer_fwd"], (*args, *cfg_args(Cfg(4, 128))))
    after = (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16)
    bf = dtype == torch.bfloat16
    assert after[int(bf)] > before[int(bf)] and after[int(not bf)] == before[int(not bf)]


def test_exported_vil_layer_on_card_matches_plain(cuda_device, tmp_path):
    """One ``ViLLayer`` at P4's widths through ``torch.export`` (saved and
    loaded): one ``xlstm_yolo::vil_layer_fwd`` node, one launch a call of the
    loaded program, within TOL_REL of the plain version."""
    import xlstm_yolo_torch.kernels.vil_cell as vc
    from xlstm_yolo_torch.nn.modules import init_tree
    from xlstm_yolo_torch.nn.vil import ViLLayer

    layer = ViLLayer(128, qkv_block_size=64, chunk_size=128, seqlens=(40, 40))
    init_tree(layer, 0)
    layer = layer.to(cuda_device).eval()
    x = torch.randn(2, 1600, 128, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(0))
    with torch.no_grad():
        program = torch.export.export(layer, (x,))
    torch.export.save(program, str(tmp_path / "layer.pt2"))
    loaded = torch.export.load(str(tmp_path / "layer.pt2"))
    target = torch.ops.xlstm_yolo.vil_layer_fwd.default
    assert sum(n.target is target for n in loaded.graph.nodes) == 1
    before = vil_layer_fwd.launches
    with torch.no_grad():
        got = loaded.module()(x)
        torch.cuda.synchronize()
        assert vil_layer_fwd.launches == before + 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(vc, "_on_card", lambda t: False)
            want = layer(x)
    assert _rel(got, want) <= TOL_REL


@pytest.mark.parametrize("segments", [2, 5])
def test_sp_segments_on_card_match_unsplit(cuda_device, segments):
    """The sequence-parallel mLSTM's plain functions (summary, exclusive
    prefix, seeded pass) over ``segments`` segments at ViL-YOLO-n's P3
    shape (B 8, NH 2, S 6400, DH 64, chunk 128) on the card, against the
    unsplit ``mlstm_chunkwise``: rtol = atol = 3e-4, the JAX sp test's."""
    from xlstm_yolo_torch.kernels.mlstm_native import mlstm_chunkwise
    from xlstm_yolo_torch.kernels.mlstm_sp import (exclusive_prefix, seeded_pass,
                                                   segment_summary)

    B, NH, S, DH, CS = 8, 2, 6400, 64, 128
    g = torch.Generator(cuda_device).manual_seed(segments)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device)
    q, k, v, i, f = mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S), \
        mk(B, NH, S) + 2.0
    want = mlstm_chunkwise(q, k, v, i, f, chunk_size=CS)
    n = S // segments
    parts = [[t[:, :, j * n:(j + 1) * n] for t in (q, k, v, i, f)] for j in range(segments)]
    states = exclusive_prefix([segment_summary(*p, chunk_size=CS) for p in parts])
    got = torch.cat([seeded_pass(*p, s, chunk_size=CS) for p, s in zip(parts, states)], 2)
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)


def test_moeffn_on_card_matches_cpu(cuda_device):
    """The MoEFFN graph of the JAX ep trainer test (80 classes) at 256 px,
    batch 2: eval candidates and one fp32 step's loss (the load-balance
    loss in it) and gradients on the card against the same weights on the
    CPU, each gradient of its own max (a vanishing one of the model's
    largest), TOL_REL."""
    from xlstm_yolo_torch.nn.tasks import TaskModel

    graph = {"nc": 80, "backbone": [[-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
                                    [-1, 1, "MoEFFN", [4, 2]], [-1, 1, "Conv", [64, 3, 2]],
                                    [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "SPPF", [64, 5]]],
             "head": [[[2, 4, 5], 1, "Detect", ["nc"]]]}
    model = TaskModel(graph, device="cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 256, 256, 3)).astype(
        np.float32))
    cb = torch.zeros(2, 8, 5)
    cb[:, 0] = torch.tensor([3.0, 20, 30, 120, 140])
    cb[:, 1] = torch.tensor([7.0, 100, 60, 240, 200])
    mask = torch.zeros(2, 8, dtype=torch.bool)
    mask[:, :2] = True
    out = {}
    for dev in ("cpu", cuda_device):
        m = copy.deepcopy(model).to(dev)
        with torch.no_grad():
            cands = m.eval().predictions(x.to(dev)).cpu()
        m.train()
        total, aux = m.loss({"img": x.to(dev), "cls_boxes": cb.to(dev), "mask": mask.to(dev)})
        total.backward()
        out[str(dev)] = (cands, float(total.detach()), float(aux["moe_aux"].detach()),
                         {n: p.grad.cpu() for n, p in m.named_parameters()})
    (c0, l0, a0, g0), (c1, l1, a1, g1) = out["cpu"], out[str(cuda_device)]
    assert _rel(c1, c0) <= TOL_REL
    assert abs(l1 - l0) <= TOL_REL * abs(l0) and abs(a1 - a0) <= TOL_REL * abs(a0)
    gmax = max(g.abs().max().item() for g in g0.values())
    for n, g in g0.items():  # a tensor that vanishes is held to the model's largest gradient
        scale = g.abs().max().item()
        scale = scale if scale >= 1e-6 * gmax else gmax
        assert (g1[n] - g).abs().max().item() <= TOL_REL * scale, n
