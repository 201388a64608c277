"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips where there is no CUDA device (the
kernels have no CPU mode). Imports nothing of JAX, so it runs on a GPU host
with only the port installed: ``pytest -m cuda tests/test_torch_cuda.py``.
Tolerance: relative error (max |kernel - plain| / max |plain|) 1e-3, fp32
with other summation orders and chunk lengths than the plain version; each
gradient is held to its own max.
"""
from contextlib import nullcontext

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
    with pytest.raises(ValueError):  # head dim 32: not what the kernel is written for
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


def _block_args(B, S, DIM, NH, device, seed):
    """The block function's 19 arguments, cut from seeded layer arguments:
    conv_act, x_mlstm, z, x_res, then the cell's and the tail's."""
    a = _layer_args(B, S, DIM, NH, device, seed)
    rng = np.random.default_rng(seed + 1)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    return [a[1], mk(B, S, NH * 64), mk(B, S, NH * 64), a[0], *a[5:]]


FAMILY = {"cell": (vil_cell_fwd, vil_cell_plain, 12), "block": (vil_block_fwd, vil_block_plain, 19)}
FAMILY_SHAPES = [(196, 192, 6, "exp"), (6400, 64, 2, "exp"), (77, 64, 2, "sigmoid"),
                 (64, 128, 4, "exp")]
FAMILY_IDS = ["classifier_ragged", "P3", "short_sigmoid", "one_chunk"]


def _family_args(which, B, S, DIM, NH, device, seed):
    args = _block_args(B, S, DIM, NH, device, seed)
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
    with pytest.raises(ValueError):  # head dim 32: not what the kernel is written for
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
    for r in range(2):
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


def _conv_args(B, H, W, DIM, NH, device, seed):
    """The conv-fused layer's 21 arguments from seeded layer arguments: x,
    the norm and proj_up, a seeded depthwise kernel and bias, the rest."""
    a = _layer_args(B, H * W, DIM, NH, device, seed)
    rng = np.random.default_rng(seed + 5)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    return [a[0], *a[2:5], mk(NH * 64, 1, 3, 3) * 0.3, mk(NH * 64) * 0.1, *a[5:]]


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
    with pytest.raises(ValueError):  # head dim 32: not what the kernel is written for
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


def _bf16_layer_args(B, S, DIM, NH, device, seed):
    args = _layer_args(B, S, DIM, NH, device, seed)
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


def _check_bf16_layer_grads(device, S, DIM, NH, seed, nudges=(float("inf"),)):
    """``test_vil_layer_bf16_grads_match_plain``'s check; the noise floor is
    the plain version's largest distance to itself over ``nudges`` (the
    directions of the one-ulp nudge)."""
    args = _bf16_layer_args(2, S, DIM, NH, device, seed=seed)
    leaves = [a.clone().requires_grad_() for a in args]
    g = torch.Generator(device).manual_seed(seed)
    gout = torch.randn(2, S, DIM, device=device, generator=g).bfloat16()
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
