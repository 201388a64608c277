"""sLSTM recurrence: plain torch and CUDA.

Port of ``xlstm_yolo_tpu/kernels/slstm.py`` (``slstm_pointwise``,
``slstm_scan``, ``slstm_step``, ``powerlaw_blockdependent_bias``) and of the
fused TPU entry ``slstm_scan_pallas`` in
``xlstm_yolo_tpu/kernels/slstm_pallas.py`` (kernel ``_kernel``), which
becomes the hand-written CUDA kernel in ``csrc/slstm.cu``.

States (y, c, n, m), gates (i, f, z, o), exp-max stabilizer:

    m' = max(i_raw, logsigmoid(f_raw) + m)
    c' = exp(logsigmoid(f_raw) + m - m') c + exp(i_raw - m') tanh(z_raw)
    n' = exp(logsigmoid(f_raw) + m - m') n + exp(i_raw - m')
    y  = sigmoid(o_raw) c' / n'

with raw = wx_t + y R + b per head. Shapes: input-projected gate preacts wx
(B, S, NH, 4, DH), recurrent kernel r (NH, DH, 4, DH), bias b (NH, 4, DH).

``slstm_scan`` (a Python loop over S in fp32) is the kernel's plain version:
the CPU path, differentiable by autograd. ``slstm_scan_fwd`` sends CPU
tensors to it and CUDA tensors to the kernel, and never falls back from a
CUDA tensor to the plain version. The TPU entry takes its plain scan for an
explicit state carry; here the kernel reads and writes (y, c, n, m) itself.

Gradients. The JAX entry's ``custom_vjp`` backward is ``jax.vjp`` of its
plain scan, one compiled reverse loop on the device. Here the reverse loop
is a second hand-written kernel in ``csrc/slstm.cu``: under autograd the
forward kernel also writes every step's gate values and (c, n, m) to a
workspace, and ``_SlstmFunction.backward`` runs the reverse-time kernel on
it (``slstm_scan_bwd``). Both hold the stabilizer m constant: y is
invariant to rescaling every state by exp(m), so these are autograd's
gradients up to rounding. ``slstm_scan_bwd_plain`` is the reverse
recurrence as the JAX package's vjp runs it; ``slstm_bwd_coefficients`` and
``slstm_bwd_walk_plain`` are the same recurrence in the kernel's
coefficient form (every factor that does not depend on the carried
gradient computed from the workspace alone, so the walk is multiply-adds),
and ``slstm_scan_bwd`` takes them for CPU tensors. A carried state takes
part both ways: the gradient of a returned last state seeds the walk, and
the walk ends in the gradient of the initial state; the part of the last
m's gradient that the frozen walk cannot see follows the stabilizer's max
chain back (``slstm_scan_bwd_plain``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import CudaLibrary, check_tensor

NEG_INIT = -1e30  # initial m: step 1 reduces to m' = i_raw with the f-path
# exactly 0 (exp(NEG_INIT - m') == 0), so n' = exp(0) = 1 and never 0
KERNEL_DHS = (32, 64, 128)  # head dims the CUDA kernel is instantiated for

SAVED = 7  # per step and channel, what the forward writes under autograd:
           # i_raw, logsigmoid(f_raw), tanh(z_raw), sigmoid(o_raw), c, n, m

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = CudaLibrary("slstm.cu", {
    "slstm_fwd_f32": (_I, [_P] * 7 + [_I] * 4 + [_P]),
    "slstm_bwd_f32": (_I, [_P] * 8 + [_I] * 4 + [_P]),
    "slstm_error_string": (ctypes.c_char_p, [_I]),
})


def slstm_pointwise(raw: torch.Tensor, state: tuple):
    """One fused gate step. raw (B, NH, 4, DH); state (y, c, n, m), each
    (B, NH, DH). Returns the new state."""
    y, c, n, m = state
    iraw, fraw, zraw, oraw = raw.unbind(dim=2)
    logfplusm = m + F.logsigmoid(fraw)
    m_new = torch.maximum(iraw, logfplusm)
    igate = torch.exp(iraw - m_new)
    fgate = torch.exp(logfplusm - m_new)
    c_new = fgate * c + igate * torch.tanh(zraw)
    n_new = fgate * n + igate
    y_new = torch.sigmoid(oraw) * c_new / n_new
    return y_new, c_new, n_new, m_new


def _initial_state(B, NH, DH, device):
    zeros = torch.zeros((B, NH, DH), dtype=torch.float32, device=device)
    return zeros, zeros, zeros, torch.full_like(zeros, NEG_INIT)


def slstm_step(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor, state: tuple):
    """Single autoregressive step. wx (B, NH, 4, DH) -> (y, new state)."""
    state = tuple(s.float() for s in state)
    ry = torch.einsum("bnd,ndge->bnge", state[0], r.float())
    new_state = slstm_pointwise(wx.float() + ry + b.float()[None], state)
    return new_state[0], new_state


def slstm_scan_states(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
                      initial_state: tuple | None = None):
    """The plain scan, a Python loop over S in fp32: y (B, S, NH, DH) and
    the state after every step, (c, n, m), each (B, S, NH, DH): the states
    the backward reads (the forward kernel writes them to its workspace
    under autograd)."""
    B, S, NH, _, DH = wx.shape
    state = (_initial_state(B, NH, DH, wx.device) if initial_state is None
             else tuple(s.float() for s in initial_state))
    out = [[], [], [], []]
    for t in range(S):
        _, state = slstm_step(wx[:, t], r, b, state)
        for lst, x in zip(out, state):
            lst.append(x)
    y, c, n, m = (torch.stack(x, dim=1) for x in out)
    return y, (c, n, m)


def slstm_scan(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
               initial_state: tuple | None = None, return_last_state: bool = False):
    """Full-sequence sLSTM in plain torch, fp32: y (B, S, NH, DH), plus the
    last (y, c, n, m) with ``return_last_state``."""
    y, states = slstm_scan_states(wx, r, b, initial_state)
    return (y, (y[:, -1], *(s[:, -1] for s in states))) if return_last_state else y


def slstm_scan_bwd_plain(wx, r, b, y, states, dy, initial_state: tuple | None = None,
                         dlast: tuple | None = None, with_state: bool = False):
    """The reverse-time kernel's plain version: the gradients (dwx, dr, db)
    of ``slstm_scan`` for the output gradient dy (B, S, NH, DH), from the
    forward's y and per-step states (c, n, m), each (B, S, NH, DH), and the
    carried-in ``initial_state`` (y, c, n, m) it started from (None: zeros,
    m = NEG_INIT). fp32, the stabilizer m held constant. From t = S-1 down to
    0: the step's total y gradient is dy_t plus R draw_{t+1}; from it come
    d(o_raw), dc_t and dn_t, then d(i_raw), d(f_raw) (through logsigmoid)
    and d(z_raw), and the carries dc, dn scaled by the forget gate. dr[h] =
    sum over b, t of y_{t-1}^T draw_t and db = sum of draw. dwx (B, S, NH, 4,
    DH) is draw itself.

    ``dlast``: the gradient (dy, dc, dn, dm) of the last state that
    ``return_last_state`` returns, or None. dy joins dy_{S-1} and (dc, dn)
    seed the carries. A stabilized state enters the function only through
    c e^m and n e^m, so the frozen walk is exact except for delta = dm - dc c
    - dn n, which follows the max chain m_t = max(i_raw, logsigmoid(f_raw) +
    m_{t-1}) back: into d(i_raw) where the input gate won, else into
    d(logsigmoid(f_raw)) and on to m_{t-1}. ``with_state``: also return the
    gradient of ``initial_state`` (dy0 = R draw_0, the carries dc0, dn0 and
    dm0 = dc0 c0 + dn0 n0 + what is left of delta) as a fourth element."""
    B, S, NH, _, DH = wx.shape
    f32 = lambda t: t.float()
    wx, r, b, y, dy = map(f32, (wx, r, b, y, dy))
    c, n, m = map(f32, states)
    y0, c0, n0, m0 = (_initial_state(B, NH, DH, wx.device) if initial_state is None
                      else tuple(map(f32, initial_state)))
    prev = lambda first, seq: torch.cat([first[:, None], seq[:, :-1]], dim=1)
    y_prev, c_prev, n_prev, m_prev = prev(y0, y), prev(c0, c), prev(n0, n), prev(m0, m)
    raw = wx + torch.einsum("bsnd,ndge->bsnge", y_prev, r) + b
    iraw, fraw, zraw, oraw = raw.unbind(dim=3)
    lsf, tz, so = F.logsigmoid(fraw), torch.tanh(zraw), torch.sigmoid(oraw)
    ig, fg = torch.exp(iraw - m), torch.exp(lsf + m_prev - m)
    ibranch = iraw >= lsf + m_prev  # the input gate won the stabilizer's max
    sig_nf = torch.sigmoid(-fraw)
    dc = dn = dyr = delta = torch.zeros((B, NH, DH), dtype=torch.float32, device=wx.device)
    if dlast is not None:
        dyl, dc, dn, dml = map(f32, dlast)
        dy = torch.cat([dy[:, :-1], (dy[:, -1] + dyl)[:, None]], dim=1)
        delta = dml - dc * c[:, -1] - dn * n[:, -1]
    draws = [None] * S
    for t in range(S - 1, -1, -1):
        dyt = dy[:, t] + dyr
        hn = c[:, t] / n[:, t]
        dct = dc + dyt * so[:, t] / n[:, t]
        dnt = dn - dyt * so[:, t] * hn / n[:, t]
        dfg = dct * c_prev[:, t] + dnt * n_prev[:, t]
        dig = dct * tz[:, t] + dnt
        dc, dn = dct * fg[:, t], dnt * fg[:, t]
        wins = ibranch[:, t]
        dmi, dmf = torch.where(wins, delta, 0.0), torch.where(wins, 0.0, delta)
        delta = dmf
        draw = torch.stack([dig * ig[:, t] + dmi, (dfg * fg[:, t] + dmf) * sig_nf[:, t],
                            dct * ig[:, t] * (1 - tz[:, t] ** 2),
                            dyt * hn * so[:, t] * (1 - so[:, t])], dim=2)  # (B, NH, 4, DH)
        draws[t] = draw
        dyr = torch.einsum("bnge,ndge->bnd", draw, r)
    draw = torch.stack(draws, dim=1)
    out = (draw, torch.einsum("bsnd,bsnge->ndge", y_prev, draw), draw.sum(dim=(0, 1)))
    if not with_state:
        return out
    return (*out, (dyr, dc, dn, dc * c0 + dn * n0 + delta))


def _launch(wx, r, b, state_in, return_last_state: bool, save: bool = False):
    """The forward kernel on checked CUDA tensors -> (y, last state or None,
    saved or None). With ``save`` it also writes what the reverse-time kernel
    reads: (B, S, NH, SAVED, DH), every step's gate values and (c, n, m)."""
    B, S, NH, _, DH = wx.shape
    dev = wx.device
    lib = _LIB.load()
    y = torch.empty((B, S, NH, DH), device=dev, dtype=torch.float32)
    state_out = torch.empty((4, B, NH, DH), device=dev, dtype=torch.float32) \
        if return_last_state else None
    saved = torch.empty((B, S, NH, SAVED, DH), device=dev, dtype=torch.float32) \
        if save else None
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.slstm_fwd_f32(wx.data_ptr(), r.data_ptr(), b.data_ptr(), ptr(state_in),
                                y.data_ptr(), ptr(state_out), ptr(saved), B, S, NH, DH, stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan_fwd: CUDA error {err}: "
                           f"{lib.slstm_error_string(err).decode()}")
    slstm_scan_fwd.launches += 1
    return y, None if state_out is None else tuple(state_out.unbind(0)), saved


class BwdCoefficients(NamedTuple):
    """Per-step factors of the reverse recurrence that do not depend on the
    carried gradient, each (B, S, NH, DH) or, by gate (i, f, z, o), (B, S,
    NH, 4, DH). With dyt = dy_t + R draw_{t+1}, dct = dc + a dyt and dnt = dn
    - bn dyt, gate q's gradient is alpha_q dct + beta_q dnt + gamma_q dyt +
    dgate_q delta; then dc, dn = fg dct, fg dnt and delta = keep delta."""
    a: torch.Tensor       # so / n
    bn: torch.Tensor      # so c / n^2
    fg: torch.Tensor      # exp(logsigmoid(f) + m_{t-1} - m), as the forward computed it
    keep: torch.Tensor    # 0 where the input gate won the stabilizer's max, else 1
    alpha: torch.Tensor   # (tz ig, c_{t-1} fg sigmoid(-f), ig (1 - tz^2), 0)
    beta: torch.Tensor    # (ig, n_{t-1} fg sigmoid(-f), 0, 0)
    gamma: torch.Tensor   # (0, 0, 0, (c / n) so (1 - so))
    dgate: torch.Tensor   # (1 - keep, keep sigmoid(-f), 0, 0): where delta joins


def slstm_bwd_coefficients(saved: torch.Tensor, state_in: torch.Tensor | None = None
                           ) -> BwdCoefficients:
    """What the reverse-time kernel's producer warps compute ahead of the
    walk, from the forward's workspace ``saved`` (B, S, NH, SAVED, DH) and the
    packed carried-in state (4, B, NH, DH) or None (zeros, m = NEG_INIT)
    alone: ig and fg from the same operands as the forward's gate math, the
    input-gate branch of the stabilizer, and each gate's triple (alpha,
    beta, gamma) with delta's factor."""
    i, lsf, tz, so, c, n, m = saved.float().unbind(3)
    B, S, NH, DH = c.shape
    if state_in is None:
        zeros = torch.zeros((B, 1, NH, DH), dtype=c.dtype, device=c.device)
        c0, n0, m0 = zeros, zeros, torch.full_like(zeros, NEG_INIT)
    else:
        c0, n0, m0 = (x[:, None].float() for x in state_in[1:])
    prev = lambda first, seq: torch.cat([first, seq[:, :-1]], dim=1)
    c_prev, n_prev, m_prev = prev(c0, c), prev(n0, n), prev(m0, m)
    ig, fg = torch.exp(i - m), torch.exp((m_prev + lsf) - m)
    ibranch = (i >= m_prev + lsf).float()
    hn = c / n
    sig_nf = -torch.expm1(lsf)  # sigmoid(-f) = 1 - exp(logsigmoid(f))
    zero = torch.zeros_like(c)
    gates = lambda *g: torch.stack(g, dim=3)
    return BwdCoefficients(
        a=so / n, bn=so * hn / n, fg=fg, keep=1 - ibranch,
        alpha=gates(tz * ig, c_prev * fg * sig_nf, ig * (1 - tz * tz), zero),
        beta=gates(ig, n_prev * fg * sig_nf, zero, zero),
        gamma=gates(zero, zero, zero, hn * so * (1 - so)),
        dgate=gates(ibranch, (1 - ibranch) * sig_nf, zero, zero))


def slstm_bwd_walk_plain(k: BwdCoefficients, r: torch.Tensor, dy: torch.Tensor,
                         dlast: torch.Tensor | None = None, last_cn: tuple | None = None):
    """The reverse recurrence in coefficient form, the chain the kernel's
    consumer threads run: only (dc, dn, delta) and R draw_{t+1} are carried,
    every step is multiply-adds. ``dlast``: the packed (4, B, NH, DH)
    gradient of the returned last state (dy, dc, dn, dm), with ``last_cn``
    the last (c, n) for delta = dm - dc c - dn n. Returns draw (B, S, NH, 4,
    DH) and the gradient of the initial (y, c, n) with what is left of
    delta, each (B, NH, DH)."""
    B, S, NH, DH = dy.shape
    r, dy = r.float(), dy.float()
    dc = dn = dyr = delta = torch.zeros((B, NH, DH), dtype=torch.float32, device=dy.device)
    if dlast is not None:
        dyl, dc, dn, dml = dlast.float().unbind(0)
        dy = torch.cat([dy[:, :-1], (dy[:, -1] + dyl)[:, None]], dim=1)
        delta = dml - dc * last_cn[0] - dn * last_cn[1]
    draws = [None] * S
    ex = lambda x: x[:, :, None]  # (B, NH, DH) -> by gate
    for t in range(S - 1, -1, -1):
        dyt = dy[:, t] + dyr
        dct, dnt = dc + k.a[:, t] * dyt, dn - k.bn[:, t] * dyt
        draw = (k.alpha[:, t] * ex(dct) + k.beta[:, t] * ex(dnt) + k.gamma[:, t] * ex(dyt)
                + k.dgate[:, t] * ex(delta))
        dc, dn, delta = k.fg[:, t] * dct, k.fg[:, t] * dnt, k.keep[:, t] * delta
        draws[t] = draw
        dyr = torch.einsum("bnge,ndge->bnd", draw, r)
    return torch.stack(draws, dim=1), (dyr, dc, dn, delta)


def _dr(y: torch.Tensor, dwx: torch.Tensor, y0: torch.Tensor | None) -> torch.Tensor:
    """dr[h] = sum over b, t of y_{t-1}^T dwx_t, from views without a copy of
    y: a product per head pairs every flat (b, t) row of dwx with the row of
    y before it (one product a head: the library splits its long B S axis,
    which it does not for a batched product, 2-4x slower on the card at S
    1024, B 8); one batched product over the B first steps takes back the
    pairs that cross from one batch row to the next, another adds the
    carried-in y0 (none: zeros)."""
    B, S, NH, DH = y.shape
    yf, gf = y.reshape(B * S, NH, DH), dwx.reshape(B * S, NH, 4 * DH)
    dr = torch.empty((NH, DH, 4 * DH), dtype=dwx.dtype, device=dwx.device)
    for h in range(NH):
        torch.mm(yf[:-1, h].t(), gf[1:, h], out=dr[h])
    g0 = gf.view(B, S, NH, 4 * DH)[:, 0]
    if B > 1:
        dr.baddbmm_(y[:-1, -1].permute(1, 2, 0), g0[1:].permute(1, 0, 2), alpha=-1.0)
    if y0 is not None:
        dr.baddbmm_(y0.permute(1, 2, 0), g0.permute(1, 0, 2))
    return dr.view(NH, DH, 4, DH)


def _bwd_launch(r, saved, dy, state_in, dlast, with_state: bool):
    """The reverse-time kernel on checked CUDA tensors -> dwx (B, S, NH, 4,
    DH), the per-chain sums of dwx over t (B, NH, 4, DH) and, with
    ``with_state``, the initial state's (dy, dc, dn, dm) packed (4, B, NH,
    DH)."""
    B, S, NH, _, DH = saved.shape
    dev = saved.device
    lib = _LIB.load()
    dwx = torch.empty((B, S, NH, 4, DH), device=dev, dtype=torch.float32)
    dbp = torch.empty((B, NH, 4, DH), device=dev, dtype=torch.float32)
    dstate = torch.empty((4, B, NH, DH), device=dev, dtype=torch.float32) if with_state else None
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.slstm_bwd_f32(r.data_ptr(), saved.data_ptr(), dy.data_ptr(), ptr(state_in),
                                ptr(dlast), dwx.data_ptr(), dbp.data_ptr(), ptr(dstate),
                                B, S, NH, DH, stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan_bwd: CUDA error {err}: "
                           f"{lib.slstm_error_string(err).decode()}")
    slstm_scan_bwd.launches += 1
    return dwx, dbp, dstate


def slstm_scan_bwd(r, y, saved, dy, state_in=None, dlast=None, with_state: bool = False):
    """The gradients (dwx, dr, db) of the scan from r (NH, DH, 4, DH), the
    forward's y (B, S, NH, DH) and ``saved`` (B, S, NH, SAVED, DH) as the
    forward kernel wrote it, the output gradient dy and the packed carried-in
    state (4, B, NH, DH) or None. ``dlast``: the packed (4, B, NH, DH)
    gradient of the returned last state (y, c, n, m), or None.
    ``with_state``: a fourth element, the gradient of the initial (y, c, n,
    m). CUDA tensors: one launch of the reverse-time kernel walks every
    (batch row, head) chain, writes dwx, each chain's sum of dwx over t and
    the initial state's gradient; dr is products over views of y and dwx
    (``_dr``) and db the sum of the chains' sums over B, as the JAX package
    leaves dr and db to XLA. Each launch adds one to
    ``slstm_scan_bwd.launches``. CPU tensors take the same recurrence in
    plain torch (``slstm_bwd_coefficients``, ``slstm_bwd_walk_plain``)."""
    B, S, NH, DH = y.shape
    dev = y.device
    y0 = None if state_in is None else state_in[0]
    if dev.type == "cpu":
        coef = slstm_bwd_coefficients(saved, state_in)
        last_cn = None if dlast is None else (saved[:, -1, :, 4].float(), saved[:, -1, :, 5].float())
        dwx, (dy0, dc0, dn0, delta) = slstm_bwd_walk_plain(coef, r, dy, dlast, last_cn)
        dbp = dwx.sum(dim=1)
        c0, n0 = (0.0, 0.0) if state_in is None else state_in[1:3].float()
        dstate = torch.stack([dy0, dc0, dn0, dc0 * c0 + dn0 * n0 + delta])
    else:
        if DH not in KERNEL_DHS:
            raise ValueError(f"slstm_scan_bwd: the CUDA kernel needs head dim in {KERNEL_DHS}, "
                             f"got {DH}")
        chk = lambda name, t, shape: check_tensor("slstm_scan_bwd", name, t, shape, dev)
        r = chk("r", r, (NH, DH, 4, DH))
        saved = chk("saved", saved, (B, S, NH, SAVED, DH))
        dy = chk("dy", dy, (B, S, NH, DH))
        # the kernel stages rows of saved and dy with bulk copies, from 16-byte boundaries
        saved, dy = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (saved, dy))
        state_in = None if state_in is None else chk("state_in", state_in, (4, B, NH, DH))
        dlast = None if dlast is None else chk("dlast", dlast, (4, B, NH, DH))
        dwx, dbp, dstate = _bwd_launch(r, saved, dy, state_in, dlast, with_state)
    out = (dwx, _dr(y.float(), dwx, y0), dbp.sum(dim=0))
    return (*out, tuple(dstate.unbind(0))) if with_state else out


slstm_scan_bwd.launches = 0


class _SlstmFunction(torch.autograd.Function):
    """The forward kernel with the reverse-time kernel as its backward (the
    JAX entry's ``_bwd``, ``jax.vjp`` of the plain scan): the forward writes
    every step's gate values and states to a workspace, the backward reads
    them, so nothing is recomputed by a plain version. ``state`` is the
    carried-in (y, c, n, m), or nothing; with ``return_last`` the outputs
    are y and the last (y, c, n, m). Gradients reach the carried-in state
    and leave the returned one through the same kernel."""

    @staticmethod
    def forward(ctx, wx, r, b, return_last, *state):
        state_in = torch.stack(state) if state else None
        y, last, saved = _launch(wx, r, b, state_in, return_last_state=return_last, save=True)
        ctx.save_for_backward(r, y, saved, state_in)
        ctx.n_state = len(state)
        return (y, *last) if return_last else y

    @staticmethod
    def backward(ctx, dy, *dlast):
        r, y, saved, state_in = ctx.saved_tensors
        dlast = (torch.stack([torch.zeros_like(y[:, 0]) if g is None else g for g in dlast])
                 if dlast and any(g is not None for g in dlast) else None)
        dy = torch.zeros_like(y) if dy is None else dy
        grads = slstm_scan_bwd(r, y, saved, dy, state_in, dlast, with_state=ctx.n_state > 0)
        dstate = grads[3] if ctx.n_state else ()
        return (*grads[:3], None, *dstate)


def slstm_scan_fwd(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
                   initial_state: tuple | None = None, return_last_state: bool = False):
    """Full-sequence sLSTM: y (B, S, NH, DH), plus the last (y, c, n, m)
    with ``return_last_state``. CPU tensors take ``slstm_scan`` (autograd
    differentiates it). CUDA tensors launch the hand-written kernel (fp32,
    head dim 32, 64 or 128, B at most 65535, any S; one launch runs the
    whole time loop, reads ``initial_state`` before the first step and
    writes the last state after the last) or raise; each launch adds one to
    ``slstm_scan_fwd.launches``.

    Gradients on the card: a call that needs them (of the inputs, or of a
    carried ``initial_state``) goes through ``_SlstmFunction``, whose
    backward is the reverse-time kernel (``slstm_scan_bwd``): it takes the
    gradient of the returned last state too, and gives that of the
    carried-in one."""
    if wx.device.type == "cpu":
        return slstm_scan(wx, r, b, initial_state=initial_state,
                          return_last_state=return_last_state)
    B, S, NH, _, DH = wx.shape
    if DH not in KERNEL_DHS:
        raise ValueError(f"slstm_scan_fwd: the CUDA kernel needs head dim in {KERNEL_DHS}, "
                         f"got {DH}")
    if B > 65535:
        raise ValueError(f"slstm_scan_fwd: batch {B} exceeds 65535")
    if wx.device.type != "cuda":
        raise ValueError(f"slstm_scan_fwd: unsupported device {wx.device}")
    dev = wx.device
    wx = check_tensor("slstm_scan_fwd", "wx", wx, (B, S, NH, 4, DH), dev)
    r = check_tensor("slstm_scan_fwd", "r", r, (NH, DH, 4, DH), dev)
    b = check_tensor("slstm_scan_fwd", "b", b, (NH, 4, DH), dev)
    state = () if initial_state is None else tuple(
        check_tensor("slstm_scan_fwd", f"initial_state[{i}]", s, (B, NH, DH), dev)
        for i, s in enumerate(initial_state))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (wx, r, b, *state)):
        out = _SlstmFunction.apply(wx, r, b, return_last_state, *state)
        return (out[0], tuple(out[1:])) if return_last_state else out
    # the kernels take (y, c, n, m) packed as (4, B, NH, DH)
    y, last, _ = _launch(wx, r, b, torch.stack(state) if state else None, return_last_state)
    return (y, last) if return_last_state else y


slstm_scan_fwd.launches = 0


def powerlaw_blockdependent_bias(num_heads: int, head_dim: int, block_idx: int,
                                 num_blocks: int) -> torch.Tensor:
    """f-gate bias init: a per-channel powerlaw ramp, (NH, DH)."""
    ratio = block_idx / (num_blocks - 1) if num_blocks > 1 else 0.0
    x = torch.arange(head_dim, dtype=torch.float32) / max(head_dim - 1, 1)
    init = -(-5.0 + 12.0 * x ** (0.3 + 1.3 * ratio))
    return init[None].repeat(num_heads, 1)
