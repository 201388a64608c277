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
it (``slstm_scan_bwd``). Its plain version, ``slstm_scan_bwd_plain``, is the
same reverse recurrence in torch. Both hold the stabilizer m constant: y is
invariant to rescaling every state by exp(m), so these are autograd's
gradients up to rounding.
"""
from __future__ import annotations

import ctypes

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
    "slstm_bwd_f32": (_I, [_P] * 5 + [_I] * 4 + [_P]),
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


def slstm_scan_bwd_plain(wx, r, b, y, states, dy, initial_state: tuple | None = None):
    """The reverse-time kernel's plain version: the gradients (dwx, dr, db)
    of ``slstm_scan`` for the output gradient dy (B, S, NH, DH), from the
    forward's y and per-step states (c, n, m), each (B, S, NH, DH), and the
    carried-in ``initial_state`` (y, c, n, m) it started from (None: zeros,
    m = NEG_INIT). fp32, the stabilizer m held constant. From t = S-1 down to
    0: the step's total y gradient is dy_t plus R draw_{t+1}; from it come
    d(o_raw), dc_t and dn_t, then d(i_raw), d(f_raw) (through logsigmoid)
    and d(z_raw), and the carries dc, dn scaled by the forget gate. dr[h] =
    sum over b, t of y_{t-1}^T draw_t and db = sum of draw. dwx (B, S, NH, 4,
    DH) is draw itself."""
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
    sig_nf = torch.sigmoid(-fraw)
    dc = dn = dyr = torch.zeros((B, NH, DH), dtype=torch.float32, device=wx.device)
    draws = [None] * S
    for t in range(S - 1, -1, -1):
        dyt = dy[:, t] + dyr
        hn = c[:, t] / n[:, t]
        dct = dc + dyt * so[:, t] / n[:, t]
        dnt = dn - dyt * so[:, t] * hn / n[:, t]
        dfg = dct * c_prev[:, t] + dnt * n_prev[:, t]
        dig = dct * tz[:, t] + dnt
        dc, dn = dct * fg[:, t], dnt * fg[:, t]
        draw = torch.stack([dig * ig[:, t], dfg * fg[:, t] * sig_nf[:, t],
                            dct * ig[:, t] * (1 - tz[:, t] ** 2),
                            dyt * hn * so[:, t] * (1 - so[:, t])], dim=2)  # (B, NH, 4, DH)
        draws[t] = draw
        dyr = torch.einsum("bnge,ndge->bnd", draw, r)
    draw = torch.stack(draws, dim=1)
    return draw, torch.einsum("bsnd,bsnge->ndge", y_prev, draw), draw.sum(dim=(0, 1))


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


def slstm_scan_bwd(r, y, saved, dy, state_in=None):
    """The reverse-time kernel and the two sums around it, on CUDA tensors:
    r (NH, DH, 4, DH), the forward's y (B, S, NH, DH) and ``saved`` (B, S,
    NH, SAVED, DH) as the forward kernel wrote them, the output gradient dy
    and the packed carried-in state (4, B, NH, DH) or None -> (dwx, dr,
    db). One launch runs the reverse loop of every (batch row, head) chain
    and writes dwx; dr and db are one einsum and one sum over B and S, as
    the JAX package leaves them to XLA. Each launch adds one to
    ``slstm_scan_bwd.launches``."""
    B, S, NH, DH = y.shape
    dev = y.device
    chk = lambda name, t, shape: check_tensor("slstm_scan_bwd", name, t, shape, dev)
    r = chk("r", r, (NH, DH, 4, DH))
    saved = chk("saved", saved, (B, S, NH, SAVED, DH))
    dy = chk("dy", dy, (B, S, NH, DH))
    lib = _LIB.load()
    dwx = torch.empty((B, S, NH, 4, DH), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.slstm_bwd_f32(r.data_ptr(), saved.data_ptr(), dy.data_ptr(),
                                None if state_in is None else state_in.data_ptr(),
                                dwx.data_ptr(), B, S, NH, DH, stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan_bwd: CUDA error {err}: "
                           f"{lib.slstm_error_string(err).decode()}")
    slstm_scan_bwd.launches += 1
    y0 = torch.zeros_like(y[:, :1]) if state_in is None else state_in[0][:, None]
    y_prev = torch.cat([y0, y[:, :-1]], dim=1)
    return dwx, torch.einsum("bsnd,bsnge->ndge", y_prev, dwx), dwx.sum(dim=(0, 1))


slstm_scan_bwd.launches = 0


class _SlstmFunction(torch.autograd.Function):
    """The forward kernel with the reverse-time kernel as its backward (the
    JAX entry's ``_bwd``, ``jax.vjp`` of the plain scan): the forward writes
    every step's gate values and states to a workspace, the backward reads
    them, so nothing is recomputed by a plain version. A carried-in state is
    a constant here (``slstm_scan_fwd`` refuses one that needs gradients)."""

    @staticmethod
    def forward(ctx, wx, r, b, state_in):
        y, _, saved = _launch(wx, r, b, state_in, return_last_state=False, save=True)
        ctx.save_for_backward(r, y, saved, state_in)
        return y

    @staticmethod
    def backward(ctx, dy):
        r, y, saved, state_in = ctx.saved_tensors
        return (*slstm_scan_bwd(r, y, saved, dy, state_in), None)


def slstm_scan_fwd(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
                   initial_state: tuple | None = None, return_last_state: bool = False):
    """Full-sequence sLSTM: y (B, S, NH, DH), plus the last (y, c, n, m)
    with ``return_last_state``. CPU tensors take ``slstm_scan`` (autograd
    differentiates it). CUDA tensors launch the hand-written kernel (fp32,
    head dim 32, 64 or 128, B at most 65535, any S; one launch runs the
    whole time loop, reads ``initial_state`` before the first step and
    writes the last state after the last) or raise; each launch adds one to
    ``slstm_scan_fwd.launches``.

    Gradients on the card: a call that needs them goes through
    ``_SlstmFunction``, whose backward is the reverse-time kernel
    (``slstm_scan_bwd``). A carried ``initial_state`` enters as a constant;
    one that itself requires grad, and ``return_last_state`` under grad,
    raise ``NotImplementedError`` rather than return a tensor cut from the
    graph (the JAX entry takes neither to its kernel either)."""
    if wx.device.type == "cpu":
        return slstm_scan(wx, r, b, initial_state=initial_state,
                          return_last_state=return_last_state)
    grad = torch.is_grad_enabled()
    if grad and any(s.requires_grad for s in initial_state or ()):
        raise NotImplementedError("slstm_scan_fwd: the gradient of a carried initial_state is "
                                  "not bound to the CUDA kernels; detach it, or use CPU tensors")
    needs_grad = grad and any(t.requires_grad for t in (wx, r, b))
    if needs_grad and return_last_state:
        raise NotImplementedError("slstm_scan_fwd: the gradient through the returned last state "
                                  "is not bound to the CUDA kernels; call it without "
                                  "return_last_state, or on CPU tensors")
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
    # the kernels take (y, c, n, m) packed as (4, B, NH, DH)
    state_in = None if initial_state is None else check_tensor(
        "slstm_scan_fwd", "initial_state", torch.stack([s.detach() for s in initial_state]),
        (4, B, NH, DH), dev)
    if needs_grad:
        return _SlstmFunction.apply(wx, r, b, state_in)
    y, last, _ = _launch(wx, r, b, state_in, return_last_state)
    return (y, last) if return_last_state else y


slstm_scan_fwd.launches = 0


def powerlaw_blockdependent_bias(num_heads: int, head_dim: int, block_idx: int,
                                 num_blocks: int) -> torch.Tensor:
    """f-gate bias init: a per-channel powerlaw ramp, (NH, DH)."""
    ratio = block_idx / (num_blocks - 1) if num_blocks > 1 else 0.0
    x = torch.arange(head_dim, dtype=torch.float32) / max(head_dim - 1, 1)
    init = -(-5.0 + 12.0 * x ** (0.3 + 1.3 * ratio))
    return init[None].repeat(num_heads, 1)
