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
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import CudaLibrary, check_tensor

NEG_INIT = -1e30  # initial m: step 1 reduces to m' = i_raw with the f-path
# exactly 0 (exp(NEG_INIT - m') == 0), so n' = exp(0) = 1 and never 0
KERNEL_DHS = (32, 64, 128)  # head dims the CUDA kernel is instantiated for

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = CudaLibrary("slstm.cu", {
    "slstm_fwd_f32": (_I, [_P] * 6 + [_I] * 4 + [_P]),
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


def slstm_scan(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
               initial_state: tuple | None = None, return_last_state: bool = False):
    """Full-sequence sLSTM in plain torch, fp32: y (B, S, NH, DH), plus the
    last (y, c, n, m) with ``return_last_state``."""
    B, S, NH, _, DH = wx.shape
    state = (_initial_state(B, NH, DH, wx.device) if initial_state is None
             else tuple(s.float() for s in initial_state))
    ys = []
    for t in range(S):
        y, state = slstm_step(wx[:, t], r, b, state)
        ys.append(y)
    y = torch.stack(ys, dim=1)
    return (y, state) if return_last_state else y


def slstm_scan_fwd(wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
                   initial_state: tuple | None = None, return_last_state: bool = False):
    """Full-sequence sLSTM: y (B, S, NH, DH), plus the last (y, c, n, m)
    with ``return_last_state``. CPU tensors take ``slstm_scan``. CUDA tensors
    launch the hand-written kernel (fp32, head dim 32, 64 or 128, B at most
    65535, any S; one launch runs the whole time loop, reads
    ``initial_state`` before the first step and writes the last state after
    the last) or raise; each launch adds one to ``slstm_scan_fwd.launches``.

    The kernel has no backward: off the CPU a call that needs gradients
    raises ``NotImplementedError`` rather than return a tensor cut from the
    graph (on the CPU the plain scan is differentiable by autograd)."""
    if wx.device.type == "cpu":
        return slstm_scan(wx, r, b, initial_state=initial_state,
                          return_last_state=return_last_state)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (wx, r, b, *(initial_state or ()))):
        raise NotImplementedError("slstm_scan_fwd: the CUDA kernel has no backward; call it "
                                  "under torch.no_grad() or on CPU tensors")
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
    # the kernel takes (y, c, n, m) packed as (4, B, NH, DH)
    state_in = None if initial_state is None else check_tensor(
        "slstm_scan_fwd", "initial_state", torch.stack(tuple(initial_state)), (4, B, NH, DH), dev)
    lib = _LIB.load()
    y = torch.empty((B, S, NH, DH), device=dev, dtype=torch.float32)
    state_out = torch.empty((4, B, NH, DH), device=dev, dtype=torch.float32) \
        if return_last_state else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.slstm_fwd_f32(wx.data_ptr(), r.data_ptr(), b.data_ptr(),
                                None if state_in is None else state_in.data_ptr(),
                                y.data_ptr(),
                                None if state_out is None else state_out.data_ptr(),
                                B, S, NH, DH, stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan_fwd: CUDA error {err}: "
                           f"{lib.slstm_error_string(err).decode()}")
    slstm_scan_fwd.launches += 1
    return (y, tuple(state_out.unbind(0))) if return_last_state else y


slstm_scan_fwd.launches = 0


def powerlaw_blockdependent_bias(num_heads: int, head_dim: int, block_idx: int,
                                 num_blocks: int) -> torch.Tensor:
    """f-gate bias init: a per-channel powerlaw ramp, (NH, DH)."""
    ratio = block_idx / (num_blocks - 1) if num_blocks > 1 else 0.0
    x = torch.arange(head_dim, dtype=torch.float32) / max(head_dim - 1, 1)
    init = -(-5.0 + 12.0 * x ** (0.3 + 1.3 * ratio))
    return init[None].repeat(num_heads, 1)
