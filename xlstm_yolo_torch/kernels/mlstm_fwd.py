"""Chunkwise mLSTM forward on natural head layouts: plain torch and CUDA.

Port of the TPU entry ``mlstm_chunkwise_pallas`` in
``xlstm_yolo_tpu/kernels/mlstm_pallas.py`` (kernel ``_kernel``, chunk step
``_chunk_math``), whose kernel becomes the hand-written CUDA kernel in
``csrc/mlstm_fwd.cu``. The launcher and its plain version live in this
module of their own, beside the golden math in ``kernels/mlstm_native.py``
(``mlstm_chunkwise``, which the plain version calls), so that the golden
module stays free of the build and binding code.

``mlstm_chunkwise_fwd`` takes any sequence length. The JAX entry pads to a
chunk multiple on the host (input-gate preact -40, forget-gate preact +40);
the CUDA kernel masks its last chunk instead, and the plain version
zero-pads at the end: the recurrence is causal, so the padded steps change no
real position either way.

Under autograd on the card the forward kernel is paired with the chunkwise
backward kernel (``kernels/mlstm_bwd.py``) at every head dim it takes, as
the JAX entry's ``_bwd`` pairs them for square heads; on the CPU autograd
differentiates the plain version. Only then does the kernel write the state carried into every
chunk to a workspace, which the backward reads; without gradients the
states stay on chip and the call allocates nothing but h.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import CudaLibrary, check_tensor
from .mlstm_bwd import CarryStates, _heads, _natural, mlstm_chunkwise_bwd
from .mlstm_native import mlstm_chunkwise

KERNEL_DHS = (64, 128, 256)  # head dims the CUDA kernel takes
KERNEL_CS = 64  # its chunk length (CS in csrc/mlstm_fwd.cu)
MAX_ROWS = 65535  # B * NH rows of one launch (a CUDA grid dimension)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = CudaLibrary("mlstm_fwd.cu", {
    "mlstm_fwd_f32": (_I, [_P] * 7 + [_I] * 4 + [_F, _P]),
    "mlstm_fwd_workspace_layout": (None, [_I] * 3 + [ctypes.POINTER(ctypes.c_long)]),
    "mlstm_fwd_error_string": (ctypes.c_char_p, [_I]),
})


def mlstm_chunkwise_fwd_plain(q, k, v, i_preact, f_preact, chunk_size: int = 64,
                              igate_act: str = "exp", eps: float = 1e-6) -> torch.Tensor:
    """The kernel's plain version: ``mlstm_chunkwise`` on a copy zero-padded
    at the end to a multiple of ``min(chunk_size, S)``. q/k/v (B, NH, S, DH),
    gates (B, NH, S) -> h (B, NH, S, DH) fp32."""
    S = q.shape[2]
    cs = min(chunk_size, S)
    pad = (-S) % cs
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        i_preact, f_preact = F.pad(i_preact, (0, pad)), F.pad(f_preact, (0, pad))
    h = mlstm_chunkwise(q, k, v, i_preact, f_preact, chunk_size=cs, igate_act=igate_act, eps=eps)
    return h[:, :, :S] if pad else h


def _launch(q, k, v, i_preact, f_preact, igate_act: str, eps: float, states: bool = False):
    """Launch the kernel on checked CUDA tensors -> (h, ws, off). With
    ``states`` the kernel also writes the state carried into every chunk to
    ``ws`` (``_carry_states`` views it, at the offsets ``off``); without, it
    keeps them on chip and ``ws`` and ``off`` are None."""
    B, NH, S, DH = q.shape
    dev = q.device
    chk = lambda name, t, shape: check_tensor("mlstm_chunkwise_fwd", name, t, shape, dev)
    t = [chk(n, x, (B, NH, S, DH)) for n, x in (("q", q), ("k", k), ("v", v))]
    t += [chk("i_preact", i_preact, (B, NH, S)), chk("f_preact", f_preact, (B, NH, S))]
    lib = _LIB.load()
    ws = off = None
    if states:
        off = (ctypes.c_long * 6)()
        lib.mlstm_fwd_workspace_layout(B * NH, S, DH, off)
        ws = torch.empty(off[5], device=dev, dtype=torch.float32)
    h = torch.empty((B, NH, S, DH), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mlstm_fwd_f32(*(x.data_ptr() for x in t), h.data_ptr(),
                                None if ws is None else ws.data_ptr(),
                                B * NH, S, DH, int(igate_act == "exp"), eps, stream)
    if err != 0:
        raise RuntimeError(f"mlstm_chunkwise_fwd: CUDA error {err}: "
                           f"{lib.mlstm_fwd_error_string(err).decode()}")
    mlstm_chunkwise_fwd.launches += 1
    return h, ws, off


def _carry_states(ws, off, rows: int, S: int, DH: int) -> CarryStates:
    """Views of the forward kernel's workspace in the layout the chunkwise
    backward reads (``mlstm_fwd_workspace_layout``: C, n, btot, mloc, m)."""
    ns = -(-S // KERNEL_CS)
    c, n, btot, mloc, m = (ws[off[j]:off[j + 1]].view(rows, ns, *tail)
                           for j, tail in enumerate(((DH, DH), (DH,), (), (), ())))
    return CarryStates(c, n, m, btot, mloc)


def mlstm_chunkwise_bwd_heads(q, k, v, i_preact, f_preact, dh, carry: CarryStates | None = None,
                             chunk_size: int = KERNEL_CS, igate_act: str = "exp",
                             eps: float = 1e-6):
    """The chunkwise backward on the forward's layouts: q/k/v/dh (B, NH, S,
    DH), gates (B, NH, S) -> (dq, dk, dv (B, NH, S, DH), di, df (B, NH, S)),
    frozen-stabilizer gradients. ``mlstm_chunkwise_bwd`` takes the ViL
    layer's natural (B, S, NH*DH) layout, so q, k, v and dh are laid out anew
    on the way in and the gradients are views on the way out. CUDA tensors
    launch the backward kernel on ``carry``, the forward kernel's states; CPU
    tensors take its plain version (``carry`` unused)."""
    nh = q.shape[1]
    nat = lambda t: _natural(t.float()).contiguous()
    dq, dk, dv, di, df = mlstm_chunkwise_bwd(
        nat(q), nat(k), nat(v), i_preact.contiguous(), f_preact.contiguous(), nat(dh), nh,
        carry=carry, chunk_size=chunk_size, igate_act=igate_act, eps=eps)
    return _heads(dq, nh), _heads(dk, nh), _heads(dv, nh), di, df


class _ChunkwiseFunction(torch.autograd.Function):
    """The forward kernel with the chunkwise backward kernel as its
    backward (the JAX entry's ``_bwd`` for square heads): the backward reads
    the carry states the forward left in its workspace, so nothing is
    recomputed by a plain version."""

    @staticmethod
    def forward(ctx, q, k, v, i_preact, f_preact, igate_act, eps):
        h, ws, off = _launch(q, k, v, i_preact, f_preact, igate_act, eps, states=True)
        B, NH, S, DH = q.shape
        ctx.save_for_backward(q, k, v, i_preact, f_preact,
                              *_carry_states(ws, off, B * NH, S, DH))
        ctx.igate_act, ctx.eps = igate_act, eps
        return h

    @staticmethod
    def backward(ctx, dh):
        *args, c, n, m, btot, mloc = ctx.saved_tensors
        grads = mlstm_chunkwise_bwd_heads(*args, dh, carry=CarryStates(c, n, m, btot, mloc),
                                          igate_act=ctx.igate_act, eps=ctx.eps)
        return (*grads, None, None)


def mlstm_chunkwise_fwd(q, k, v, i_preact, f_preact, chunk_size: int = 64,
                        igate_act: str = "exp", eps: float = 1e-6) -> torch.Tensor:
    """Chunkwise mLSTM forward, q/k/v (B, NH, S, DH) (q unscaled), gates
    (B, NH, S) -> h (B, NH, S, DH) fp32, any S. CPU tensors take the plain
    version (differentiable by autograd). CUDA tensors launch the
    hand-written kernel (fp32, head dim 64, 128 or 256, B * NH at most
    65535) or raise; each launch adds one to ``mlstm_chunkwise_fwd.launches``.

    ``chunk_size`` is read by the plain version only: the kernel walks
    chunks of ``KERNEL_CS``, and the result does not depend on the chunk
    length beyond rounding.

    Gradients on the card: a call that needs them goes through an autograd
    Function whose backward is the chunkwise backward kernel
    (``kernels.mlstm_bwd.mlstm_chunkwise_bwd``, frozen-stabilizer gate
    gradients, as on the TPU) at the same head dim, reading the carry states
    the forward kernel left in its workspace."""
    if igate_act not in ("exp", "sigmoid"):
        raise ValueError(f"unknown igate_act {igate_act!r}")
    args = (q, k, v, i_preact, f_preact)
    if q.device.type == "cpu":
        return mlstm_chunkwise_fwd_plain(*args, chunk_size=chunk_size, igate_act=igate_act,
                                         eps=eps)
    B, NH, S, DH = q.shape
    if DH not in KERNEL_DHS:
        raise ValueError(f"mlstm_chunkwise_fwd: the CUDA kernel needs head dim in "
                         f"{KERNEL_DHS}, got {DH}")
    if B * NH > MAX_ROWS:
        raise ValueError(f"mlstm_chunkwise_fwd: B * NH = {B * NH} exceeds {MAX_ROWS}")
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunkwise_fwd: unsupported device {q.device}")
    if needs_grad:
        return _ChunkwiseFunction.apply(*args, igate_act, eps)
    return _launch(*args, igate_act, eps)[0]


mlstm_chunkwise_fwd.launches = 0
