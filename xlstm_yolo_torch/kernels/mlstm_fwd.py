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
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import CudaLibrary, check_tensor
from .mlstm_native import mlstm_chunkwise

KERNEL_DHS = (64, 128, 256)  # head dims the CUDA kernel takes
KERNEL_CS = 64  # its chunk length (CS in csrc/mlstm_fwd.cu)
MAX_ROWS = 65535  # B * NH rows of one launch (a CUDA grid dimension)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = CudaLibrary("mlstm_fwd.cu", {
    "mlstm_fwd_f32": (_I, [_P] * 7 + [_I] * 4 + [_F, _P]),
    "mlstm_fwd_workspace_floats": (ctypes.c_long, [_I] * 3),
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


def mlstm_chunkwise_fwd(q, k, v, i_preact, f_preact, chunk_size: int = 64,
                        igate_act: str = "exp", eps: float = 1e-6) -> torch.Tensor:
    """Chunkwise mLSTM forward, q/k/v (B, NH, S, DH) (q unscaled), gates
    (B, NH, S) -> h (B, NH, S, DH) fp32, any S. CPU tensors take the plain
    version (differentiable by autograd). CUDA tensors launch the
    hand-written kernel (fp32, head dim 64, 128 or 256, B * NH at most
    65535) or raise; each launch adds one to ``mlstm_chunkwise_fwd.launches``.

    ``chunk_size`` is read by the plain version only: the kernel walks
    chunks of ``KERNEL_CS``, and the result does not depend on the chunk
    length beyond rounding. The kernel has no backward bound to it yet: off
    the CPU a call that needs gradients raises ``NotImplementedError``
    rather than return a tensor cut from the graph."""
    if igate_act not in ("exp", "sigmoid"):
        raise ValueError(f"unknown igate_act {igate_act!r}")
    args = (q, k, v, i_preact, f_preact)
    if q.device.type == "cpu":
        return mlstm_chunkwise_fwd_plain(*args, chunk_size=chunk_size, igate_act=igate_act,
                                         eps=eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError("mlstm_chunkwise_fwd: the CUDA kernel has no backward bound "
                                  "to it; call it under torch.no_grad() or on CPU tensors")
    B, NH, S, DH = q.shape
    if DH not in KERNEL_DHS:
        raise ValueError(f"mlstm_chunkwise_fwd: the CUDA kernel needs head dim in "
                         f"{KERNEL_DHS}, got {DH}")
    if B * NH > MAX_ROWS:
        raise ValueError(f"mlstm_chunkwise_fwd: B * NH = {B * NH} exceeds {MAX_ROWS}")
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunkwise_fwd: unsupported device {q.device}")
    dev = q.device
    chk = lambda name, t, shape: check_tensor("mlstm_chunkwise_fwd", name, t, shape, dev)
    t = [chk(n, x, (B, NH, S, DH)) for n, x in (("q", q), ("k", k), ("v", v))]
    t += [chk("i_preact", i_preact, (B, NH, S)), chk("f_preact", f_preact, (B, NH, S))]
    lib = _LIB.load()
    h = torch.empty((B, NH, S, DH), device=dev, dtype=torch.float32)
    ws = torch.empty(lib.mlstm_fwd_workspace_floats(B * NH, S, DH), device=dev,
                     dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mlstm_fwd_f32(*(x.data_ptr() for x in t), h.data_ptr(), ws.data_ptr(),
                                B * NH, S, DH, int(igate_act == "exp"), eps, stream)
    if err != 0:
        raise RuntimeError(f"mlstm_chunkwise_fwd: CUDA error {err}: "
                           f"{lib.mlstm_fwd_error_string(err).decode()}")
    mlstm_chunkwise_fwd.launches += 1
    return h


mlstm_chunkwise_fwd.launches = 0
