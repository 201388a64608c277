"""Row-wise kth-largest distinct value: plain torch and CUDA.

Port of ``xlstm_yolo_tpu/kernels/topk_pallas.py`` (``rowwise_kth_value``,
kernel ``_kth_kernel``), whose kernel becomes the hand-written CUDA kernel in
``csrc/topk.cu``. For x (R, N) the result (R, 1) fp32 is what k-1 passes leave
as the row max when each pass suppresses EVERY entry equal to the current
max: equal values fall together, so it is the kth largest DISTINCT value, and
``NEG_INF`` (-1e30) for a row with fewer than k distinct values. It is the
threshold of the task-aligned assigner's top-k membership
(``utils.tal.topk_positive_mask``) and differs from ``torch.topk`` wherever
values tie. Entries at or below ``NEG_INF`` count as suppressed.

As in the JAX package, the assigner itself stays on the chain of max and
suppress passes (``rowwise_kth_value_plain``) on every device; the kernel is
an entry of its own.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaLibrary, check_tensor

NEG_INF = -1e30

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = CudaLibrary("topk.cu", {
    "rowwise_kth_value_f32": (_I, [_P, _P, _I, _I, _I, _P]),
    "topk_max_k": (_I, []),
    "topk_error_string": (ctypes.c_char_p, [_I]),
})


def rowwise_kth_value_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's plain version, over the last axis of any (..., N)
    tensor -> (..., 1) fp32: k-1 passes that each suppress every entry equal
    to the row max, then the max."""
    if k < 1:
        raise ValueError(f"rowwise_kth_value: k must be at least 1, got {k}")
    v = x.float()
    for _ in range(k - 1):
        v = torch.where(v >= v.amax(dim=-1, keepdim=True), NEG_INF, v)
    return v.amax(dim=-1, keepdim=True)


def rowwise_kth_value(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (R, N) -> (R, 1) fp32: the kth largest distinct value of each row
    (see the module docstring). CPU tensors take the plain version; CUDA
    tensors launch the hand-written kernel (one read of x; fp32, bf16 and
    fp16 input is cast to fp32 first; k at most ``topk_max_k()`` = 16) or
    raise. Each kernel launch adds one to ``rowwise_kth_value.launches``."""
    if x.dim() != 2:
        raise ValueError(f"rowwise_kth_value: x must be (R, N), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return rowwise_kth_value_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"rowwise_kth_value: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"rowwise_kth_value: x must be float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    R, N = x.shape
    if R == 0 or N == 0:
        raise ValueError(f"rowwise_kth_value: empty input {tuple(x.shape)}")
    lib = _LIB.load()
    if not 1 <= k <= lib.topk_max_k():
        raise ValueError(f"rowwise_kth_value: the CUDA kernel takes k in 1..{lib.topk_max_k()}, "
                         f"got {k}")
    dev = x.device
    xf = check_tensor("rowwise_kth_value", "x", x.float(), (R, N), dev)
    out = torch.empty((R, 1), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.rowwise_kth_value_f32(xf.data_ptr(), out.data_ptr(), R, N, k, stream)
    if err != 0:
        raise RuntimeError(f"rowwise_kth_value: CUDA error {err}: "
                           f"{lib.topk_error_string(err).decode()}")
    rowwise_kth_value.launches += 1
    return out


rowwise_kth_value.launches = 0
