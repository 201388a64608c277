"""On-device letterbox: resize + pad + normalize as tensor ops.

Port of ``letterbox_device`` in ``xlstm_yolo_tpu/ops/letterbox.py``: uint8
(B, H, W, 3) frames are resized with a dense 2-tap bilinear matrix per axis
(cv2.INTER_LINEAR sampling, no antialias), centered on a 114-gray canvas and
scaled to [0, 1]. Layout stays NHWC, as at the JAX boundary.

``resize`` is ``jax.image.resize`` with the ``linear`` method (also called
``bilinear`` and ``trilinear``) or the ``cubic`` one (``bicubic``), on any
rank: one pass per axis whose size changes, each a dense matrix, the kernel
of ``jax.image.scale_and_translate`` widened by the shrink factor
(antialiased) when it shrinks. ``resize_bilinear`` is its NHWC 2-D case,
the JAX trainer's multi-scale rescale; the position embeddings of
``nn.vil`` resize through it in 1-D, 2-D and 3-D.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) bilinear interpolation matrix: src = (dst + 0.5)
    * scale - 0.5, border clamp. Callers must not write to it."""
    scale = n_in / n_out
    W = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        f = int(np.floor(src))
        t = src - f
        W[o, int(np.clip(f, 0, n_in - 1))] += 1.0 - t
        W[o, int(np.clip(f + 1, 0, n_in - 1))] += t
    return W


@lru_cache(maxsize=64)
def _bilinear_tensor(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype):
    """``_bilinear_matrix`` on ``device``, kept so repeated calls upload
    nothing. Callers must not write to it."""
    return torch.from_numpy(_bilinear_matrix(n_in, n_out)).to(device, dtype)


def _keys_cubic(x):  # jax.image's cubic kernel (Keys, a = -0.5) on |x|
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, ((1.5 * x - 2.5) * x) * x + 1.0)
    return np.where(x >= 2.0, 0.0, w)


_KERNELS = {"linear": lambda x: np.maximum(0.0, 1.0 - x), "cubic": _keys_cubic}


@lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, method: str = "linear") -> np.ndarray:
    """Dense (n_out, n_in) weights of ``jax.image.resize`` with the
    bilinear (``"linear"``) or bicubic (``"cubic"``) method
    (``compute_weight_mat`` of ``scale_and_translate``): half-pixel centres,
    the kernel widened by n_in / n_out when shrinking, each row normalized
    by its sum, and a row whose sample falls outside the input zero. torch's
    own bicubic is another kernel (a = -0.75) without that widening. Callers
    must not write to it."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(n_in)[None, :]) / max(inv_scale, 1.0)
    w = _KERNELS[method](x)
    total = w.sum(1, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


@lru_cache(maxsize=64)
def _resize_tensor(n_in: int, n_out: int, device: torch.device, method: str = "linear"):
    """``_resize_matrix`` on ``device``, kept so repeated calls upload
    nothing. Callers must not write to it."""
    return torch.from_numpy(_resize_matrix(n_in, n_out, method)).to(device)


_METHODS = {"linear": "linear", "bilinear": "linear", "trilinear": "linear",
            "cubic": "cubic", "bicubic": "cubic"}  # jax.image.resize's names


def resize(t: torch.Tensor, shape: tuple, method: str = "linear") -> torch.Tensor:
    """fp32 ``t`` -> ``shape``, as ``jax.image.resize(t, shape, method)``
    for the linear and cubic methods: the axes whose size changes, in
    order, each by its (n_out, n_in) matrix (``_resize_matrix``); an axis
    that keeps its size is left as it is, as JAX leaves it."""
    if method not in _METHODS or len(shape) != t.dim():
        raise ValueError(f"resize: method {method!r} to {tuple(shape)} from {tuple(t.shape)}")
    for axis, n_out in enumerate(shape):
        n_in = t.shape[axis]
        if n_in != n_out:
            m = _resize_tensor(n_in, n_out, t.device, _METHODS[method])
            t = torch.matmul(t.movedim(axis, -1), m.t()).movedim(-1, axis)
    return t


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """fp32 (B, H, W, C) -> (B, height, width, C), as
    ``jax.image.resize(img, (B, height, width, C), "bilinear")``."""
    b, h, w, c = img.shape
    return resize(img, (b, height, width, c))


def letterbox_device(img: torch.Tensor, imgsz: int = 640, fill: float = 114.0,
                     dtype: torch.dtype = torch.float32):
    """Letterbox uint8 (B, H, W, 3) to (B, imgsz, imgsz, 3) in [0, 1].
    Returns (batch, (ratio, pad_x, pad_y)), the host letterbox's meta."""
    b, h, w, c = img.shape
    r = min(imgsz / h, imgsz / w)
    nh, nw = round(h * r), round(w * r)
    x = img.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype)
    x = torch.einsum("Oh,bhwc->bOwc", _bilinear_tensor(h, nh, img.device, dtype), x)
    x = torch.einsum("Ow,bhwc->bhOc", _bilinear_tensor(w, nw, img.device, dtype), x)
    top, left = (imgsz - nh) // 2, (imgsz - nw) // 2
    out = torch.full((b, imgsz, imgsz, c), fill / 255.0, dtype=dtype, device=img.device)
    out[:, top:top + nh, left:left + nw] = x
    return out, (r, float(left), float(top))
