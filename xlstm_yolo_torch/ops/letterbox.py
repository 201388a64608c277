"""On-device letterbox: resize + pad + normalize as tensor ops.

Port of ``letterbox_device`` in ``xlstm_yolo_tpu/ops/letterbox.py``: uint8
(B, H, W, 3) frames are resized with a dense 2-tap bilinear matrix per axis
(cv2.INTER_LINEAR sampling, no antialias), centered on a 114-gray canvas and
scaled to [0, 1]. Layout stays NHWC, as at the JAX boundary.

``resize_bilinear`` is ``jax.image.resize(..., "bilinear")`` (the JAX
trainer's multi-scale rescale) as two dense matrices: the triangle kernel
of ``jax.image.scale_and_translate``, widened by the shrink factor
(antialiased) when it shrinks.
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


@lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) weights of ``jax.image.resize`` with the
    bilinear method (``compute_weight_mat`` of ``scale_and_translate``):
    half-pixel centres, the triangle kernel widened by n_in / n_out when
    shrinking, each row normalized by its sum, and a row whose sample falls
    outside the input zero. Callers must not write to it."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(n_in)[None, :]) / max(inv_scale, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(1, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


@lru_cache(maxsize=64)
def _resize_tensor(n_in: int, n_out: int, device: torch.device):
    """``_resize_matrix`` on ``device``, kept so repeated calls upload
    nothing. Callers must not write to it."""
    return torch.from_numpy(_resize_matrix(n_in, n_out)).to(device)


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """fp32 (B, H, W, C) -> (B, height, width, C), as
    ``jax.image.resize(img, (B, height, width, C), "bilinear")``."""
    b, h, w, c = img.shape
    x = torch.einsum("Oh,bhwc->bOwc", _resize_tensor(h, height, img.device), img)
    return torch.einsum("Ow,bhwc->bhOc", _resize_tensor(w, width, img.device), x)


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
