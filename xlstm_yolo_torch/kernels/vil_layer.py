"""The ViL layer forward minus the depthwise conv: plain torch and CUDA.

Port of the layer-fused TPU entry ``mlstm_vil_layer_fused_pallas`` in
``xlstm_yolo_tpu/kernels/mlstm_pallas.py`` (kernel ``_kernel_vil_layer``).
Given the layer input ``x`` (B, S, DIM) and the activated conv branch
``conv_act`` (B, S, INNER) it computes

    xn = RMSNorm(x);  x_mlstm, z = split(xn @ wu + bu)
    q, k = headwise(conv_act);  v = headwise(x_mlstm)
    i, f = cat(q, k, v) @ wg + bg                  (one pre-activation per head)
    h = mLSTM(q, k, v, i, f)                       (chunkwise, stabilized)
    out = ((outnorm(h) + skip * conv_act) * silu(z)) @ wd + bd + x

Arguments keep the JAX entry's layouts: ``wu`` (DIM, 2*INNER), headwise
``wq/wk/wv`` (NH, DH_out, DH_in), gate kernels (3*INNER, NH), ``wd`` (INNER,
DIM), and the EFFECTIVE outnorm scale (``1 + scale``).

``vil_layer_ref`` is the plain version (the CPU path and the kernel's
oracle). ``vil_layer_fwd`` sends CPU tensors to it and CUDA tensors to the
hand-written kernel in ``csrc/vil_layer.cu``; it never falls back from a
CUDA tensor to the plain version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import CudaLibrary
from .mlstm_native import mlstm_chunkwise

KERNEL_DH = 64  # head dim the CUDA kernel is written for
KERNEL_CS = 64  # chunk length the CUDA kernel fixes (CS in csrc/vil_layer.cu)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = CudaLibrary("vil_layer.cu", {
    "vil_layer_fwd_f32": (_I, [_P] * 22 + [_I] * 6 + [_F] * 3 + [_P]),
    "vil_layer_workspace_floats": (ctypes.c_long, [_I] * 4),
    "vil_layer_prologue_smem": (ctypes.c_long, [_I] * 2),
    "vil_layer_error_string": (ctypes.c_char_p, [_I]),
})


def vil_layer_ref(x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv,
                  wgi, bgi, wgf, bgf, nscale, nbias, skip, wd, bd, num_heads: int,
                  chunk_size: int = 64, igate_act: str = "exp", eps: float = 1e-6,
                  norm_eps: float = 1e-3, rms_eps: float = 1e-6) -> torch.Tensor:
    """Plain torch ViL layer (the JAX ``_vil_layer_composite``), fp32. A
    sequence that is not a chunk multiple is zero-padded at the end; the
    recurrence is causal, so the padded steps change no real position."""
    B, S, DIM = x.shape
    INNER = conv_act.shape[-1]
    nh = num_heads
    dh = INNER // nh
    f32 = torch.float32
    xf = x.to(f32)
    xn = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + rms_eps) * rms_scale
    x_mlstm, z = (xn @ wu + bu).split(INNER, dim=-1)

    def headwise(t, w, b):  # (B, S, INNER) -> (B, NH, S, DH)
        y = torch.einsum("bsnd,nod->bnso", t.reshape(B, S, nh, dh), w)
        return y + b.reshape(1, nh, 1, dh)

    q = headwise(conv_act.to(f32), wq, bq)
    k = headwise(conv_act.to(f32), wk, bk)
    v = headwise(x_mlstm, wv, bv)

    def gate(w, b):  # split dots over cat(q, k, v) -> (B, NH, S)
        nat = lambda t: t.transpose(1, 2).reshape(B, S, INNER)
        y = nat(q) @ w[:INNER] + nat(k) @ w[INNER:2 * INNER] + nat(v) @ w[2 * INNER:] + b
        return y.transpose(1, 2)

    i_pre, f_pre = gate(wgi, bgi), gate(wgf, bgf)
    cs = min(chunk_size, S)
    pad = (-S) % cs
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        i_pre, f_pre = F.pad(i_pre, (0, pad)), F.pad(f_pre, (0, pad))
    h = mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk_size=cs, igate_act=igate_act,
                        eps=eps)[:, :, :S]
    mu = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, unbiased=False)
    hn = (h - mu) * torch.rsqrt(var + norm_eps)
    hn = hn * nscale.reshape(1, nh, 1, dh) + nbias.reshape(1, nh, 1, dh)
    hn = hn.transpose(1, 2).reshape(B, S, INNER)
    y = (hn + skip * conv_act) * F.silu(z)
    return y @ wd + bd + xf


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"vil_layer_fwd: {name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"vil_layer_fwd: {name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"vil_layer_fwd: {name} has shape {tuple(t.shape)}, expected {shape}")
    return t.contiguous()


def vil_layer_fwd(x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv,
                  wgi, bgi, wgf, bgf, nscale, nbias, skip, wd, bd, num_heads: int,
                  chunk_size: int = 64, igate_act: str = "exp", eps: float = 1e-6,
                  norm_eps: float = 1e-3, rms_eps: float = 1e-6) -> torch.Tensor:
    """ViL layer forward. CPU tensors take ``vil_layer_ref``; CUDA tensors
    launch the hand-written kernel (fp32, head dim 64) or raise. Each kernel
    launch adds one to ``vil_layer_fwd.launches``.

    ``chunk_size`` is read by the plain version only: the kernel always
    walks chunks of ``KERNEL_CS``, and the result does not depend on the
    chunk length beyond rounding. The kernel has no backward yet, so off the
    CPU a call that would need gradients raises instead of returning a
    tensor cut from the graph."""
    args = (x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv, wgi, bgi,
            wgf, bgf, nscale, nbias, skip, wd, bd)
    if (x.device.type != "cpu" and torch.is_grad_enabled()
            and any(a.requires_grad for a in args)):
        raise NotImplementedError(
            "vil_layer_fwd: the ViL layer kernel has no backward yet; run the forward "
            "under torch.no_grad() or torch.inference_mode(), or on the CPU")
    if x.device.type == "cpu":
        return vil_layer_ref(*args, num_heads, chunk_size=chunk_size, igate_act=igate_act,
                             eps=eps, norm_eps=norm_eps, rms_eps=rms_eps)
    if x.device.type != "cuda":
        raise ValueError(f"vil_layer_fwd: unsupported device {x.device}")
    if igate_act not in ("exp", "sigmoid"):
        raise ValueError(f"unknown igate_act {igate_act!r}")
    B, S, DIM = x.shape
    INNER = conv_act.shape[-1]
    nh = num_heads
    if INNER != nh * KERNEL_DH:
        raise ValueError(f"vil_layer_fwd: the CUDA kernel needs head dim {KERNEL_DH}, "
                         f"got INNER={INNER} over {nh} heads")
    dev = x.device
    lib = _LIB.load()
    smem = lib.vil_layer_prologue_smem(DIM, INNER)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"vil_layer_fwd: DIM={DIM}, INNER={INNER} needs {smem} B of shared "
                         f"memory per block, the device allows {limit}")
    dh = KERNEL_DH
    t = [
        _check("x", x, (B, S, DIM), dev),
        _check("conv_act", conv_act, (B, S, INNER), dev),
        _check("rms_scale", rms_scale, (DIM,), dev),
        _check("wu", wu, (DIM, 2 * INNER), dev),
        _check("bu", bu, (2 * INNER,), dev),
        # headwise weights as (NH, DH_in, DH_out): the kernel's loads along
        # the output index are then coalesced
        _check("wq", wq, (nh, dh, dh), dev).transpose(1, 2).contiguous(),
        _check("wk", wk, (nh, dh, dh), dev).transpose(1, 2).contiguous(),
        _check("wv", wv, (nh, dh, dh), dev).transpose(1, 2).contiguous(),
        _check("bq", bq, (INNER,), dev),
        _check("bk", bk, (INNER,), dev),
        _check("bv", bv, (INNER,), dev),
        _check("wgi", wgi, (3 * INNER, nh), dev).t().contiguous(),
        _check("bgi", bgi, (nh,), dev),
        _check("wgf", wgf, (3 * INNER, nh), dev).t().contiguous(),
        _check("bgf", bgf, (nh,), dev),
        _check("nscale", nscale, (INNER,), dev),
        _check("nbias", nbias, (INNER,), dev),
        _check("skip", skip, (INNER,), dev),
        _check("wd", wd, (INNER, DIM), dev),
        _check("bd", bd, (DIM,), dev),
    ]
    out = torch.empty((B, S, DIM), device=dev, dtype=torch.float32)
    ws = torch.empty(lib.vil_layer_workspace_floats(B, S, INNER, nh), device=dev,
                     dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.vil_layer_fwd_f32(*(a.data_ptr() for a in t), out.data_ptr(), ws.data_ptr(),
                                    B, S, DIM, INNER, nh, int(igate_act == "exp"),
                                    eps, norm_eps, rms_eps, stream)
    if err != 0:
        raise RuntimeError(f"vil_layer_fwd: CUDA error {err}: "
                           f"{lib.vil_layer_error_string(err).decode()}")
    vil_layer_fwd.launches += 1
    return out


vil_layer_fwd.launches = 0
