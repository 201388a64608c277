"""The ViL layer minus the depthwise conv, forward and backward: plain torch
and CUDA.

Port of the layer-fused TPU entry ``mlstm_vil_layer_fused_pallas`` in
``xlstm_yolo_tpu/kernels/mlstm_pallas.py`` (forward kernel
``_kernel_vil_layer``, backward ``_vil_layer_bwd`` around the chunkwise
backward kernel). Given the layer input ``x`` (B, S, DIM) and the activated
conv branch ``conv_act`` (B, S, INNER) it computes

    xn = RMSNorm(x);  x_mlstm, z = split(xn @ wu + bu)
    q, k = headwise(conv_act);  v = headwise(x_mlstm)
    i, f = cat(q, k, v) @ wg + bg                  (one pre-activation per head)
    h = mLSTM(q, k, v, i, f)                       (chunkwise, stabilized)
    out = ((outnorm(h) + skip * conv_act) * silu(z)) @ wd + bd + x

Arguments keep the JAX entry's layouts: ``wu`` (DIM, 2*INNER), headwise
``wq/wk/wv`` (NH, DH_out, DH_in), gate kernels (3*INNER, NH), ``wd`` (INNER,
DIM), and the EFFECTIVE outnorm scale (``1 + scale``).

The middle line is the cell (``kernels.vil_cell``), the last one the tail
(``kernels.vil_block``): the layer is the block function behind RMSNorm and
proj_up, forward and backward, and the formulas live there once.

``vil_layer_ref`` is the plain forward (the CPU path and the kernel's
oracle), ``vil_layer_bwd_ref`` the plain backward. ``vil_layer_fwd`` sends
CPU tensors to the plain versions and CUDA tensors to the hand-written
kernels: the forward in ``csrc/vil_layer.cu``, whose workspace (q/k/v, h,
the gate preacts and the per-chunk carry states) is kept as the saved
activations when gradients are needed, and the backward's products around
the chunkwise backward kernel ``kernels.mlstm_bwd.mlstm_chunkwise_bwd``. It
never falls back from a CUDA tensor to a plain version.
"""
from __future__ import annotations

import torch

from ._build import check_tensor
from .mlstm_bwd import mlstm_chunkwise_bwd_plain
from .vil_block import (N_CELL, _block_plain, block_bwd, tail_kernel_args)
from .vil_cell import (LAYER, Cfg, Member, Workspace, call_member, cell_kernel_args, check_call,
                       run_kernel)


def _norm(x, rms_scale, rms_eps):
    """RMSNorm -> (xhat, inv, xn), fp32."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + rms_eps)
    xhat = xf * inv
    return xhat, inv, xhat * rms_scale


def _head(x, rms_scale, wu, bu, rms_eps):
    """RMSNorm and proj_up -> (xhat, inv, xn, x_mlstm, z), fp32."""
    xhat, inv, xn = _norm(x, rms_scale, rms_eps)
    x_mlstm, z = (xn @ wu + bu).split(wu.shape[1] // 2, dim=-1)
    return xhat, inv, xn, x_mlstm, z


def head_bwd(xhat, inv, xn, nrm, wu, dxm, dz, dres):
    """The gradients of proj_up and RMSNorm from those of x_mlstm, z and the
    residual -> (dx, dnrm, dwu, dbu)."""
    dy2 = torch.cat([dxm, dz], dim=-1)
    dwu = torch.einsum("bsd,bse->de", xn, dy2)
    dbu = dy2.sum((0, 1))
    dxn = dy2 @ wu.t()
    dnrm = (dxn * xhat).sum((0, 1))
    dxhat = dxn * nrm
    dx = inv * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdim=True)) + dres
    return dx, dnrm, dwu, dbu


def _layer_plain(args, cfg: Cfg):
    """Plain forward on the 20 layer arguments -> (out, (h, q, k, v, i_pre,
    f_pre)): RMSNorm and proj_up, then the block function with x as its
    residual. h is the cell output before the outnorm, q/k/v are unscaled,
    all (B, S, INNER); the gate preacts are (B, NH, S)."""
    x, conv_act, rms_scale, wu, bu = args[:5]
    *_, x_mlstm, z = _head(x, rms_scale, wu, bu, cfg.rms_eps)
    return _block_plain((conv_act, x_mlstm, z, x, *args[5:]), cfg)


def vil_layer_ref(x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv,
                  wgi, bgi, wgf, bgf, nscale, nbias, skip, wd, bd, num_heads: int,
                  chunk_size: int = 64, igate_act: str = "exp", eps: float = 1e-6,
                  norm_eps: float = 1e-3, rms_eps: float = 1e-6) -> torch.Tensor:
    """Plain torch ViL layer (the JAX ``_vil_layer_composite``), fp32;
    differentiable by autograd (the JAX package's CPU path)."""
    args = (x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
            nscale, nbias, skip, wd, bd)
    return _layer_plain(args, Cfg(num_heads, chunk_size, igate_act, eps, norm_eps, rms_eps))[0]


def layer_bwd(args, acts, gout, cfg: Cfg, mlstm_bwd):
    """The torch port of ``_vil_layer_bwd``: a cheap recompute of RMSNorm and
    proj_up, the block's backward (tail, then cell around ``mlstm_bwd``),
    then the proj_up and RMSNorm gradients. Returns the gradients of the 20
    layer arguments, in their order."""
    x, conv_act, nrm, wu, bu = args[:5]
    xhat, inv, xn, x_mlstm, z = _head(x, nrm, wu, bu, cfg.rms_eps)
    dconv, dxm, dz, dres, *rest = block_bwd((conv_act, x_mlstm, z, x, *args[5:]), acts, gout,
                                            cfg, mlstm_bwd)
    dx, dnrm, dwu, dbu = head_bwd(xhat, inv, xn, nrm, wu, dxm, dz, dres)
    return (dx, dconv, dnrm, dwu, dbu, *rest)


def vil_layer_bwd_ref(args, acts, gout, num_heads: int, chunk_size: int = 64,
                      igate_act: str = "exp", eps: float = 1e-6, norm_eps: float = 1e-3,
                      rms_eps: float = 1e-6):
    """Plain backward of the layer (the JAX ``_vil_layer_bwd``, frozen
    stabilizer): ``args`` the 20 layer arguments, ``acts`` the activations
    the forward keeps (``h, q, k, v, i_pre, f_pre`` as ``_layer_plain``
    returns them), ``gout`` the output gradient. Returns the 20 gradients."""
    cfg = Cfg(num_heads, chunk_size, igate_act, eps, norm_eps, rms_eps)
    return layer_bwd(args, acts, gout.float(), cfg, mlstm_chunkwise_bwd_plain)


def _launch(args, cfg: Cfg):
    """Launch the forward kernel on CUDA tensors -> (out, acts, carry): the
    saved activations and the per-chunk carry states are views of the
    kernel's workspace, in the layouts ``_layer_plain`` and
    ``mlstm_bwd.CarryStates`` use."""
    x, conv_act, rms_scale, wu, bu = args[:5]
    B, S, DIM = x.shape
    INNER = conv_act.shape[-1]
    lib = check_call("vil_layer_fwd", conv_act, cfg)
    nh, dev = cfg.num_heads, x.device
    chk = lambda name, t, shape: check_tensor("vil_layer_fwd", name, t, shape, dev)
    t = [chk("x", x, (B, S, DIM)), chk("conv_act", conv_act, (B, S, INNER)),
         chk("rms_scale", rms_scale, (DIM,)), chk("wu^T", wu.t(), (2 * INNER, DIM)),
         chk("bu", bu, (2 * INNER,)),
         *cell_kernel_args("vil_layer_fwd", conv_act, *args[5:5 + N_CELL], nh),
         *tail_kernel_args("vil_layer_fwd", conv_act, *args[5 + N_CELL:], DIM)]
    out = torch.empty((B, S, DIM), device=dev, dtype=torch.float32)
    ws = Workspace(lib, LAYER, B, S, INNER, nh, dev)
    run_kernel("vil_layer_fwd", lib, "vil_layer_fwd_f32", [*t, out, ws.buf],
               (B, S, DIM, INNER, nh, int(cfg.igate_act == "exp")),
               (cfg.eps, cfg.norm_eps, cfg.rms_eps), dev)
    vil_layer_fwd.launches += 1
    cell_acts, carry = ws.cell_acts()
    return out, (ws.h(), *cell_acts), carry


_LAYER = Member("vil_layer_fwd", _layer_plain, _launch, layer_bwd)


def vil_layer_fwd(x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv,
                  wgi, bgi, wgf, bgf, nscale, nbias, skip, wd, bd, num_heads: int,
                  chunk_size: int = 64, igate_act: str = "exp", eps: float = 1e-6,
                  norm_eps: float = 1e-3, rms_eps: float = 1e-6) -> torch.Tensor:
    """ViL layer forward. CPU tensors take the plain versions; CUDA tensors
    launch the hand-written kernel (fp32, head dim 64) or raise. Each kernel
    launch adds one to ``vil_layer_fwd.launches``.

    When gradients are needed the call goes through an autograd Function
    whose backward is the hand-written one (frozen-stabilizer gate
    gradients, as on the TPU); on CUDA it runs the chunkwise backward
    kernel on the forward's kept workspace. ``chunk_size`` is read by the
    plain versions only: the kernels walk chunks of ``KERNEL_CS``, and the
    result does not depend on the chunk length beyond rounding."""
    args = (x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv, wgi, bgi,
            wgf, bgf, nscale, nbias, skip, wd, bd)
    return call_member(_LAYER, Cfg(num_heads, chunk_size, igate_act, eps, norm_eps, rms_eps),
                       args)


vil_layer_fwd.launches = 0
