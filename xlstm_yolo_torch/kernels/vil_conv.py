"""The whole ViL layer, the depthwise conv included, forward and backward:
plain torch and CUDA.

Port of the conv-fused TPU entry ``mlstm_vil_layer_conv_fused_pallas`` in
``xlstm_yolo_tpu/kernels/mlstm_pallas.py`` (forward kernel
``_kernel_vil_conv``, composite ``_vil_conv_composite``, backward
``_vil_conv_bwd``). Given the layer input ``x`` (B, S = H*W, DIM) alone it
computes

    xn = RMSNorm(x);  x_mlstm, z = split(xn @ wu + bu)
    conv_act = silu(conv3x3_depthwise(x_mlstm on the (H, W) grid) + bc)
    out = the layer function of (x, conv_act)        (kernels.vil_layer)

so x is the only activation read and out the only one written. The conv
zero-pads its INPUT: x_mlstm of a position outside the grid counts as 0,
not as the bias a zero row of x would give. Arguments keep the JAX entry's
layouts (see ``kernels.vil_layer``) except the conv kernel ``wc``, which
arrives as the port's ``nn.Conv2d`` weight (INNER, 1, 3, 3) (the JAX entry
takes flax's HWIO (3, 3, 1, INNER)). A layer that walks the sequence
backward hands in the flipped sequence, so the conv sees the flipped
sequence laid on the grid, as in the JAX package.

``vil_layer_conv_plain`` is the plain forward (the CPU path and the kernel's
oracle). ``vil_layer_conv_fwd`` sends CPU tensors to the plain versions and
CUDA tensors to the hand-written kernels in ``csrc/vil_layer.cu`` (conv,
norm and projections included: no library convolution or matrix product runs
in the forward on the card), whose workspace (x_mlstm, conv_act, z, q/k/v,
h, the gate preacts and the per-chunk carry states) is kept as the saved
activations when gradients are needed. The backward is the layer's
hand-written one (tail, cell around the chunkwise backward kernel, head)
with the conv's and SiLU's gradients between, as torch ops: the JAX package
differentiates its composite there and has no backward kernel either.
x_mlstm feeds both v and the conv, so its gradient sums the two paths. It
never falls back from a CUDA tensor to a plain version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_tensor
from .vil_block import N_CELL, _block_plain, block_bwd, tail_kernel_args
from .vil_cell import (CONV, Cfg, Member, Workspace, call_member, cell_kernel_args, check_call,
                       run_kernel)
from .vil_layer import _head, _norm, head_bwd

N_HEAD = 6  # x, rms_scale, wu, bu, wc, bc: a call's arguments before the cell's


def _grid(t, seqlens):  # (B, S, INNER) -> (B, INNER, H, W), token h*W + w at (h, w)
    B, S, INNER = t.shape
    return t.transpose(1, 2).reshape(B, INNER, *seqlens)


def _conv_pre(x_mlstm, wc, bc, seqlens):
    """The depthwise 3x3 conv of x_mlstm (B, S, INNER) on the token grid,
    before its SiLU -> (B, S, INNER)."""
    B, S, INNER = x_mlstm.shape
    y = F.conv2d(_grid(x_mlstm, seqlens), wc, bc, padding=1, groups=INNER)
    return y.reshape(B, INNER, S).transpose(1, 2)


def _check_grid(where: str, x, wc, seqlens):
    if seqlens is None or len(seqlens) != 2 or seqlens[0] * seqlens[1] != x.shape[1]:
        raise ValueError(f"{where}: seqlens {seqlens} is no (H, W) grid of S={x.shape[1]} tokens")
    if tuple(wc.shape[1:]) != (1, 3, 3):
        raise ValueError(f"{where}: wc must be a depthwise 3x3 kernel (INNER, 1, 3, 3), "
                         f"got {tuple(wc.shape)}")


def _conv_plain(args, cfg: Cfg):
    """Plain forward on the 21 arguments -> (out, (h, q, k, v, i_pre, f_pre,
    x_mlstm, z, conv_act)): RMSNorm, proj_up, the conv and its SiLU, then the
    block function with x as its residual."""
    x, rms_scale, wu, bu, wc, bc = args[:N_HEAD]
    _check_grid("vil_layer_conv_fwd", x, wc, cfg.seqlens)
    *_, x_mlstm, z = _head(x, rms_scale, wu, bu, cfg.rms_eps)
    conv_act = F.silu(_conv_pre(x_mlstm, wc, bc, cfg.seqlens))
    out, acts = _block_plain((conv_act, x_mlstm, z, x, *args[N_HEAD:]), cfg)
    return out, (*acts, x_mlstm, z, conv_act)


def vil_layer_conv_plain(x, rms_scale, wu, bu, wc, bc, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf,
                         bgf, nscale, nbias, skip, wd, bd, num_heads: int, seqlens: tuple,
                         chunk_size: int = 64, igate_act: str = "exp", eps: float = 1e-6,
                         norm_eps: float = 1e-3, rms_eps: float = 1e-6) -> torch.Tensor:
    """Plain torch conv-fused ViL layer (the JAX ``_vil_conv_composite``),
    fp32; differentiable by autograd (the JAX package's CPU path)."""
    args = (x, rms_scale, wu, bu, wc, bc, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
            nscale, nbias, skip, wd, bd)
    cfg = Cfg(num_heads, chunk_size, igate_act, eps, norm_eps, rms_eps, tuple(seqlens))
    return _conv_plain(args, cfg)[0]


def conv_layer_bwd(args, acts, gout, cfg: Cfg, mlstm_bwd):
    """The conv-fused layer's backward (frozen stabilizer): the block's
    (tail, then cell around ``mlstm_bwd``) on the kept activations, the
    SiLU's and the conv's gradients, then proj_up's and RMSNorm's. ``args``
    the 21 arguments, ``acts`` = (h, q, k, v, i_pre, f_pre, x_mlstm, z,
    conv_act). Returns the 21 gradients, in order."""
    x, nrm, wu, bu, wc, bc = args[:N_HEAD]
    x_mlstm, z, conv_act = acts[6:]
    dconv, dxm, dz, dres, *rest = block_bwd((conv_act, x_mlstm, z, x, *args[N_HEAD:]), acts[:6],
                                            gout, cfg, mlstm_bwd)
    INNER = x_mlstm.shape[-1]
    pre = _conv_pre(x_mlstm, wc, bc, cfg.seqlens)
    sig = torch.sigmoid(pre)
    dpre = dconv * (sig * (1.0 + pre * (1.0 - sig)))
    img, dimg = _grid(x_mlstm, cfg.seqlens), _grid(dpre, cfg.seqlens).contiguous()
    dimg_in = torch.nn.grad.conv2d_input(img.shape, wc, dimg, padding=1, groups=INNER)
    dwc = torch.nn.grad.conv2d_weight(img, wc.shape, dimg, padding=1, groups=INNER)
    dxm = dxm + dimg_in.reshape(*dimg_in.shape[:2], -1).transpose(1, 2)
    dx, dnrm, dwu, dbu = head_bwd(*_norm(x, nrm, cfg.rms_eps), nrm, wu, dxm, dz, dres)
    return (dx, dnrm, dwu, dbu, dwc, dpre.sum((0, 1)), *rest)


def _launch(args, cfg: Cfg):
    """Launch the conv-fused kernels on CUDA tensors -> (out, acts, carry):
    the saved activations and the per-chunk carry states are views of the
    kernels' workspace, in the layouts ``_conv_plain`` and
    ``mlstm_bwd.CarryStates`` use."""
    where = "vil_layer_conv_fwd"
    x, rms_scale, wu, bu, wc, bc = args[:N_HEAD]
    _check_grid(where, x, wc, cfg.seqlens)
    B, S, DIM = x.shape
    INNER = wc.shape[0]
    like_conv = x.new_empty((0, INNER))  # what the shared argument checks read: width, device
    lib = check_call(where, like_conv, cfg)
    nh, dev = cfg.num_heads, x.device
    chk = lambda name, t, shape: check_tensor(where, name, t, shape, dev)
    t = [chk("x", x, (B, S, DIM)), chk("rms_scale", rms_scale, (DIM,)),
         chk("wu^T", wu.t(), (2 * INNER, DIM)), chk("bu", bu, (2 * INNER,)),
         chk("wc", wc, (INNER, 1, 3, 3)).reshape(INNER, 9).t().contiguous(),  # (tap, channel)
         chk("bc", bc, (INNER,)),
         *cell_kernel_args(where, like_conv, *args[N_HEAD:N_HEAD + N_CELL], nh),
         *tail_kernel_args(where, like_conv, *args[N_HEAD + N_CELL:], DIM)]
    out = torch.empty((B, S, DIM), device=dev, dtype=torch.float32)
    ws = Workspace(lib, CONV, B, S, INNER, nh, dev)
    run_kernel(where, lib, "vil_layer_conv_fwd_f32", [*t, out, ws.buf],
               (B, S, DIM, INNER, nh, int(cfg.igate_act == "exp"), *cfg.seqlens),
               (cfg.eps, cfg.norm_eps, cfg.rms_eps), dev)
    vil_layer_conv_fwd.launches += 1
    cell_acts, carry = ws.cell_acts()
    return out, (ws.h(), *cell_acts, *ws.conv_acts()), carry


_CONV = Member("vil_layer_conv_fwd", _conv_plain, _launch, conv_layer_bwd)


def vil_layer_conv_fwd(x, rms_scale, wu, bu, wc, bc, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf,
                       bgf, nscale, nbias, skip, wd, bd, num_heads: int, seqlens: tuple,
                       chunk_size: int = 64, igate_act: str = "exp", eps: float = 1e-6,
                       norm_eps: float = 1e-3, rms_eps: float = 1e-6) -> torch.Tensor:
    """Conv-fused ViL layer forward, ``seqlens`` the (H, W) token grid. CPU
    tensors take the plain versions; CUDA tensors launch the hand-written
    kernels (fp32, head dim 64) or raise. Each call that launches them adds
    one to ``vil_layer_conv_fwd.launches``. Gradients and ``chunk_size`` as
    in ``vil_layer.vil_layer_fwd``."""
    args = (x, rms_scale, wu, bu, wc, bc, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
            nscale, nbias, skip, wd, bd)
    cfg = Cfg(num_heads, chunk_size, igate_act, eps, norm_eps, rms_eps, tuple(seqlens))
    return call_member(_CONV, cfg, args)


vil_layer_conv_fwd.launches = 0
