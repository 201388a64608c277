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
DIM), and the EFFECTIVE outnorm scale (``1 + scale``). ``use_outnorm=False``
drops the outnorm from the last line (``nscale``, ``nbias`` unread, may be
None), on the card too: the kernels' tail adds h itself.

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
from .mlstm_bwd import KERNEL_CS, CarryStates, mlstm_chunkwise_bwd_plain
from .mlstm_native import mm_f32, mm_round
from .vil_block import (N_CELL, TAIL_ARGS, _block_plain, block_bwd, tail_kernel_args,
                        tail_plain)
from .vil_cell import (CELL_ARGS, LAYER, LAYER_BF16, Cfg, Member, Workspace, _cell_plain,
                       call_member, cell_kernel_args, check_call, register_op, run_kernel)

# the names of the forward's launches, as a profiler trace shows them: the fp32
# stages, and the prefix of the bf16 ones
STAGES = ("vil_head", "vil_cell_prologue", "vil_chunk_summary", "vil_state_scan",
          "vil_chunk_output", "vil_epilogue")
STAGES_BF16 = "vil16_"


def _norm(x, rms_scale, rms_eps):
    """RMSNorm -> (xhat, inv, xn), fp32."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + rms_eps)
    xhat = xf * inv
    return xhat, inv, xhat * rms_scale.float()


def _head(x, rms_scale, wu, bu, rms_eps, recompute: bool = False):
    """RMSNorm and proj_up -> (xhat, inv, xn, x_mlstm, z). fp32 x: fp32.
    bf16 x, as the JAX layer computes it at bf16: the forward (the TPU
    kernel) rounds rms_scale, proj_up's weight and bias and the product's
    operands to bf16 and keeps x_mlstm and z in fp32; the backward's
    ``recompute`` (``_vil_layer_bwd``) rounds xn to bf16 and takes the
    product and the bias sum in bf16, so x_mlstm and z are bf16."""
    cd = x.dtype
    R = lambda t: mm_round(t, cd)
    if cd == torch.float32:
        xhat, inv, xn = _norm(x, rms_scale, rms_eps)
        y = xn @ wu + bu
    elif recompute:
        xhat, inv, xn = _norm(x, rms_scale, rms_eps)
        xn = xn.to(cd)
        y = (xn.float() @ R(wu)).to(cd) + bu.to(cd)
    else:
        xhat, inv, xn = _norm(x, R(rms_scale), rms_eps)
        y = R(xn) @ R(wu) + R(bu)
    x_mlstm, z = y.split(wu.shape[1] // 2, dim=-1)
    return xhat, inv, xn, x_mlstm, z


def head_bwd(xhat, inv, xn, nrm, wu, dxm, dz, dres):
    """The gradients of proj_up and RMSNorm from those of x_mlstm, z and the
    residual -> (dx, dnrm, dwu, dbu), fp32. ``xn`` as ``_head(recompute=
    True)`` gives it: bf16 under AMP, and then the two products take bf16
    operands (dz rounded to bf16, as the JAX backward casts it)."""
    cd = xn.dtype
    R = lambda t: mm_round(t, cd)
    dy2 = torch.cat([R(dxm), R(dz)], dim=-1)
    flat = dy2.reshape(-1, dy2.shape[-1])
    dwu = mm_f32(xn.reshape(-1, xn.shape[-1]).t(), flat, cd)
    dbu = dy2.sum((0, 1))
    dxn = mm_f32(flat, wu.t(), cd).reshape(*dy2.shape[:-1], -1)
    dnrm = (dxn * xhat).sum((0, 1))
    dxhat = dxn * nrm.float()
    dx = inv * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdim=True)) + dres
    return dx, dnrm, dwu, dbu


def _layer_plain(args, cfg: Cfg):
    """Plain forward on the 20 layer arguments -> (out, (h, q, k, v, i_pre,
    f_pre)): RMSNorm and proj_up, then the block function with x as its
    residual. h is the cell output before the outnorm, q/k/v are unscaled,
    all (B, S, INNER); the gate preacts are (B, NH, S). The arithmetic
    follows the activations' dtype (fp32, or bf16 as the TPU kernel at
    ``mxu_dtype="bfloat16"``: see ``_head``, ``vil_cell._cell_plain`` and
    ``vil_block.tail_plain``); out comes back in x's dtype, h and q/k/v in
    conv_act's."""
    x, conv_act, rms_scale, wu, bu = args[:5]
    *_, x_mlstm, z = _head(x, rms_scale, wu, bu, cfg.rms_eps)
    return _block_plain((conv_act, x_mlstm, z, x, *args[5:]), cfg)


def vil_layer_ref(x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv,
                  wgi, bgi, wgf, bgf, nscale, nbias, skip, wd, bd, num_heads: int,
                  chunk_size: int = 64, igate_act: str = "exp", eps: float = 1e-6,
                  norm_eps: float = 1e-3, rms_eps: float = 1e-6,
                  keep_fp32: bool = False, use_outnorm: bool = True) -> torch.Tensor:
    """Plain torch ViL layer (the JAX ``_vil_layer_composite``),
    differentiable by autograd (the JAX package's CPU path). fp32
    activations: fp32; bf16 ``x`` and ``conv_act``: the arithmetic of the
    TPU kernel at ``mxu_dtype="bfloat16"`` (``_layer_plain``), out in bf16,
    or, with ``keep_fp32``, the fp32 output before that rounding (what a
    bf16 kernel's output is held to, beyond its own rounding)."""
    args = (x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
            nscale, nbias, skip, wd, bd)
    cfg = Cfg(num_heads, chunk_size, igate_act, eps, norm_eps, rms_eps, outnorm=use_outnorm)
    if not keep_fp32:
        return _layer_plain(args, cfg)[0]
    *_, x_mlstm, z = _head(x, rms_scale, wu, bu, rms_eps)
    h, _ = _cell_plain(conv_act, x_mlstm, *args[5:15], cfg)
    return tail_plain(h, conv_act, z, x, *args[15:], cfg)


def layer_bwd(args, acts, gout, cfg: Cfg, mlstm_bwd):
    """The torch port of ``_vil_layer_bwd``: a cheap recompute of RMSNorm and
    proj_up, the block's backward (tail, then cell around ``mlstm_bwd``),
    then the proj_up and RMSNorm gradients. Returns the gradients of the 20
    layer arguments, in their order, fp32. With bf16 activations every
    product takes bf16 operands and accumulates in fp32, and the
    intermediates the JAX backward keeps in bf16 are rounded there (``cd =
    conv_act.dtype``, ``PF`` in ``_vil_layer_bwd``). These products are
    torch GEMMs on the rounded operands held in fp32: the same arithmetic
    on the CPU and on the card."""
    x, conv_act, nrm, wu, bu = args[:5]
    xhat, inv, xn, x_mlstm, z = _head(x, nrm, wu, bu, cfg.rms_eps, recompute=True)
    dconv, dxm, dz, dres, *rest = block_bwd((conv_act, x_mlstm, z, x, *args[5:]), acts, gout,
                                            cfg, mlstm_bwd)
    dx, dnrm, dwu, dbu = head_bwd(xhat, inv, xn, nrm, wu, dxm, dz, dres)
    return (dx, dconv, dnrm, dwu, dbu, *rest)


def vil_layer_bwd_ref(args, acts, gout, num_heads: int, chunk_size: int = 64,
                      igate_act: str = "exp", eps: float = 1e-6, norm_eps: float = 1e-3,
                      rms_eps: float = 1e-6, use_outnorm: bool = True):
    """Plain backward of the layer (the JAX ``_vil_layer_bwd``, frozen
    stabilizer): ``args`` the 20 layer arguments, ``acts`` the activations
    the forward keeps (``h, q, k, v, i_pre, f_pre`` as ``_layer_plain``
    returns them), ``gout`` the output gradient. Returns the 20 gradients."""
    cfg = Cfg(num_heads, chunk_size, igate_act, eps, norm_eps, rms_eps, outnorm=use_outnorm)
    return layer_bwd(args, acts, gout.float(), cfg, mlstm_chunkwise_bwd_plain)


def _launch(args, cfg: Cfg, save: bool = True):
    """Launch the forward kernel on CUDA tensors -> (out, acts, carry): the
    saved activations and the per-chunk carry states are views of the
    kernel's workspace, in the layouts ``_layer_plain`` and
    ``mlstm_bwd.CarryStates`` use. fp32 activations launch the fp32 entry;
    bf16 x and conv_act the bf16 one, which writes out in bf16 and, with
    ``save``, h and q/k/v in bf16 (the backward's operands, as the JAX
    forward saves them) beside its fp32 workspace, and the carried (C, n)
    from fp32 chunk summaries of those bf16 k and v (the state the JAX
    backward replays; the forward's own state sums bf16-operand summaries
    of the fp32 ones); the weights go in as
    fp32 (bf16 parameters, as serving casts them, are widened: the kernel
    rounds each one to bf16 where the TPU kernel's arithmetic does, the
    products' weights once per call into a bf16 buffer of its own)."""
    x, conv_act, rms_scale, wu, bu = args[:5]
    B, S, DIM = x.shape
    INNER = conv_act.shape[-1]
    bf = conv_act.dtype == torch.bfloat16
    lib = check_call("vil_layer_fwd", conv_act, cfg, (torch.float32, torch.bfloat16))
    nh, dev, ad = cfg.num_heads, x.device, conv_act.dtype
    chk = lambda name, t, shape, dt=None: check_tensor("vil_layer_fwd", name, t, shape, dev, dt)
    w = [None if a is None else a.float() for a in args[2:]] if bf else list(args[2:])
    t = [chk("x", x, (B, S, DIM), ad), chk("conv_act", conv_act, (B, S, INNER), ad),
         chk("rms_scale", w[0], (DIM,)), chk("wu^T", w[1].t(), (2 * INNER, DIM)),
         chk("bu", w[2], (2 * INNER,)),
         *cell_kernel_args("vil_layer_fwd", conv_act, *w[3:3 + N_CELL], nh),
         *tail_kernel_args("vil_layer_fwd", conv_act, *w[3 + N_CELL:], DIM, cfg.outnorm)]
    out = torch.empty((B, S, DIM), device=dev, dtype=ad)
    sizes = (B, S, DIM, INNER, nh, int(cfg.igate_act == "exp"))
    floats = (cfg.eps, cfg.norm_eps, cfg.rms_eps)
    if not bf:
        ws = Workspace(lib, LAYER, B, S, INNER, nh, dev)
        cell_acts, carry = ws.cell_acts()
        run_kernel("vil_layer_fwd", lib, "vil_layer_fwd_f32", [*t, out, ws.buf], sizes, floats,
                   dev)
        vil_layer_fwd.launches += 1
        return out, (ws.h(), *cell_acts), carry
    ws = Workspace(lib, LAYER_BF16, B, S, INNER, nh, dev)
    saved = states32 = None
    rows, ns, dh = B * nh, -(-S // KERNEL_CS), INNER // nh
    if save:  # the backward's bf16 activations and its fp32-summary carried C
        saved = torch.empty((4, B, S, INNER), device=dev, dtype=ad)
        states32 = torch.empty(2 * rows * ns * (dh + 1) * dh, device=dev, dtype=torch.float32)
    w16 = torch.empty(lib.vil16_weight_halves(DIM, INNER, nh), device=dev, dtype=ad)
    run_kernel("vil_layer_fwd", lib, "vil_layer_fwd_bf16",
               [*t, out, ws.buf, w16, saved, states32], sizes, floats, dev)
    vil_layer_fwd.launches_bf16 += 1
    if not save:
        return out, None, None
    # the carried C and n the backward reads: states32's second and fourth arrays
    c_sz, n_sz = rows * ns * dh * dh, rows * ns * dh
    carry = CarryStates(states32[c_sz:2 * c_sz].view(rows, ns, dh, dh),
                        states32[2 * c_sz + n_sz:].view(rows, ns, dh),
                        *ws.carry_scalars())
    return out, (saved[3], *saved[:3], *ws.gate_preacts()), carry


_LAYER = Member("vil_layer_fwd", _layer_plain, _launch, layer_bwd,
                ("x", "conv_act", "rms_scale", "wu", "bu", *CELL_ARGS[2:], *TAIL_ARGS))
register_op(_LAYER)


def vil_layer_fwd(x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv,
                  wgi, bgi, wgf, bgf, nscale, nbias, skip, wd, bd, num_heads: int,
                  chunk_size: int = 64, igate_act: str = "exp", eps: float = 1e-6,
                  norm_eps: float = 1e-3, rms_eps: float = 1e-6,
                  use_outnorm: bool = True) -> torch.Tensor:
    """ViL layer forward. CPU tensors take the plain versions; CUDA tensors
    launch the hand-written kernel (head dim in ``KERNEL_DHS``) or raise. The arithmetic
    follows the activations: fp32 x and conv_act launch the fp32 kernel
    (each launch adds one to ``vil_layer_fwd.launches``); bf16 ones the
    bf16 kernel, the TPU kernel's default arithmetic (bf16 operands in every
    product, fp32 accumulation, gates, stabilizer and norms; out in bf16;
    each launch adds one to ``vil_layer_fwd.launches_bf16``). A bf16 call
    never runs the fp32 kernel, and no call on the card runs a plain
    version.

    When gradients are needed the call goes through an autograd Function
    whose backward is the hand-written one (frozen-stabilizer gate
    gradients, as on the TPU); on CUDA it runs the chunkwise backward
    kernel on the forward's kept workspace. ``chunk_size`` is read by the
    plain versions only: the kernels walk chunks of ``KERNEL_CS``, and the
    result does not depend on the chunk length beyond rounding.
    ``use_outnorm=False``: no outnorm (``nscale``, ``nbias`` unread), in
    both kernels' tails and the plain versions."""
    args = (x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv, wgi, bgi,
            wgf, bgf, nscale, nbias, skip, wd, bd)
    return call_member(_LAYER, Cfg(num_heads, chunk_size, igate_act, eps, norm_eps, rms_eps,
                                   outnorm=use_outnorm), args)


vil_layer_fwd.launches = 0
vil_layer_fwd.launches_bf16 = 0
