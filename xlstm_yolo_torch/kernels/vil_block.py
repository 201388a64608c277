"""The ViL block: the cell plus the layer's tail, forward and backward: plain
torch and CUDA.

Port of the block-fused TPU entry ``mlstm_vil_block_fused_pallas`` in
``xlstm_yolo_tpu/kernels/mlstm_pallas.py`` (forward kernel
``_kernel_vil_block``, composite ``_vil_block_composite``, backward
``_vil_block_bwd``). Given ``conv_act``, ``x_mlstm``, ``z`` (each (B, S,
INNER)) and the residual ``x_res`` (B, S, DIM) it computes

    h = cell(conv_act, x_mlstm)                    (kernels.vil_cell)
    out = ((outnorm(h) + skip * conv_act) * silu(z)) @ wd + bd + x_res

with the EFFECTIVE outnorm scale (``1 + scale``) and ``wd`` (INNER, DIM), as
the JAX entry takes them. The layer-fused function (``vil_layer``) is this
one behind RMSNorm and proj_up.

``vil_block_plain`` is the plain forward (the CPU path and the kernel's
oracle), ``block_bwd`` over the plain chunkwise backward the plain backward. ``vil_block_fwd`` sends
CPU tensors to the plain versions and CUDA tensors to the hand-written
kernel in ``csrc/vil_layer.cu`` (the product with ``wd`` included) and, for
gradients, to the tail's and the cell's products around the chunkwise
backward kernel. It never falls back from a CUDA tensor to a plain version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_tensor
from .mlstm_native import mm_f32, mm_round
from .vil_cell import (BLOCK, Cfg, Member, Workspace, _cell_plain, call_member, cell_bwd,
                       cell_kernel_args, check_call, run_kernel)

N_CELL = 10  # the cell's weights and biases among a call's arguments


def tail_plain(h, conv_act, z, x_res, nscale, nbias, skip, wd, bd, cfg: Cfg):
    """The layer's tail on the cell output h (B, S, INNER): per-head
    outnorm, learnable skip, SiLU(z) gate, proj_down, residual; fp32. With
    bf16 ``conv_act`` the product with proj_down reads bf16-rounded
    operands (the TPU kernel's arithmetic); the rest stays fp32."""
    B, S, INNER = h.shape
    nh = cfg.num_heads
    cd = conv_act.dtype
    R = lambda t: mm_round(t, cd)
    h4 = h.float().reshape(B, S, nh, INNER // nh)
    mu = h4.mean(-1, keepdim=True)
    var = h4.var(-1, keepdim=True, unbiased=False)
    hn = (((h4 - mu) * torch.rsqrt(var + cfg.norm_eps)).reshape(B, S, INNER) * nscale.float()
          + nbias.float())
    y = (hn + skip.float() * conv_act.float()) * F.silu(z.float())
    return R(y) @ R(wd) + bd.float() + x_res.float()


def tail_bwd(h, conv_act, z, nsc, nbi, skip, wd, g, cfg: Cfg):
    """The tail's backward: h the cell output, g (B, S, DIM) the output
    gradient (which is also the residual's). Returns (dh, dconv, dz, dnsc,
    dnbi, dskip, dwd, dbd), fp32; dconv is the skip path's share only. In
    bf16 (``conv_act``'s dtype) the two products with proj_down read bf16
    operands, and the outnorm's output and input gradient are rounded to
    bf16 where the JAX ``_vil_layer_bwd`` casts them."""
    B, S, INNER = h.shape
    nh = cfg.num_heads
    dh_ = INNER // nh
    cd = conv_act.dtype
    R = lambda t: mm_round(t, cd)
    h4 = h.float().reshape(B, S, nh, dh_)
    mu = h4.mean(-1, keepdim=True)
    denom = torch.rsqrt(h4.var(-1, keepdim=True, unbiased=False) + cfg.norm_eps)
    hnorm = (h4 - mu) * denom
    hn = R((hnorm * nsc.reshape(nh, dh_) + nbi.reshape(nh, dh_)).reshape(B, S, INNER))
    z, conv_act = z.float(), conv_act.float()
    sig_z = torch.sigmoid(z)
    sg = z * sig_z
    ypre = hn + skip * conv_act
    dbd = g.sum((0, 1))
    DIM = g.shape[-1]
    g2 = g.reshape(-1, DIM)
    dwd = mm_f32((ypre * sg).reshape(-1, INNER).t(), g2, cd)
    dy = mm_f32(g2, wd.t(), cd).reshape(B, S, INNER)
    dz = dy * ypre * (sig_z * (1.0 + z * (1.0 - sig_z)))
    dypre = dy * sg
    dskip = (dypre * conv_act).sum((0, 1))

    # outnorm backward over dh
    dhn4 = R(dypre).reshape(B, S, nh, dh_)
    dnsc = (dhn4 * hnorm).sum((0, 1)).reshape(INNER)
    dnbi = dhn4.sum((0, 1)).reshape(INNER)
    dhnorm = dhn4 * nsc.reshape(nh, dh_)
    dh4 = denom * (dhnorm - dhnorm.mean(-1, keepdim=True)
                   - hnorm * (dhnorm * hnorm).mean(-1, keepdim=True))
    return dh4.reshape(B, S, INNER), dypre * skip, dz, dnsc, dnbi, dskip, dwd, dbd


def _block_plain(args, cfg: Cfg):
    """Plain forward -> (out, (h, q, k, v, i_pre, f_pre)): out in x_res's
    dtype; h and q/k/v saved in conv_act's (bf16 under AMP, as the JAX
    forward saves them; the tail reads the fp32 h)."""
    conv_act, x_mlstm, z, x_res = args[:4]
    h, cell_acts = _cell_plain(conv_act, x_mlstm, *args[4:4 + N_CELL], cfg)
    out = tail_plain(h, conv_act, z, x_res, *args[4 + N_CELL:], cfg)
    return out.to(x_res.dtype), (h.to(conv_act.dtype), *cell_acts)


def vil_block_plain(conv_act, x_mlstm, z, x_res, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
                    nscale, nbias, skip, wd, bd, num_heads: int, chunk_size: int = 64,
                    igate_act: str = "exp", eps: float = 1e-6,
                    norm_eps: float = 1e-3) -> torch.Tensor:
    """Plain torch ViL block (the JAX ``_vil_block_composite``), fp32 ->
    (B, S, DIM); differentiable by autograd (the JAX package's CPU path)."""
    args = (conv_act, x_mlstm, z, x_res, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
            nscale, nbias, skip, wd, bd)
    return _block_plain(args, Cfg(num_heads, chunk_size, igate_act, eps, norm_eps))[0]


def block_bwd(args, acts, gout, cfg: Cfg, mlstm_bwd):
    """The block's backward (frozen stabilizer): the tail's, then the cell's
    around ``mlstm_bwd``. ``args`` the 19 block arguments, ``acts`` = (h, q, k, v,
    i_pre, f_pre). Returns the 19 gradients, in order."""
    conv_act, x_mlstm, z, _ = args[:4]
    nsc, nbi, skip, wd, _ = args[4 + N_CELL:]
    dh, dconv_tail, dz, *dtail = tail_bwd(acts[0], conv_act, z, nsc, nbi, skip, wd, gout, cfg)
    dconv, dxm, *dcell = cell_bwd((conv_act, x_mlstm, *args[4:4 + N_CELL]), acts[1:], dh, cfg,
                                  mlstm_bwd)
    return (dconv + dconv_tail, dxm, dz, gout, *dcell, *dtail)


def tail_kernel_args(where: str, conv_act, nscale, nbias, skip, wd, bd, dim: int) -> list:
    """The tail's arguments as the C entries take them: proj_down's weight
    as (DIM, INNER), out x in (the module's ``nn.Linear`` weight, so no
    copy there)."""
    INNER, dev = conv_act.shape[-1], conv_act.device
    chk = lambda name, t, shape: check_tensor(where, name, t, shape, dev)
    return [chk("nscale", nscale, (INNER,)), chk("nbias", nbias, (INNER,)),
            chk("skip", skip, (INNER,)), chk("wd^T", wd.t(), (dim, INNER)), chk("bd", bd, (dim,))]


def _launch(args, cfg: Cfg, save: bool = True):
    """Launch the block kernel on CUDA tensors -> (out, acts, carry); the
    saved activations and the carry states are views of its workspace."""
    conv_act, x_mlstm, z, x_res = args[:4]
    lib = check_call("vil_block_fwd", conv_act, cfg)
    B, S, INNER = conv_act.shape
    DIM, nh, dev = x_res.shape[-1], cfg.num_heads, conv_act.device
    chk = lambda name, t, shape: check_tensor("vil_block_fwd", name, t, shape, dev)
    t = [chk("conv_act", conv_act, (B, S, INNER)), chk("x_mlstm", x_mlstm, (B, S, INNER)),
         chk("z", z, (B, S, INNER)), chk("x_res", x_res, (B, S, DIM)),
         *cell_kernel_args("vil_block_fwd", conv_act, *args[4:4 + N_CELL], nh),
         *tail_kernel_args("vil_block_fwd", conv_act, *args[4 + N_CELL:], DIM)]
    out = torch.empty((B, S, DIM), device=dev, dtype=torch.float32)
    ws = Workspace(lib, BLOCK, B, S, INNER, nh, dev)
    run_kernel("vil_block_fwd", lib, "vil_block_fwd_f32", [*t, out, ws.buf],
               (B, S, DIM, INNER, nh, int(cfg.igate_act == "exp")), (cfg.eps, cfg.norm_eps), dev)
    vil_block_fwd.launches += 1
    cell_acts, carry = ws.cell_acts()
    return out, (ws.h(), *cell_acts), carry


_BLOCK = Member("vil_block_fwd", _block_plain, _launch, block_bwd)


def vil_block_fwd(conv_act, x_mlstm, z, x_res, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
                  nscale, nbias, skip, wd, bd, num_heads: int, chunk_size: int = 64,
                  igate_act: str = "exp", eps: float = 1e-6,
                  norm_eps: float = 1e-3) -> torch.Tensor:
    """ViL block forward -> (B, S, DIM). CPU tensors take the plain
    versions; CUDA tensors launch the hand-written kernel (fp32, head dim
    64) or raise. Each kernel launch adds one to ``vil_block_fwd.launches``.
    Gradients and ``chunk_size`` as in ``vil_cell.vil_cell_fwd``."""
    args = (conv_act, x_mlstm, z, x_res, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
            nscale, nbias, skip, wd, bd)
    return call_member(_BLOCK, Cfg(num_heads, chunk_size, igate_act, eps, norm_eps), args)


vil_block_fwd.launches = 0
