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

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import CudaLibrary, check_tensor
from .mlstm_bwd import (KERNEL_CS, KERNEL_DH, CarryStates, mlstm_chunkwise_bwd,
                        mlstm_chunkwise_bwd_plain)
from .mlstm_native import mlstm_chunkwise

N_WS = 14  # arrays in the kernel's workspace (vil_layer_workspace_layout)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = CudaLibrary("vil_layer.cu", {
    "vil_layer_fwd_f32": (_I, [_P] * 22 + [_I] * 6 + [_F] * 3 + [_P]),
    "vil_layer_workspace_layout": (None, [_I] * 4 + [ctypes.POINTER(ctypes.c_long)]),
    "vil_layer_prologue_smem": (ctypes.c_long, [_I] * 2),
    "vil_layer_error_string": (ctypes.c_char_p, [_I]),
})


def _vil_layer_plain(x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv,
                     wgi, bgi, wgf, bgf, nscale, nbias, skip, wd, bd, num_heads: int,
                     chunk_size: int, igate_act: str, eps: float, norm_eps: float,
                     rms_eps: float):
    """Plain forward -> (out, (h, q, k, v, i_pre, f_pre)): the cell output
    before the outnorm and unscaled q/k/v in (B, S, INNER), gate preacts
    (B, NH, S). A sequence that is not a chunk multiple is zero-padded at
    the end; the recurrence is causal, so the padded steps change no real
    position."""
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
    nat = lambda t: t.transpose(1, 2).reshape(B, S, INNER)

    def gate(w, b):  # split dots over cat(q, k, v) -> (B, NH, S)
        y = nat(q) @ w[:INNER] + nat(k) @ w[INNER:2 * INNER] + nat(v) @ w[2 * INNER:] + b
        return y.transpose(1, 2)

    i_pre, f_pre = gate(wgi, bgi), gate(wgf, bgf)
    cs = min(chunk_size, S)
    pad = (-S) % cs
    qp, kp, vp, ip, fp = q, k, v, i_pre, f_pre
    if pad:
        qp, kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        ip, fp = F.pad(i_pre, (0, pad)), F.pad(f_pre, (0, pad))
    h = mlstm_chunkwise(qp, kp, vp, ip, fp, chunk_size=cs, igate_act=igate_act,
                        eps=eps)[:, :, :S]
    mu = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, unbiased=False)
    hn = (h - mu) * torch.rsqrt(var + norm_eps)
    hn = nat(hn * nscale.reshape(1, nh, 1, dh) + nbias.reshape(1, nh, 1, dh))
    y = (hn + skip * conv_act) * F.silu(z)
    return y @ wd + bd + xf, (nat(h), nat(q), nat(k), nat(v), i_pre, f_pre)


def vil_layer_ref(x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv,
                  wgi, bgi, wgf, bgf, nscale, nbias, skip, wd, bd, num_heads: int,
                  chunk_size: int = 64, igate_act: str = "exp", eps: float = 1e-6,
                  norm_eps: float = 1e-3, rms_eps: float = 1e-6) -> torch.Tensor:
    """Plain torch ViL layer (the JAX ``_vil_layer_composite``), fp32;
    differentiable by autograd (the JAX package's CPU path)."""
    return _vil_layer_plain(x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv, wgi,
                            bgi, wgf, bgf, nscale, nbias, skip, wd, bd, num_heads, chunk_size,
                            igate_act, eps, norm_eps, rms_eps)[0]


def _layer_bwd(args, acts, gout, num_heads, rms_eps, norm_eps, cell_bwd):
    """The torch port of ``_vil_layer_bwd``: the tail, outnorm, gate,
    projection and RMSNorm gradients as products around ``cell_bwd`` (the
    chunkwise mLSTM backward on natural layouts). Returns the gradients of
    the 20 layer arguments, in their order."""
    (x, conv_act, nrm, wu, bu, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
     nsc, nbi, skip, wd, bd) = args
    h, q, k, v, ip, fp = acts
    B, S, DIM = x.shape
    INNER = conv_act.shape[-1]
    nh = num_heads
    dh = INNER // nh
    g = gout.float()

    # cheap recompute: RMSNorm + proj_up
    inv = torch.rsqrt((x * x).mean(-1, keepdim=True) + rms_eps)
    xhat = x * inv
    xn = xhat * nrm
    x_mlstm, z = (xn @ wu + bu).split(INNER, dim=-1)

    # tail forward pieces + tail backward
    h4 = h.reshape(B, S, nh, dh)
    mu = h4.mean(-1, keepdim=True)
    denom = torch.rsqrt(h4.var(-1, keepdim=True, unbiased=False) + norm_eps)
    hnorm = (h4 - mu) * denom
    hn = (hnorm * nsc.reshape(nh, dh) + nbi.reshape(nh, dh)).reshape(B, S, INNER)
    sig_z = torch.sigmoid(z)
    sg = z * sig_z
    ypre = hn + skip * conv_act
    dbd = g.sum((0, 1))
    dwd = torch.einsum("bsi,bsd->id", ypre * sg, g)
    dy = g @ wd.t()
    dz = dy * ypre * (sig_z * (1.0 + z * (1.0 - sig_z)))
    dypre = dy * sg
    dskip = (dypre * conv_act).sum((0, 1))

    # outnorm backward over dh
    dhn4 = dypre.reshape(B, S, nh, dh)
    dnsc = (dhn4 * hnorm).sum((0, 1)).reshape(INNER)
    dnbi = dhn4.sum((0, 1)).reshape(INNER)
    dhnorm = dhn4 * nsc.reshape(nh, dh)
    dh4 = denom * (dhnorm - dhnorm.mean(-1, keepdim=True)
                   - hnorm * (dhnorm * hnorm).mean(-1, keepdim=True))

    # cell backward
    dq_c, dk_c, dv_c, di, df = cell_bwd(q, k, v, ip, fp, dh4.reshape(B, S, INNER))

    # gate backward: the i/f preacts are linear in q/k/v
    def gate_grad(w_i, w_f):  # (INNER, NH) slices -> (B, S, INNER)
        return (torch.einsum("ih,bhs->bsi", w_i, di) + torch.einsum("ih,bhs->bsi", w_f, df))

    dq = dq_c + gate_grad(wgi[:INNER], wgf[:INNER])
    dk = dk_c + gate_grad(wgi[INNER:2 * INNER], wgf[INNER:2 * INNER])
    dv = dv_c + gate_grad(wgi[2 * INNER:], wgf[2 * INNER:])
    dwgi = torch.cat([torch.einsum("bsi,bhs->ih", t, di) for t in (q, k, v)])
    dwgf = torch.cat([torch.einsum("bsi,bhs->ih", t, df) for t in (q, k, v)])
    dbgi, dbgf = di.sum((0, 2)), df.sum((0, 2))

    # projection backward
    heads = lambda t: t.reshape(B, S, nh, dh)
    ca, xm = heads(conv_act), heads(x_mlstm)
    dwq = torch.einsum("bsno,bsnd->nod", heads(dq), ca)
    dwk = torch.einsum("bsno,bsnd->nod", heads(dk), ca)
    dwv = torch.einsum("bsno,bsnd->nod", heads(dv), xm)
    dbq, dbk, dbv = dq.sum((0, 1)), dk.sum((0, 1)), dv.sum((0, 1))
    dconv_head = (torch.einsum("bsno,nod->bsnd", heads(dq), wq)
                  + torch.einsum("bsno,nod->bsnd", heads(dk), wk)).reshape(B, S, INNER)
    dxm = torch.einsum("bsno,nod->bsnd", heads(dv), wv).reshape(B, S, INNER)

    # proj_up + RMSNorm backward
    dy2 = torch.cat([dxm, dz], dim=-1)
    dwu = torch.einsum("bsd,bse->de", xn, dy2)
    dbu = dy2.sum((0, 1))
    dxn = dy2 @ wu.t()
    dnrm = (dxn * xhat).sum((0, 1))
    dxhat = dxn * nrm
    dx = inv * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdim=True)) + g  # + residual
    dconv = dconv_head + dypre * skip
    return (dx, dconv, dnrm, dwu, dbu, dwq, dbq, dwk, dbk, dwv, dbv, dwgi, dbgi, dwgf, dbgf,
            dnsc, dnbi, dskip, dwd, dbd)


def vil_layer_bwd_ref(args, acts, gout, num_heads: int, chunk_size: int = 64,
                      igate_act: str = "exp", eps: float = 1e-6, norm_eps: float = 1e-3,
                      rms_eps: float = 1e-6):
    """Plain backward of the layer (the JAX ``_vil_layer_bwd``, frozen
    stabilizer): ``args`` the 20 layer arguments, ``acts`` the activations
    the forward keeps (``h, q, k, v, i_pre, f_pre`` as ``_vil_layer_plain``
    returns them), ``gout`` the output gradient. Returns the 20 gradients."""
    cell = functools.partial(mlstm_chunkwise_bwd_plain, num_heads=num_heads,
                             chunk_size=chunk_size, igate_act=igate_act, eps=eps)
    return _layer_bwd(args, acts, gout, num_heads, rms_eps, norm_eps, cell)


def _launch(args, num_heads, igate_act, eps, norm_eps, rms_eps):
    """Launch the forward kernel on CUDA tensors -> (out, acts, carry): the
    saved activations and the per-chunk carry states are views of the
    kernel's workspace, in the layouts ``_vil_layer_plain`` and
    ``mlstm_bwd.CarryStates`` use."""
    (x, conv_act, rms_scale, wu, bu, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
     nscale, nbias, skip, wd, bd) = args
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
    chk = lambda name, t, shape: check_tensor("vil_layer_fwd", name, t, shape, dev)
    t = [
        chk("x", x, (B, S, DIM)),
        chk("conv_act", conv_act, (B, S, INNER)),
        chk("rms_scale", rms_scale, (DIM,)),
        chk("wu", wu, (DIM, 2 * INNER)),
        chk("bu", bu, (2 * INNER,)),
        # headwise weights as (NH, DH_in, DH_out): the kernel's loads along
        # the output index are then coalesced
        chk("wq", wq, (nh, dh, dh)).transpose(1, 2).contiguous(),
        chk("wk", wk, (nh, dh, dh)).transpose(1, 2).contiguous(),
        chk("wv", wv, (nh, dh, dh)).transpose(1, 2).contiguous(),
        chk("bq", bq, (INNER,)),
        chk("bk", bk, (INNER,)),
        chk("bv", bv, (INNER,)),
        chk("wgi", wgi, (3 * INNER, nh)).t().contiguous(),
        chk("bgi", bgi, (nh,)),
        chk("wgf", wgf, (3 * INNER, nh)).t().contiguous(),
        chk("bgf", bgf, (nh,)),
        chk("nscale", nscale, (INNER,)),
        chk("nbias", nbias, (INNER,)),
        chk("skip", skip, (INNER,)),
        chk("wd", wd, (INNER, DIM)),
        chk("bd", bd, (DIM,)),
    ]
    off = (ctypes.c_long * (N_WS + 1))()
    lib.vil_layer_workspace_layout(B, S, INNER, nh, off)
    out = torch.empty((B, S, DIM), device=dev, dtype=torch.float32)
    ws = torch.empty(off[N_WS], device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.vil_layer_fwd_f32(*(a.data_ptr() for a in t), out.data_ptr(), ws.data_ptr(),
                                    B, S, DIM, INNER, nh, int(igate_act == "exp"),
                                    eps, norm_eps, rms_eps, stream)
    if err != 0:
        raise RuntimeError(f"vil_layer_fwd: CUDA error {err}: "
                           f"{lib.vil_layer_error_string(err).decode()}")
    vil_layer_fwd.launches += 1
    ns = -(-S // KERNEL_CS)
    view = lambda i, *shape: ws[off[i]:off[i + 1]].view(*shape)
    tok = (B, S, INNER)
    # workspace order: q, k, v, z, h, ig, fg, kv, cprev, ksum, nprev, btot, mloc, mprev
    acts = (view(4, *tok), view(0, *tok), view(1, *tok), view(2, *tok),
            view(5, B, nh, S), view(6, B, nh, S))
    carry = CarryStates(view(8, B * nh, ns, dh, dh), view(10, B * nh, ns, dh),
                        view(13, B * nh, ns), view(11, B * nh, ns), view(12, B * nh, ns))
    return out, acts, carry


class _ViLLayerFunction(torch.autograd.Function):
    """The layer with its hand-written backward. Forward: the kernel on CUDA
    (its workspace kept as the saved activations), the plain forward on the
    CPU. Backward: ``_layer_bwd`` around ``mlstm_chunkwise_bwd`` (the
    kernel on CUDA, reading the forward's carry states; the plain version
    on the CPU)."""

    @staticmethod
    def forward(ctx, num_heads, chunk_size, igate_act, eps, norm_eps, rms_eps, *args):
        if args[0].device.type == "cuda":
            out, acts, carry = _launch(args, num_heads, igate_act, eps, norm_eps, rms_eps)
            ctx.save_for_backward(*args, *acts, *carry)
        else:
            out, acts = _vil_layer_plain(*args, num_heads, chunk_size, igate_act, eps,
                                         norm_eps, rms_eps)
            ctx.save_for_backward(*args, *acts)
        ctx.cfg = (num_heads, chunk_size, igate_act, eps, norm_eps, rms_eps)
        return out

    @staticmethod
    def backward(ctx, gout):
        num_heads, chunk_size, igate_act, eps, norm_eps, rms_eps = ctx.cfg
        saved = ctx.saved_tensors
        args, acts = saved[:20], saved[20:26]
        carry = CarryStates(*saved[26:]) if len(saved) > 26 else None
        cell = functools.partial(mlstm_chunkwise_bwd, num_heads=num_heads, carry=carry,
                                 chunk_size=chunk_size, igate_act=igate_act, eps=eps)
        grads = _layer_bwd(args, acts, gout.contiguous(), num_heads, rms_eps, norm_eps, cell)
        return (None,) * 6 + grads


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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vil_layer_fwd: unsupported device {x.device}")
    cfg = (num_heads, chunk_size, igate_act, eps, norm_eps, rms_eps)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _ViLLayerFunction.apply(*cfg, *args)
    if x.device.type == "cpu":
        return vil_layer_ref(*args, num_heads, chunk_size=chunk_size, igate_act=igate_act,
                             eps=eps, norm_eps=norm_eps, rms_eps=rms_eps)
    return _launch(args, num_heads, igate_act, eps, norm_eps, rms_eps)[0]


vil_layer_fwd.launches = 0
