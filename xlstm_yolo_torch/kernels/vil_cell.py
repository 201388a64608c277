"""The ViL cell: headwise q/k/v, the gate dots and the chunkwise mLSTM,
forward and backward: plain torch and CUDA.

Port of the cell-fused TPU entry ``mlstm_vil_fused_pallas`` in
``xlstm_yolo_tpu/kernels/mlstm_pallas.py`` (forward kernel
``_kernel_vil_fused``, composite ``_vil_fused_composite``, backward
``_vil_fused_bwd`` around the chunkwise backward kernel). Given the activated
conv branch ``conv_act`` and the raw branch ``x_mlstm`` (both (B, S, INNER))
it computes

    q, k = headwise(conv_act);  v = headwise(x_mlstm)
    i, f = cat(q, k, v) @ wg + bg                  (one pre-activation per head)
    h = mLSTM(q, k, v, i, f)                       (chunkwise, stabilized)

It is the cell of a ViL layer whose residual stays outside the kernel (the
layer under stochastic depth), and the first stage of the block-fused
(``vil_block``) and layer-fused (``vil_layer``) functions, which add the
tail and the head around it. Arguments keep the JAX entry's layouts:
headwise ``wq/wk/wv`` (NH, DH_out, DH_in), gate kernels (3*INNER, NH).

``vil_cell_plain`` is the plain forward (the CPU path and the kernel's
oracle), ``cell_bwd`` over the plain chunkwise backward the plain backward. ``vil_cell_fwd`` sends
CPU tensors to the plain versions and CUDA tensors to the hand-written
kernels: the forward in ``csrc/vil_layer.cu`` (one source for the four
functions of the family), whose workspace (q/k/v, the gate preacts and the
per-chunk carry states) is kept as the saved activations when gradients are
needed, and the backward's products around the chunkwise backward kernel
``kernels.mlstm_bwd.mlstm_chunkwise_bwd``. It never falls back from a CUDA
tensor to a plain version.

This module also holds what the four functions share (the cell, the block,
the layer and the conv-fused layer, ``kernels.vil_conv``): the library
binding, the workspace views, and the autograd Function and device dispatch
(``Member``, ``call_member``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ._build import CudaLibrary, check_tensor
from .mlstm_bwd import (KERNEL_CS, KERNEL_DH, CarryStates, _natural,
                        mlstm_chunkwise_bwd, mlstm_chunkwise_bwd_plain)
from .mlstm_native import mlstm_chunkwise

N_WS = 18  # arrays in the kernels' workspace (vil_workspace_layout)
LAYER, CELL, BLOCK, CONV = 0, 1, 2, 3  # the family's members, as csrc/vil_layer.cu numbers them

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary("vil_layer.cu", {
    "vil_layer_fwd_f32": (_I, [_P] * 22 + [_I] * 6 + [_F] * 3 + [_P]),
    "vil_cell_fwd_f32": (_I, [_P] * 14 + [_I] * 5 + [_F] + [_P]),
    "vil_block_fwd_f32": (_I, [_P] * 21 + [_I] * 6 + [_F] * 2 + [_P]),
    "vil_layer_conv_fwd_f32": (_I, [_P] * 23 + [_I] * 8 + [_F] * 3 + [_P]),
    "vil_workspace_layout": (None, [_I] * 5 + [ctypes.POINTER(ctypes.c_long)]),
    "vil_error_string": (ctypes.c_char_p, [_I]),
})


class Cfg(NamedTuple):
    """The static arguments of a call; the cell reads the first four, the
    conv-fused layer alone the (H, W) token grid ``seqlens``."""
    num_heads: int
    chunk_size: int = 64
    igate_act: str = "exp"
    eps: float = 1e-6
    norm_eps: float = 1e-3
    rms_eps: float = 1e-6
    seqlens: tuple | None = None


def _cell_plain(conv_act, x_mlstm, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf, cfg: Cfg):
    """Plain forward -> (h, (q, k, v, i_pre, f_pre)): the cell output before
    the outnorm and unscaled q/k/v in (B, S, INNER), gate preacts (B, NH, S).
    A sequence that is not a chunk multiple is zero-padded at the end; the
    recurrence is causal, so the padded steps change no real position."""
    B, S, INNER = conv_act.shape
    nh = cfg.num_heads
    dh = INNER // nh
    f32 = torch.float32

    def headwise(t, w, b):  # (B, S, INNER) -> (B, NH, S, DH)
        y = torch.einsum("bsnd,nod->bnso", t.to(f32).reshape(B, S, nh, dh), w)
        return y + b.reshape(1, nh, 1, dh)

    q, k, v = headwise(conv_act, wq, bq), headwise(conv_act, wk, bk), headwise(x_mlstm, wv, bv)

    def gate(w, b):  # split dots over cat(q, k, v) -> (B, NH, S)
        y = (_natural(q) @ w[:INNER] + _natural(k) @ w[INNER:2 * INNER]
             + _natural(v) @ w[2 * INNER:] + b)
        return y.transpose(1, 2)

    i_pre, f_pre = gate(wgi, bgi), gate(wgf, bgf)
    cs = min(cfg.chunk_size, S)
    pad = (-S) % cs
    qp, kp, vp, ip, fp = q, k, v, i_pre, f_pre
    if pad:
        qp, kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        ip, fp = F.pad(i_pre, (0, pad)), F.pad(f_pre, (0, pad))
    h = mlstm_chunkwise(qp, kp, vp, ip, fp, chunk_size=cs, igate_act=cfg.igate_act,
                        eps=cfg.eps)[:, :, :S]
    return _natural(h), (_natural(q), _natural(k), _natural(v), i_pre, f_pre)


def vil_cell_plain(conv_act, x_mlstm, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
                   num_heads: int, chunk_size: int = 64, igate_act: str = "exp",
                   eps: float = 1e-6) -> torch.Tensor:
    """Plain torch ViL cell (the JAX ``_vil_fused_composite``), fp32 ->
    h (B, S, INNER); differentiable by autograd (the JAX package's CPU path)."""
    return _cell_plain(conv_act, x_mlstm, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
                       Cfg(num_heads, chunk_size, igate_act, eps))[0]


def cell_bwd(args, acts, dh, cfg: Cfg, mlstm_bwd):
    """The cell's backward (frozen stabilizer, as the JAX ``_vil_fused_bwd``
    has it) around ``mlstm_bwd``, the chunkwise mLSTM backward on natural
    layouts (``mlstm_chunkwise_bwd_plain`` makes this the plain backward):
    ``args`` the 12 cell arguments, ``acts``
    = (q, k, v, i_pre, f_pre) as the forward keeps them, ``dh`` (B, S,
    INNER) the gradient of h. The gate preacts are linear in q/k/v, and
    q/k/v in conv_act and x_mlstm. Returns the 12 gradients, in order."""
    conv_act, x_mlstm, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf = args
    q, k, v, ip, fp = acts
    B, S, INNER = conv_act.shape
    nh = cfg.num_heads
    dh_ = INNER // nh
    dq_c, dk_c, dv_c, di, df = mlstm_bwd(q, k, v, ip, fp, dh, nh, chunk_size=cfg.chunk_size,
                                         igate_act=cfg.igate_act, eps=cfg.eps)

    def gate_grad(w_i, w_f):  # (INNER, NH) slices -> (B, S, INNER)
        return torch.einsum("ih,bhs->bsi", w_i, di) + torch.einsum("ih,bhs->bsi", w_f, df)

    dq = dq_c + gate_grad(wgi[:INNER], wgf[:INNER])
    dk = dk_c + gate_grad(wgi[INNER:2 * INNER], wgf[INNER:2 * INNER])
    dv = dv_c + gate_grad(wgi[2 * INNER:], wgf[2 * INNER:])
    dwgi = torch.cat([torch.einsum("bsi,bhs->ih", t, di) for t in (q, k, v)])
    dwgf = torch.cat([torch.einsum("bsi,bhs->ih", t, df) for t in (q, k, v)])
    dbgi, dbgf = di.sum((0, 2)), df.sum((0, 2))

    heads = lambda t: t.reshape(B, S, nh, dh_)
    ca, xm = heads(conv_act.float()), heads(x_mlstm.float())
    dwq = torch.einsum("bsno,bsnd->nod", heads(dq), ca)
    dwk = torch.einsum("bsno,bsnd->nod", heads(dk), ca)
    dwv = torch.einsum("bsno,bsnd->nod", heads(dv), xm)
    dbq, dbk, dbv = dq.sum((0, 1)), dk.sum((0, 1)), dv.sum((0, 1))
    dconv = (torch.einsum("bsno,nod->bsnd", heads(dq), wq)
             + torch.einsum("bsno,nod->bsnd", heads(dk), wk)).reshape(B, S, INNER)
    dxm = torch.einsum("bsno,nod->bsnd", heads(dv), wv).reshape(B, S, INNER)
    return dconv, dxm, dwq, dbq, dwk, dbk, dwv, dbv, dwgi, dbgi, dwgf, dbgf


def check_call(where: str, conv_act, cfg: Cfg):
    """What every kernel of the family refuses before it builds or launches:
    an unknown gate activation, a head dim other than ``KERNEL_DH``. Any
    width runs: each stage's shared memory is fixed by its tiles. Returns
    the library."""
    if cfg.igate_act not in ("exp", "sigmoid"):
        raise ValueError(f"unknown igate_act {cfg.igate_act!r}")
    INNER = conv_act.shape[-1]
    if INNER != cfg.num_heads * KERNEL_DH:
        raise ValueError(f"{where}: the CUDA kernel needs head dim {KERNEL_DH}, "
                         f"got INNER={INNER} over {cfg.num_heads} heads")
    return LIB.load()


def cell_kernel_args(where: str, conv_act, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
                     nh: int) -> list:
    """The cell's arguments after conv_act as the C entries take them:
    headwise weights as (NH, DH_out, DH_in), as they come, then the biases,
    then each gate kernel as (NH, 3*INNER) (the layout of the module's
    ``nn.Linear`` weight, so no copy there) with its bias."""
    INNER, dh, dev = conv_act.shape[-1], KERNEL_DH, conv_act.device
    chk = lambda name, t, shape: check_tensor(where, name, t, shape, dev)
    return [chk("wq", wq, (nh, dh, dh)), chk("wk", wk, (nh, dh, dh)), chk("wv", wv, (nh, dh, dh)),
            chk("bq", bq, (INNER,)), chk("bk", bk, (INNER,)), chk("bv", bv, (INNER,)),
            chk("wgi^T", wgi.t(), (nh, 3 * INNER)), chk("bgi", bgi, (nh,)),
            chk("wgf^T", wgf.t(), (nh, 3 * INNER)), chk("bgf", bgf, (nh,))]


class Workspace:
    """The kernels' scratch for one call of member ``kind``, and views of it
    in the layouts the plain versions and ``mlstm_bwd.CarryStates`` use."""

    def __init__(self, lib, kind: int, B: int, S: int, INNER: int, nh: int, device):
        self.shape = (B, S, INNER, nh)
        self.off = (ctypes.c_long * (N_WS + 1))()
        lib.vil_workspace_layout(kind, B, S, INNER, nh, self.off)
        self.buf = torch.empty(self.off[N_WS], device=device, dtype=torch.float32)

    def view(self, i: int, *shape):
        return self.buf[self.off[i]:self.off[i + 1]].view(*shape)

    def cell_acts(self):
        """(q, k, v, i_pre, f_pre) and the carry states."""
        B, S, INNER, nh = self.shape
        ns, dh, tok = -(-S // KERNEL_CS), KERNEL_DH, (B, S, INNER)
        # workspace order: q, k, v, z, h, ig, fg, kv, cprev, ksum, nprev, btot, mloc, mprev,
        # xm, conv, gp, y
        acts = (self.view(0, *tok), self.view(1, *tok), self.view(2, *tok),
                self.view(5, B, nh, S), self.view(6, B, nh, S))
        carry = CarryStates(self.view(8, B * nh, ns, dh, dh), self.view(10, B * nh, ns, dh),
                            self.view(13, B * nh, ns), self.view(11, B * nh, ns),
                            self.view(12, B * nh, ns))
        return acts, carry

    def h(self):
        B, S, INNER, _ = self.shape
        return self.view(4, B, S, INNER)

    def conv_acts(self):
        """(x_mlstm, z, conv_act) as the conv-fused layer leaves them."""
        B, S, INNER, _ = self.shape
        return self.view(14, B, S, INNER), self.view(3, B, S, INNER), self.view(15, B, S, INNER)


def run_kernel(where: str, lib, entry: str, tensors, sizes, floats, device):
    """Call the C entry on the current stream; raise on a CUDA error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*(t.data_ptr() for t in tensors), *sizes, *floats, stream)
    if err != 0:
        raise RuntimeError(f"{where}: CUDA error {err}: {lib.vil_error_string(err).decode()}")


def _launch(args, cfg: Cfg):
    """Launch the cell kernel on CUDA tensors -> (h, acts, carry): h is a
    tensor of its own; the saved activations and the per-chunk carry states
    are views of the kernel's workspace, which is freed with them."""
    conv_act, x_mlstm, *weights = args
    lib = check_call("vil_cell_fwd", conv_act, cfg)
    B, S, INNER = conv_act.shape
    nh, dev = cfg.num_heads, conv_act.device
    t = [check_tensor("vil_cell_fwd", "conv_act", conv_act, (B, S, INNER), dev),
         check_tensor("vil_cell_fwd", "x_mlstm", x_mlstm, (B, S, INNER), dev),
         *cell_kernel_args("vil_cell_fwd", conv_act, *weights, nh)]
    h = torch.empty((B, S, INNER), device=dev, dtype=torch.float32)
    ws = Workspace(lib, CELL, B, S, INNER, nh, dev)
    run_kernel("vil_cell_fwd", lib, "vil_cell_fwd_f32", [*t, h, ws.buf],
               (B, S, INNER, nh, int(cfg.igate_act == "exp")), (cfg.eps,), dev)
    vil_cell_fwd.launches += 1
    return (h, *ws.cell_acts())


class Member(NamedTuple):
    """One function of the family for ``call_member``: ``plain(args, cfg)
    -> (out, acts)``, ``launch(args, cfg) -> (out, acts, carry)`` and
    ``bwd(args, acts, gout, cfg, mlstm_bwd) -> grads``."""
    name: str
    plain: Callable
    launch: Callable
    bwd: Callable


def _on_card(t) -> bool:
    """The one place that decides between kernel and plain version. A run
    that holds a model against its plain versions on the card replaces it
    for that run; nothing else sends a CUDA tensor to a plain version."""
    return t.device.type == "cuda"


class _MemberFunction(torch.autograd.Function):
    """A member with its hand-written backward. Forward: the kernel on CUDA
    (its workspace kept as the saved activations), the plain forward on the
    CPU. Backward: the member's ``bwd`` around the chunkwise mLSTM backward:
    the kernel, reading the forward's carry states, where the forward ran
    the kernel; the plain version where it ran the plain one."""

    @staticmethod
    def forward(ctx, member, cfg, *args):
        if _on_card(args[0]):
            out, acts, carry = member.launch(args, cfg)
        else:
            (out, acts), carry = member.plain(args, cfg), ()
        ctx.save_for_backward(*args, *acts, *carry)
        ctx.member, ctx.cfg, ctx.counts = member, cfg, (len(args), len(acts))
        return out

    @staticmethod
    def backward(ctx, gout):
        n_args, n_acts = ctx.counts
        saved = ctx.saved_tensors
        args, acts, carry = saved[:n_args], saved[n_args:n_args + n_acts], saved[n_args + n_acts:]
        mlstm_bwd = (functools.partial(mlstm_chunkwise_bwd, carry=CarryStates(*carry)) if carry
                     else mlstm_chunkwise_bwd_plain)
        grads = ctx.member.bwd(args, acts, gout.contiguous().float(), ctx.cfg, mlstm_bwd)
        return (None, None, *grads)


def call_member(member: Member, cfg: Cfg, args):
    """The device dispatch of the family: CPU tensors take the plain
    version, CUDA tensors launch the kernel or raise, any other device is
    refused. When gradients are needed the call goes through the autograd
    Function with the hand-written backward."""
    if args[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"{member.name}: unsupported device {args[0].device}")
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _MemberFunction.apply(member, cfg, *args)
    if _on_card(args[0]):
        return member.launch(args, cfg)[0]
    return member.plain(args, cfg)[0]


_CELL = Member("vil_cell_fwd", lambda args, cfg: _cell_plain(*args, cfg), _launch, cell_bwd)


def vil_cell_fwd(conv_act, x_mlstm, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
                 num_heads: int, chunk_size: int = 64, igate_act: str = "exp",
                 eps: float = 1e-6) -> torch.Tensor:
    """ViL cell forward -> h (B, S, INNER), the cell output before the
    outnorm, in the natural layout the layer's tail reads (the JAX entry
    returns (B, NH, DH, S), the TPU's lane layout, which the port does not
    carry over). CPU tensors take the plain versions; CUDA tensors launch
    the hand-written kernel (fp32, head dim 64) or raise. Each kernel launch
    adds one to ``vil_cell_fwd.launches``.

    When gradients are needed the call goes through an autograd Function
    whose backward is the hand-written one (frozen-stabilizer gate
    gradients, as on the TPU); on CUDA it runs the chunkwise backward
    kernel on the forward's kept workspace. ``chunk_size`` is read by the
    plain versions only: the kernels walk chunks of ``KERNEL_CS``, and the
    result does not depend on the chunk length beyond rounding."""
    return call_member(_CELL, Cfg(num_heads, chunk_size, igate_act, eps),
                       (conv_act, x_mlstm, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf))


vil_cell_fwd.launches = 0
