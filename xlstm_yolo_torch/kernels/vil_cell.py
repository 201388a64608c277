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
binding, the workspace views, the autograd Function, each member's
registration as a torch op (``xlstm_yolo::<name>``, what ``torch.export``
keeps) and the device dispatch (``Member``, ``register_op``,
``call_member``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ._build import CudaLibrary, check_tensor
from .mlstm_bwd import (KERNEL_CS, KERNEL_DHS, CarryStates, _natural,
                        mlstm_chunkwise_bwd, mlstm_chunkwise_bwd_plain)
from .mlstm_native import mlstm_chunkwise, mm_f32, mm_round

N_WS = 18  # arrays in the kernels' workspace (vil_workspace_layout)
# the family's members, as csrc/vil_layer.cu numbers them, and the layer's bf16 entry's workspace
LAYER, CELL, BLOCK, CONV, LAYER_BF16 = 0, 1, 2, 3, 4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary("vil_layer.cu", {
    "vil_layer_fwd_f32": (_I, [_P] * 22 + [_I] * 6 + [_F] * 3 + [_P]),
    "vil_layer_fwd_bf16": (_I, [_P] * 25 + [_I] * 6 + [_F] * 3 + [_P]),
    "vil16_weight_halves": (ctypes.c_long, [_I] * 3),
    "vil_cell_fwd_f32": (_I, [_P] * 14 + [_I] * 5 + [_F] + [_P]),
    "vil_block_fwd_f32": (_I, [_P] * 21 + [_I] * 6 + [_F] * 2 + [_P]),
    "vil_layer_conv_fwd_f32": (_I, [_P] * 23 + [_I] * 8 + [_F] * 3 + [_P]),
    "vil_workspace_layout": (None, [_I] * 5 + [ctypes.POINTER(ctypes.c_long)]),
    "vil_error_string": (ctypes.c_char_p, [_I]),
})


class Cfg(NamedTuple):
    """The static arguments of a call; the cell reads the first four, the
    conv-fused layer alone the (H, W) token grid ``seqlens``. ``outnorm``
    False: the members with the tail skip the per-head outnorm (the layer's
    ``use_outnorm=False``) and take no outnorm affine (None)."""
    num_heads: int
    chunk_size: int = 64
    igate_act: str = "exp"
    eps: float = 1e-6
    norm_eps: float = 1e-3
    rms_eps: float = 1e-6
    seqlens: tuple | None = None
    outnorm: bool = True


def _cell_plain(conv_act, x_mlstm, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf, cfg: Cfg):
    """Plain forward -> (h, (q, k, v, i_pre, f_pre)): the cell output before
    the outnorm and unscaled q/k/v in (B, S, INNER), gate preacts (B, NH, S).
    A sequence that is not a chunk multiple is zero-padded at the end; the
    recurrence is causal, so the padded steps change no real position.

    The arithmetic follows ``conv_act``'s dtype. fp32: fp32 throughout.
    bf16 (the TPU kernels at their default ``mxu_dtype="bfloat16"``, as the
    JAX layer casts its weights to the activations' dtype): every product
    reads bf16-rounded operands (``mm_round``) and accumulates in fp32, the
    headwise biases are bf16 values, the gate biases fp32; q/k/v, gates
    and h stay fp32 inside, and the saved q/k/v come back in bf16, as the
    JAX forward saves them."""
    B, S, INNER = conv_act.shape
    nh = cfg.num_heads
    dh = INNER // nh
    cd = conv_act.dtype
    R = lambda t: mm_round(t, cd)

    def headwise(t, w, b):  # (B, S, INNER) -> (B, NH, S, DH), fp32
        y = torch.einsum("bsnd,nod->bnso", R(t).reshape(B, S, nh, dh), R(w))
        return y + R(b).reshape(1, nh, 1, dh)

    q, k, v = headwise(conv_act, wq, bq), headwise(conv_act, wk, bk), headwise(x_mlstm, wv, bv)

    def gate(w, b):  # split dots over cat(q, k, v) -> (B, NH, S)
        y = (R(_natural(q)) @ R(w[:INNER]) + R(_natural(k)) @ R(w[INNER:2 * INNER])
             + R(_natural(v)) @ R(w[2 * INNER:]) + b.float())
        return y.transpose(1, 2)

    i_pre, f_pre = gate(wgi, bgi), gate(wgf, bgf)
    cs = min(cfg.chunk_size, S)
    pad = (-S) % cs
    qp, kp, vp, ip, fp = q, k, v, i_pre, f_pre
    if pad:
        qp, kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        ip, fp = F.pad(i_pre, (0, pad)), F.pad(f_pre, (0, pad))
    h = mlstm_chunkwise(qp, kp, vp, ip, fp, chunk_size=cs, igate_act=cfg.igate_act,
                        eps=cfg.eps, mm_dtype=cd)[:, :, :S]
    saved = tuple(_natural(t).to(cd) for t in (q, k, v))
    return _natural(h), (*saved, i_pre, f_pre)


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
    q/k/v in conv_act and x_mlstm. Returns the 12 gradients, in order, fp32.

    In bf16 (``conv_act``'s dtype) every product takes bf16-rounded operands
    and accumulates in fp32, and the sums the JAX ``_vil_layer_bwd`` forms
    in bf16 are rounded there: each gate term of dq/dk/dv, and dq/dk/dv
    themselves (the chunkwise backward returns them in bf16)."""
    conv_act, x_mlstm, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf = args
    q, k, v, ip, fp = acts
    B, S, INNER = conv_act.shape
    nh = cfg.num_heads
    dh_ = INNER // nh
    cd = conv_act.dtype
    R = lambda t: mm_round(t, cd)
    dq_c, dk_c, dv_c, di, df = mlstm_bwd(q, k, v, ip, fp, dh, nh, chunk_size=cfg.chunk_size,
                                         igate_act=cfg.igate_act, eps=cfg.eps)
    dic, dfc = R(di), R(df)

    def gate_grad(w_i, w_f):  # (INNER, NH) slices -> (B, S, INNER)
        return R(R(torch.einsum("ih,bhs->bsi", R(w_i), dic))
                 + R(torch.einsum("ih,bhs->bsi", R(w_f), dfc)))

    dq = R(R(dq_c) + gate_grad(wgi[:INNER], wgf[:INNER]))
    dk = R(R(dk_c) + gate_grad(wgi[INNER:2 * INNER], wgf[INNER:2 * INNER]))
    dv = R(R(dv_c) + gate_grad(wgi[2 * INNER:], wgf[2 * INNER:]))
    dwgi = torch.cat([torch.einsum("bsi,bhs->ih", R(t), dic) for t in (q, k, v)])
    dwgf = torch.cat([torch.einsum("bsi,bhs->ih", R(t), dfc) for t in (q, k, v)])
    dbgi, dbgf = di.sum((0, 2)), df.sum((0, 2))

    # the headwise products as one batched GEMM over heads: (NH, B*S, DH)
    heads = lambda t: t.reshape(B * S, nh, dh_).transpose(0, 1)
    back = lambda t: t.transpose(0, 1).reshape(B, S, INNER)
    ca, xm = heads(conv_act), heads(x_mlstm)
    dwq = mm_f32(heads(dq).transpose(1, 2), ca, cd)
    dwk = mm_f32(heads(dk).transpose(1, 2), ca, cd)
    dwv = mm_f32(heads(dv).transpose(1, 2), xm, cd)
    dbq, dbk, dbv = dq.sum((0, 1)), dk.sum((0, 1)), dv.sum((0, 1))
    dconv = back(mm_f32(heads(dq), wq, cd) + mm_f32(heads(dk), wk, cd))
    dxm = R(back(mm_f32(heads(dv), wv, cd)))
    return dconv, dxm, dwq, dbq, dwk, dbk, dwv, dbv, dwgi, dbgi, dwgf, dbgf


def check_call(where: str, conv_act, cfg: Cfg, dtypes=(torch.float32,)):
    """What every kernel of the family refuses before it builds or launches:
    an unknown gate activation; a width that is no whole number of heads, or
    a head dim (INNER / num_heads) outside ``KERNEL_DHS`` = (4, 8, 16, 32,
    64), the head dims the CUDA stages are instantiated for (the JAX
    package's blocks default to 16 and 4, the flagship YAML sets 64; any
    other, 12 or 128 say, has no kernel and raises here, never falls back to
    the plain version); activations of a dtype it has no entry for
    (``dtypes``: the layer has fp32 and bf16 entries at every one of those
    head dims, the others fp32 only). Any width runs: each stage's shared
    memory is fixed by its 64-wide tiles. Returns the library."""
    if cfg.igate_act not in ("exp", "sigmoid"):
        raise ValueError(f"unknown igate_act {cfg.igate_act!r}")
    if conv_act.dtype not in dtypes:
        raise TypeError(f"{where}: no CUDA kernel for {conv_act.dtype} activations "
                        f"(it has {', '.join(map(str, dtypes))})")
    INNER, nh = conv_act.shape[-1], cfg.num_heads
    if nh <= 0 or INNER % nh or INNER // nh not in KERNEL_DHS:
        raise ValueError(f"{where}: the CUDA kernel needs a head dim in {KERNEL_DHS}, "
                         f"got INNER={INNER} over {nh} heads")
    return LIB.load()


def cell_kernel_args(where: str, conv_act, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
                     nh: int) -> list:
    """The cell's arguments after conv_act as the C entries take them:
    headwise weights as (NH, DH_out, DH_in), as they come, then the biases,
    then each gate kernel as (NH, 3*INNER) (the layout of the module's
    ``nn.Linear`` weight, so no copy there) with its bias."""
    INNER, dev = conv_act.shape[-1], conv_act.device
    dh = INNER // nh
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
        """Array ``i`` as ``shape`` (each array starts 16-byte aligned, so
        its slot may be longer than the array)."""
        return self.buf[self.off[i]:self.off[i] + math.prod(shape)].view(*shape)

    def cell_acts(self):
        """(q, k, v, i_pre, f_pre) and the carry states."""
        B, S, INNER, nh = self.shape
        ns, dh, tok = -(-S // KERNEL_CS), INNER // nh, (B, S, INNER)
        # workspace order: q, k, v, z, h, ig, fg, kv, cprev, ksum, nprev, btot, mloc, mprev,
        # xm, conv, gp, y
        acts = (self.view(0, *tok), self.view(1, *tok), self.view(2, *tok), *self.gate_preacts())
        carry = CarryStates(self.view(8, B * nh, ns, dh, dh), self.view(10, B * nh, ns, dh),
                            *self.carry_scalars())
        return acts, carry

    def gate_preacts(self):
        """(i_pre, f_pre), (B, NH, S) each."""
        B, S, _, nh = self.shape
        return self.view(5, B, nh, S), self.view(6, B, nh, S)

    def carry_scalars(self):
        """(m, btot, mloc) of the carry states, (B*NH, NS) each."""
        B, S, _, nh = self.shape
        ns = -(-S // KERNEL_CS)
        return self.view(13, B * nh, ns), self.view(11, B * nh, ns), self.view(12, B * nh, ns)

    def h(self):
        B, S, INNER, _ = self.shape
        return self.view(4, B, S, INNER)

    def conv_acts(self):
        """(x_mlstm, z, conv_act) as the conv-fused layer leaves them."""
        B, S, INNER, _ = self.shape
        return self.view(14, B, S, INNER), self.view(3, B, S, INNER), self.view(15, B, S, INNER)


def run_kernel(where: str, lib, entry: str, tensors, sizes, floats, device):
    """Call the C entry on the current stream (a None tensor passes a null
    pointer); raise on a CUDA error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs = (None if t is None else t.data_ptr() for t in tensors)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*ptrs, *sizes, *floats, stream)
    if err != 0:
        raise RuntimeError(f"{where}: CUDA error {err}: {lib.vil_error_string(err).decode()}")


def _launch(args, cfg: Cfg, save: bool = True):
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
    -> (out, acts)``, ``launch(args, cfg, save) -> (out, acts, carry)``
    (``save``: the backward will read ``acts``) and ``bwd(args, acts, gout,
    cfg, mlstm_bwd) -> grads``; ``args`` names its tensor arguments, in
    order, and its output has the shape of argument ``out_like`` and its
    dtype, or ``out_dtype`` (``register_op``)."""
    name: str
    plain: Callable
    launch: Callable
    bwd: Callable
    args: tuple
    out_like: int = 0
    out_dtype: torch.dtype | None = None


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
            out, acts, carry = member.launch(args, cfg, True)
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
        return (None, None, *(None if a is None else g.to(a.dtype) for g, a in zip(grads, args)))


OP_NAMESPACE = "xlstm_yolo"
OPS: dict = {}  # member name -> its registered op (register_op)
# the optional tensors of a member's schema: the outnorm affine, None with cfg.outnorm False
OPTIONAL_ARGS = ("nscale", "nbias")
CFG_SCHEMA = ("int num_heads, int chunk_size, str igate_act, float eps, float norm_eps, "
              "float rms_eps, int[]? seqlens, bool outnorm")


def cfg_args(cfg: Cfg) -> tuple:
    """``cfg`` as the op schema's plain arguments (``CFG_SCHEMA``)."""
    return (int(cfg.num_heads), int(cfg.chunk_size), str(cfg.igate_act), float(cfg.eps),
            float(cfg.norm_eps), float(cfg.rms_eps),
            None if cfg.seqlens is None else [int(s) for s in cfg.seqlens], bool(cfg.outnorm))


def _cfg_of(a) -> Cfg:
    return Cfg(a[0], a[1], a[2], a[3], a[4], a[5], None if a[6] is None else tuple(a[6]), a[7])


def vil_macs(dim: int, inner: int, nh: int, tail: bool, head: bool, conv: bool) -> int:
    """Multiply-adds a token of a member's products: the cell's headwise
    q/k/v, its two gate dots and, per head, the causal half of the
    intra-chunk q k^T and E v products over the kernel's chunk length and
    the inter-chunk q C and chunk-summary k v^T products; the tail's
    proj_down; the head's proj_up (both halves); the depthwise 3x3 conv.
    The count ``chip_smoke.vil_bound`` and ``conv_bound`` hold the kernels
    to; elementwise work is left out."""
    dh = inner // nh
    macs = 3 * inner * dh + 6 * inner * nh + nh * ((KERNEL_CS + 1) * dh + 2 * dh * dh)
    macs += inner * dim * (int(tail) + 2 * int(head)) + 9 * inner * int(conv)
    return macs


def register_op(member: Member):
    """Register ``member`` as the op ``xlstm_yolo::<name>``: its tensor
    arguments, then ``cfg`` as plain ints, floats, a str and a bool
    (``CFG_SCHEMA``), one tensor out. The CPU implementation is the plain
    forward, the CUDA one launches the kernel (and counts the launch, so a
    call of an exported program counts too); the fake one gives the
    output's shape and dtype without touching the library, so
    ``torch.export`` keeps the op as one node of its graph. A FLOP formula
    (``vil_macs``) lets ``FlopCounterMode`` count it."""
    from torch.utils.flop_counter import register_flop_formula

    n = len(member.args)
    tensors = ", ".join(f"Tensor{'?' if a in OPTIONAL_ARGS else ''} {a}" for a in member.args)

    def plain(*a):
        return member.plain(a[:n], _cfg_of(a[n:]))[0].contiguous()

    def kernel(*a):
        return member.launch(a[:n], _cfg_of(a[n:]), False)[0]

    def fake(*a):
        like = a[member.out_like]
        return like.new_empty(like.shape, dtype=member.out_dtype or like.dtype)

    def flops(*shapes, out_shape=None, **kw):
        s = dict(zip(member.args, shapes))
        nh, dh = s["wq"][:2]
        dim = s["bd"][0] if "bd" in s else 0
        B, S = shapes[0][:2]
        return 2 * B * S * vil_macs(dim, nh * dh, nh, "bd" in s, "wu" in s, "wc" in s)

    op = torch.library.custom_op(f"{OP_NAMESPACE}::{member.name}", plain, mutates_args=(),
                                 device_types="cpu", schema=f"({tensors}, {CFG_SCHEMA}) -> Tensor")
    op.register_kernel("cuda", kernel)
    op.register_fake(fake)
    register_flop_formula(getattr(getattr(torch.ops, OP_NAMESPACE), member.name))(flops)
    OPS[member.name] = op
    return op


def call_member(member: Member, cfg: Cfg, args):
    """The device dispatch of the family: CPU tensors take the plain
    version, CUDA tensors launch the kernel or raise, any other device is
    refused. When gradients are needed the call goes through the autograd
    Function with the hand-written backward; without, through the member's
    registered op (``register_op``), which ``torch.export`` keeps as a node.
    A run that forces the plain versions on the card (``_on_card``) takes
    them here. An argument a call does not read (the outnorm affine with
    ``cfg.outnorm`` False) may be None."""
    if args[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"{member.name}: unsupported device {args[0].device}")
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        return _MemberFunction.apply(member, cfg, *args)
    if args[0].device.type == "cuda" and not _on_card(args[0]):
        return member.plain(args, cfg)[0]
    return OPS[member.name](*args, *cfg_args(cfg))


CELL_ARGS = ("conv_act", "x_mlstm", "wq", "bq", "wk", "bk", "wv", "bv", "wgi", "bgi", "wgf", "bgf")
_CELL = Member("vil_cell_fwd", lambda args, cfg: _cell_plain(*args, cfg), _launch, cell_bwd,
               CELL_ARGS, out_dtype=torch.float32)
register_op(_CELL)


def vil_cell_fwd(conv_act, x_mlstm, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf,
                 num_heads: int, chunk_size: int = 64, igate_act: str = "exp",
                 eps: float = 1e-6) -> torch.Tensor:
    """ViL cell forward -> h (B, S, INNER), the cell output before the
    outnorm, in the natural layout the layer's tail reads (the JAX entry
    returns (B, NH, DH, S), the TPU's lane layout, which the port does not
    carry over). CPU tensors take the plain versions; CUDA tensors launch
    the hand-written kernel (fp32, head dim in ``KERNEL_DHS``) or raise. Each
    kernel launch adds one to ``vil_cell_fwd.launches``.

    When gradients are needed the call goes through an autograd Function
    whose backward is the hand-written one (frozen-stabilizer gate
    gradients, as on the TPU); on CUDA it runs the chunkwise backward
    kernel on the forward's kept workspace. ``chunk_size`` is read by the
    plain versions only: the kernels walk chunks of ``KERNEL_CS``, and the
    result does not depend on the chunk length beyond rounding."""
    return call_member(_CELL, Cfg(num_heads, chunk_size, igate_act, eps),
                       (conv_act, x_mlstm, wq, bq, wk, bk, wv, bv, wgi, bgi, wgf, bgf))


vil_cell_fwd.launches = 0
