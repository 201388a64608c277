"""Chunkwise mLSTM backward: plain torch and CUDA.

Port of ``xlstm_yolo_tpu/kernels/mlstm_bwd.py`` (``mlstm_chunkwise_bwd_ref``,
the frozen-stabilizer gradients of ``mlstm_chunkwise``) and of the phase-1
helpers of ``xlstm_yolo_tpu/kernels/mlstm_pallas_bwd.py``
(``_gate_chunk_weights``, ``chunk_carry_states`` and ``_carry_scan``), whose
reverse-streaming TPU kernel becomes the hand-written CUDA kernel in
``csrc/mlstm_bwd.cu``.

The stabilizer quantities (m_prev, m_loc, the row max, stab) are constants of
the backward: ``h`` is invariant to them, so dq/dk/dv equal the autograd
gradients, and the gate gradients equal them wherever the normalizer's
``exp(-stab)`` floor is inactive (elsewhere they drop the floor terms).

``mlstm_chunkwise_bwd`` is the entry the ViL layer's backward calls, on q, k,
v and dh in the layer's natural (B, S, INNER) layout: CPU tensors take the
plain version, CUDA tensors launch the kernel (chunk 64, head dim 4, 8,
16, 32, 64, 128 or 256; the ViL family runs it at the first five, the
language model at 64 and up) or raise. The kernel reads the per-chunk carry-in states that a forward kernel
leaves in its workspace (the ViL family's, or the chunkwise forward's, which
calls this entry through ``kernels.mlstm_fwd.mlstm_chunkwise_bwd_heads``),
or that ``chunk_carry_states`` (phase 1 in plain torch, as on the TPU)
computes.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import CudaLibrary, check_tensor
from .mlstm_native import _log_igate, mm_round

# Shared by the launchers of this kernel and of the ViL layer, cell and block
# kernels (kernels/vil_cell.py), whose forward leaves the carry states:
KERNEL_DHS = (4, 8, 16, 32, 64)  # head dims the ViL kernels are instantiated for
                                 # (the JAX package's ViL blocks default to 4 and 16)
KERNEL_CS = 64  # their chunk length (CS in csrc/vil_layer.cu and
                # csrc/mlstm_bwd.cu): the carry states are per chunk of it
KERNEL_BWD_DHS = KERNEL_DHS + (128, 256)  # head dims this module's fp32 CUDA kernel takes
NEG = -1e30  # log input gate of a masked step
# the names of this kernel's launches, as a profiler trace shows them: the fp32
# stages, and the prefix of the bf16 ones
STAGES = ("bwd_chunk_local", "bwd_chunk_carry", "bwd_wide_local", "bwd_wide_carry")
STAGES_BF16 = "bwd16_"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = CudaLibrary("mlstm_bwd.cu", {
    "mlstm_bwd_f32": (_I, [_P] * 17 + [_I] * 5 + [_F, _P]),
    "mlstm_bwd_bf16": (_I, [_P] * 17 + [_I] * 5 + [_F, _P]),
    "mlstm_bwd_workspace_floats": (ctypes.c_long, [_I] * 4),
    "mlstm_bwd_error_string": (ctypes.c_char_p, [_I]),
})


class CarryStates(NamedTuple):
    """Per-chunk carry-in states of the chunkwise forward, in the layer
    kernel's workspace layout: ``c`` (B*NH, NS, DH, DV) as [k index][v
    index], ``n`` (B*NH, NS, DH), and ``m`` (the stabilizer carried in),
    ``btot`` (total log decay) and ``mloc`` (local max), each (B*NH, NS)."""
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor
    btot: torch.Tensor
    mloc: torch.Tensor


def mlstm_chunkwise_bwd_ref(q, k, v, i_preact, f_preact, dh, chunk_size: int = 64,
                            igate_act: str = "exp", eps: float = 1e-6, mm_dtype=None):
    """Frozen-stabilizer gradients of ``mlstm_chunkwise``. q/k (B, NH, S,
    DH), v and dh (B, NH, S, DV), gates (B, NH, S), S a multiple of
    ``chunk_size``; returns (dq, dk, dv, di_preact, df_preact) in fp32.
    ``mm_dtype`` (``mlstm_native.mm_round``): the operand type of every
    product, rounded where the TPU kernel's ``_chunk_grads`` casts (the
    carry states are replayed unrounded, as its phase 1 computes them)."""
    B, NH, S, DH = q.shape
    DV = v.shape[-1]
    CS = chunk_size
    NS = S // CS
    f32 = torch.float32
    qc = q.to(f32).reshape(B, NH, NS, CS, DH) / math.sqrt(DH)
    kc = k.to(f32).reshape(B, NH, NS, CS, DH)
    vc = v.to(f32).reshape(B, NH, NS, CS, DV)
    fp = f_preact.to(f32).reshape(B, NH, NS, CS)
    ip = i_preact.to(f32).reshape(B, NH, NS, CS)
    logf = F.logsigmoid(fp)
    logi = _log_igate(ip, igate_act)
    dhc = dh.to(f32).reshape(B, NH, NS, CS, DV)

    R = lambda t: mm_round(t, mm_dtype)
    # forward replay (identical to mlstm_chunkwise)
    b = torch.cumsum(logf, dim=-1)
    gw, btot, m_loc = _chunk_weights(logf, logi)
    kv = torch.einsum("bncsd,bncse->bncde", kc * gw[..., None], vc)
    ksum = (kc * gw[..., None]).sum(dim=-2)
    c_prev, n_prev, m_prev, ld_old, ld_new = _carry_scan(kv, ksum, btot, m_loc)
    d_old, d_new = ld_old.exp(), ld_new.exp()

    causal = torch.ones(CS, CS, dtype=torch.bool, device=q.device).tril()
    log_d = torch.where(causal, b[..., :, None] - b[..., None, :] + logi[..., None, :],
                        torch.tensor(float("-inf"), device=q.device))
    d_max = log_d.amax(dim=-1)
    inter_decay_log = m_prev[..., None] + b
    stab = torch.maximum(d_max, inter_decay_log)
    d = torch.exp(log_d - stab[..., None])
    e = torch.einsum("bncsd,bnctd->bncst", R(qc), R(kc)) * d
    a = torch.exp(inter_decay_log - stab)
    q_inter = qc * a[..., None]
    row = e.sum(dim=-1) + torch.einsum("bncsd,bncd->bncs", q_inter, n_prev)
    floor = torch.exp(-stab)
    normalizer = torch.maximum(row.abs(), floor)[..., None] + eps
    h = (torch.einsum("bncst,bnctd->bncsd", R(e), R(vc))
         + torch.einsum("bncsd,bncde->bncse", R(q_inter), R(c_prev))) / normalizer

    # backward
    dA = dhc / normalizer
    dN = -(dhc * h).sum(dim=-1) / normalizer[..., 0]
    dR = torch.where(row.abs() > floor, torch.sign(row) * dN, torch.zeros_like(dN))

    # intra attention
    de = torch.einsum("bncsd,bnctd->bncst", R(dA), R(vc)) + dR[..., None]
    de = torch.where(causal, de, torch.zeros_like(de))
    dqk = de * d
    dqc = torch.einsum("bncst,bnctd->bncsd", R(dqk), R(kc))
    dkc = torch.einsum("bncst,bncsd->bnctd", R(dqk), R(qc))
    dvc = torch.einsum("bncst,bncsd->bnctd", R(e), R(dA))
    G = de * e
    dlogi = G.sum(dim=-2)
    db = G.sum(dim=-1) - dlogi

    # inter attention
    dqt = (torch.einsum("bncse,bncde->bncsd", R(dA), R(c_prev))
           + dR[..., None] * n_prev[..., None, :])
    dqc = dqc + dqt * a[..., None]
    db = db + (dqt * q_inter).sum(dim=-1)
    dc_attn = torch.einsum("bncsd,bncse->bncde", R(q_inter), R(dA))
    dn_attn = torch.einsum("bncs,bncsd->bncd", dR, q_inter)

    # reverse state scan: the gradient w.r.t. the state chunk j leaves behind
    dcn, dnn = torch.zeros_like(dc_attn), torch.zeros_like(dn_attn)
    dc_run = dc_attn.new_zeros((B, NH, DH, DV))
    dn_run = dn_attn.new_zeros((B, NH, DH))
    for j in range(NS - 1, -1, -1):
        dcn[:, :, j], dnn[:, :, j] = dc_run, dn_run
        dc_run = dc_attn[:, :, j] + dc_run * d_old[:, :, j, None, None]
        dn_run = dn_attn[:, :, j] + dn_run * d_old[:, :, j, None]
    dbtot = ((dcn * c_prev).sum(dim=(-2, -1)) + (dnn * n_prev).sum(dim=-1)) * d_old

    # kv / ksum path: c_new = d_old * c_prev + d_new * kv_j
    dkv = dcn * d_new[..., None, None]
    dksum = dnn * d_new[..., None]
    dvc = dvc + torch.einsum("bncsd,bncde->bncse", R(kc * gw[..., None]), R(dkv))
    dk_state = torch.einsum("bncde,bncse->bncsd", R(dkv), R(vc)) + dksum[..., None, :]
    dkc = dkc + dk_state * gw[..., None]
    gi = (dk_state * kc).sum(dim=-1) * gw
    dlogi = dlogi + gi
    dbtot = dbtot + gi.sum(dim=-1)
    db = db - gi
    db[..., -1] += dbtot
    dlogf = torch.flip(torch.cumsum(torch.flip(db, (-1,)), -1), (-1,))

    dq = (dqc / math.sqrt(DH)).reshape(B, NH, S, DH)
    df = (dlogf * torch.sigmoid(-fp)).reshape(B, NH, S)
    di = dlogi * torch.sigmoid(-ip) if igate_act == "sigmoid" else dlogi
    return dq, dkc.reshape(B, NH, S, DH), dvc.reshape(B, NH, S, DV), di.reshape(B, NH, S), df


def _chunk_weights(logf, logi):
    """gw (.., NS, CS) intra-chunk accumulation weights, btot (.., NS) total
    log decay and m_loc (.., NS) local stabilizer max, from chunked gate
    logs."""
    b = torch.cumsum(logf, dim=-1)
    btot = b[..., -1]
    g_acc = logi + (btot[..., None] - b)
    m_loc = g_acc.amax(dim=-1)
    return torch.exp(g_acc - m_loc[..., None]), btot, m_loc


def gate_chunk_weights(i_preact, f_preact, chunk_size: int, igate_act: str = "exp"):
    """Per-chunk gate summaries (the JAX ``_gate_chunk_weights``): gates
    (B, NH, S) -> (gw (B, NH, NS, CS), btot (B, NH, NS), m_loc (B, NH, NS)).
    A sequence that is not a chunk multiple is masked at its end as the
    kernels mask it: log forget 0, log input -1e30."""
    B, NH, S = f_preact.shape
    pad = (-S) % chunk_size
    logf = F.pad(F.logsigmoid(f_preact.float()), (0, pad))
    logi = F.pad(_log_igate(i_preact.float(), igate_act), (0, pad), value=NEG)
    NS = (S + pad) // chunk_size
    return _chunk_weights(logf.reshape(B, NH, NS, chunk_size),
                          logi.reshape(B, NH, NS, chunk_size))


def _carry_scan(kv, ksum, btot, m_loc):
    """The inter-chunk (C, n, m) recurrence; kv (B, NH, NS, DH, DV), ksum
    (B, NH, NS, DH), btot/m_loc (B, NH, NS). Returns the states carried
    into each chunk (c, n, m) and the log decays of the carried state
    (ld_old) and of the chunk summary (ld_new), stacked over chunks."""
    B, NH, NS, DH, DV = kv.shape
    c = kv.new_zeros((B, NH, DH, DV))
    n = kv.new_zeros((B, NH, DH))
    m = kv.new_zeros((B, NH))
    out = [[], [], [], [], []]
    for j in range(NS):
        m_new = torch.maximum(btot[..., j] + m, m_loc[..., j])
        ld_old = btot[..., j] + m - m_new
        ld_new = m_loc[..., j] - m_new
        for lst, x in zip(out, (c, n, m, ld_old, ld_new)):
            lst.append(x)
        c = c * ld_old.exp()[..., None, None] + kv[:, :, j] * ld_new.exp()[..., None, None]
        n = n * ld_old.exp()[..., None] + ksum[:, :, j] * ld_new.exp()[..., None]
        m = m_new
    return tuple(torch.stack(x, dim=2) for x in out)


def chunk_carry_states(k, v, i_preact, f_preact, chunk_size: int = KERNEL_CS,
                       igate_act: str = "exp") -> CarryStates:
    """Phase 1 (the JAX ``chunk_carry_states``): k/v (B, NH, S, DH), gates
    (B, NH, S) -> the carry-in state of every chunk, in the layer kernel's
    workspace layout. S need not be a chunk multiple (see
    ``gate_chunk_weights``). The JAX package's ``chunk_carry_states_t``
    twin exists for the TPU's transposed layout, which the port does not use."""
    B, NH, S, DH = k.shape
    pad = (-S) % chunk_size
    NS = (S + pad) // chunk_size
    kc = F.pad(k.float(), (0, 0, 0, pad)).reshape(B, NH, NS, chunk_size, DH)
    vc = F.pad(v.float(), (0, 0, 0, pad)).reshape(B, NH, NS, chunk_size, v.shape[-1])
    gw, btot, m_loc = gate_chunk_weights(i_preact, f_preact, chunk_size, igate_act)
    kv = torch.einsum("bncsd,bncse->bncde", kc * gw[..., None], vc)
    ksum = (kc * gw[..., None]).sum(dim=-2)
    c, n, m, _, _ = _carry_scan(kv, ksum, btot, m_loc)
    rows = lambda t: t.reshape(B * NH, *t.shape[2:]).contiguous()
    return CarryStates(rows(c), rows(n), rows(m), rows(btot), rows(m_loc))


def _heads(t, nh):  # (B, S, INNER) -> (B, NH, S, DH)
    B, S, INNER = t.shape
    return t.reshape(B, S, nh, INNER // nh).transpose(1, 2)


def _natural(t):  # (B, NH, S, DH) -> (B, S, INNER)
    B, NH, S, DH = t.shape
    return t.transpose(1, 2).reshape(B, S, NH * DH)


def mlstm_chunkwise_bwd_plain(q, k, v, i_preact, f_preact, dh, num_heads: int,
                              chunk_size: int = KERNEL_CS, igate_act: str = "exp",
                              eps: float = 1e-6, keep_fp32: bool = False):
    """The kernel's plain version, on its layouts: q/k/v/dh (B, S, INNER)
    natural (q unscaled), gates (B, NH, S) -> (dq, dk, dv (B, S, INNER), di,
    df (B, NH, S)). The sequence is zero-padded to a chunk multiple at the
    end; the recurrence is causal and padded steps carry no output
    gradient, so they change no gradient of a real step. bf16 q/k/v (the
    ViL layer's saved activations under AMP) take bf16 operands in every
    product (``mlstm_chunkwise_bwd_ref``'s ``mm_dtype``) and give dq/dk/dv
    in bf16, as the TPU kernel at ``mxu_dtype="bfloat16"`` does (fp32
    before that rounding with ``keep_fp32``); the gate gradients stay
    fp32."""
    S = q.shape[1]
    cs = min(chunk_size, S)
    pad = (-S) % cs
    qh, kh, vh, dhh = (F.pad(_heads(t.float(), num_heads), (0, 0, 0, pad))
                       for t in (q, k, v, dh))
    ip, fp = F.pad(i_preact.float(), (0, pad)), F.pad(f_preact.float(), (0, pad))
    dq, dk, dv, di, df = mlstm_chunkwise_bwd_ref(qh, kh, vh, ip, fp, dhh, chunk_size=cs,
                                                 igate_act=igate_act, eps=eps,
                                                 mm_dtype=q.dtype)
    nat = lambda t: _natural(t[:, :, :S]).to(torch.float32 if keep_fp32 else q.dtype)
    return nat(dq), nat(dk), nat(dv), di[..., :S], df[..., :S]


def mlstm_chunkwise_bwd(q, k, v, i_preact, f_preact, dh, num_heads: int,
                        carry: CarryStates | None = None, chunk_size: int = KERNEL_CS,
                        igate_act: str = "exp", eps: float = 1e-6):
    """Chunkwise mLSTM backward on the ViL layer's layouts (see
    ``mlstm_chunkwise_bwd_plain``). CPU tensors take the plain version
    (``carry`` unused, ``chunk_size`` read); CUDA tensors launch the
    hand-written kernel (fp32, chunk 64, head dim in ``KERNEL_BWD_DHS``, B *
    NH at most 65535) or raise, reading ``carry``, the forward's states at
    chunk ``KERNEL_CS``. Each kernel launch adds one to
    ``mlstm_chunkwise_bwd.launches``. bf16 q/k/v (head dim in
    ``KERNEL_DHS``, the ViL layer's saved activations under AMP) launch the
    bf16 entry instead:
    bf16 operands in every product, dh and the gates fp32, dq/dk/dv bf16;
    each of its launches adds one to ``mlstm_chunkwise_bwd.launches_bf16``
    and never to ``launches``."""
    if q.device.type == "cpu":
        return mlstm_chunkwise_bwd_plain(q, k, v, i_preact, f_preact, dh, num_heads,
                                         chunk_size=chunk_size, igate_act=igate_act, eps=eps)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunkwise_bwd: unsupported device {q.device}")
    if igate_act not in ("exp", "sigmoid"):
        raise ValueError(f"unknown igate_act {igate_act!r}")
    B, S, INNER = q.shape
    nh = num_heads
    dh_ = INNER // nh
    if INNER != nh * dh_ or dh_ not in KERNEL_BWD_DHS:
        raise ValueError(f"mlstm_chunkwise_bwd: the CUDA kernel needs head dim in "
                         f"{KERNEL_BWD_DHS}, got INNER={INNER} over {nh} heads")
    bf = q.dtype == torch.bfloat16
    if bf and dh_ not in KERNEL_DHS:
        raise ValueError(f"mlstm_chunkwise_bwd: the bf16 CUDA kernel needs head dim in "
                         f"{KERNEL_DHS}, got {dh_}")
    if B * nh > 65535:
        raise ValueError(f"mlstm_chunkwise_bwd: B * NH = {B * nh} exceeds 65535")
    if carry is None:
        raise ValueError("mlstm_chunkwise_bwd: the CUDA kernel needs the forward's carry "
                         "states (the layer kernel's workspace, or chunk_carry_states)")
    dev = q.device
    NS = -(-S // KERNEL_CS)
    rows = B * nh
    chk = lambda name, x, shape, dt=None: check_tensor("mlstm_chunkwise_bwd", name, x, shape,
                                                       dev, dt)
    t = [chk(n_, x, (B, S, INNER), q.dtype) for n_, x in (("q", q), ("k", k), ("v", v))]
    t += [chk("dh", dh, (B, S, INNER)), chk("i_preact", i_preact, (B, nh, S)),
          chk("f_preact", f_preact, (B, nh, S)),
          chk("carry.c", carry.c, (rows, NS, dh_, dh_)),
          chk("carry.n", carry.n, (rows, NS, dh_))]
    t += [chk(f"carry.{n_}", getattr(carry, n_), (rows, NS)) for n_ in ("m", "btot", "mloc")]
    lib = _LIB.load()
    outs = [torch.empty((B, S, INNER), device=dev, dtype=q.dtype) for _ in range(3)]
    outs += [torch.empty((B, nh, S), device=dev) for _ in range(2)]
    # the bf16 entry keeps fp32 dk and dv between its stages after the carries
    n_ws = lib.mlstm_bwd_workspace_floats(B, S, nh, dh_) + (2 * B * S * INNER if bf else 0)
    ws = torch.empty(n_ws, device=dev)
    entry = lib.mlstm_bwd_bf16 if bf else lib.mlstm_bwd_f32
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = entry(*(x.data_ptr() for x in t), *(o.data_ptr() for o in outs), ws.data_ptr(),
                    B, S, INNER, nh, int(igate_act == "exp"), eps, stream)
    if err != 0:
        raise RuntimeError(f"mlstm_chunkwise_bwd: CUDA error {err}: "
                           f"{lib.mlstm_bwd_error_string(err).decode()}")
    if bf:
        mlstm_chunkwise_bwd.launches_bf16 += 1
    else:
        mlstm_chunkwise_bwd.launches += 1
    return tuple(outs)


mlstm_chunkwise_bwd.launches = 0
mlstm_chunkwise_bwd.launches_bf16 = 0
