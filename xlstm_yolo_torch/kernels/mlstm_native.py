"""mLSTM recurrence in plain torch: the chunkwise and the step-by-step form.

Port of ``xlstm_yolo_tpu/kernels/mlstm_native.py`` (``_log_igate``,
``mlstm_recurrent_step``, ``mlstm_recurrent`` and ``mlstm_chunkwise``).
Recurrence per head, head dim DH, log-space max-stabilized:

    m_t = max(log f̃_t + m_{t-1}, log ĩ_t)
    C_t = exp(log f̃_t + m_{t-1} - m_t) C_{t-1} + exp(log ĩ_t - m_t) k_t v_tᵀ
    n_t = exp(log f̃_t + m_{t-1} - m_t) n_{t-1} + exp(log ĩ_t - m_t) k_t
    h_t = q̃_tᵀ C_t / (max(|q̃_tᵀ n_t|, exp(-m_t)) + eps),   q̃ = q / sqrt(DH)

with log f̃ = logsigmoid(f_preact), and log ĩ = i_preact (``"exp"``) or
logsigmoid(i_preact) (``"sigmoid"``). ``mlstm_chunkwise`` is the oracle the
kernels' plain versions are built on; ``mlstm_recurrent`` is a second oracle
that takes any sequence length.

``mm_dtype=torch.bfloat16`` gives the arithmetic of the TPU kernels at their
default ``mxu_dtype="bfloat16"``: each matrix product reads its operands
rounded to bf16 and accumulates in fp32 (``mm_round``); gate math, the
stabilizer, the carried state and every sum that is no product stay fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def mm_round(t: torch.Tensor, mm_dtype=None) -> torch.Tensor:
    """A product's operand as the tensor cores read it with ``mm_dtype``
    operands: rounded to ``mm_dtype`` and held in fp32. The product of two
    bf16 values is exact in fp32, so an fp32 product of such operands is the
    bf16-operand product with fp32 accumulation (``preferred_element_type=
    float32`` in the JAX kernels). The identity (in fp32) for None or
    float32."""
    if mm_dtype is None or mm_dtype == torch.float32:
        return t.float()
    return t.to(mm_dtype).float()


def mm_f32(a: torch.Tensor, b: torch.Tensor, mm_dtype=None) -> torch.Tensor:
    """a @ b (2-D, or batched 3-D) with ``mm_dtype`` operands and fp32
    accumulation and result (the JAX backward's ``preferred_element_type=
    float32`` products). bf16 on the card: the library GEMM that reads bf16
    and writes fp32 (``torch.mm`` / ``torch.bmm`` with ``out_dtype``);
    elsewhere, and for fp32, an fp32 product of the rounded operands
    (``mm_round``): the same arithmetic."""
    if a.is_cuda and mm_dtype == torch.bfloat16:
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a.to(mm_dtype), b.to(mm_dtype), out_dtype=torch.float32)
    return mm_round(a, mm_dtype) @ mm_round(b, mm_dtype)


def _log_igate(i_preact: torch.Tensor, igate_act: str) -> torch.Tensor:
    if igate_act == "exp":
        return i_preact
    if igate_act == "sigmoid":
        return F.logsigmoid(i_preact)
    raise ValueError(f"unknown igate_act {igate_act!r}")


def mlstm_recurrent_step(c_state, n_state, m_state, q, k, v, i_preact, f_preact,
                         igate_act: str = "exp", eps: float = 1e-6):
    """One autoregressive step. States C (B, NH, DH, DV), n (B, NH, DH), m
    (B, NH); q/k (B, NH, DH), v (B, NH, DV), gate preacts (B, NH). Returns
    (h, (C', n', m'))."""
    DH = q.shape[-1]
    logf = F.logsigmoid(f_preact)
    logi = _log_igate(i_preact, igate_act)
    m_new = torch.maximum(logf + m_state, logi)
    f_act = torch.exp(logf + m_state - m_new)[..., None]
    i_act = torch.exp(logi - m_new)[..., None]
    qs = q / math.sqrt(DH)
    c_new = f_act[..., None] * c_state + i_act[..., None] * (k[..., :, None] * v[..., None, :])
    n_new = f_act * n_state + i_act * k
    h_num = torch.einsum("bnd,bnde->bne", qs, c_new)
    qn = (qs * n_new).sum(-1)
    denom = torch.maximum(qn.abs(), torch.exp(-m_new)) + eps
    return h_num / denom[..., None], (c_new, n_new, m_new)


def mlstm_recurrent(q, k, v, i_preact, f_preact, igate_act: str = "exp", eps: float = 1e-6,
                    return_last_state: bool = False):
    """Full-sequence loop of the single-step form (slow reference path), any
    S. q/k (B, NH, S, DH), v (B, NH, S, DV), gates (B, NH, S) -> h
    (B, NH, S, DV) fp32; the state starts at zero (m = 0)."""
    B, NH, S, DH = q.shape
    f32 = torch.float32
    q, k, v, i_preact, f_preact = (t.to(f32) for t in (q, k, v, i_preact, f_preact))
    state = (q.new_zeros((B, NH, DH, v.shape[-1])), q.new_zeros((B, NH, DH)),
             q.new_zeros((B, NH)))
    hs = []
    for t in range(S):
        h, state = mlstm_recurrent_step(*state, q[:, :, t], k[:, :, t], v[:, :, t],
                                        i_preact[:, :, t], f_preact[:, :, t],
                                        igate_act=igate_act, eps=eps)
        hs.append(h)
    h = torch.stack(hs, dim=2)
    return (h, state) if return_last_state else h


def mlstm_chunkwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    i_preact: torch.Tensor,
    f_preact: torch.Tensor,
    chunk_size: int = 64,
    igate_act: str = "exp",
    eps: float = 1e-6,
    return_last_state: bool = False,
    mm_dtype=None,
):
    """Chunked-parallel mLSTM. q/k (B, NH, S, DQK), v (B, NH, S, DV), gate
    preacts (B, NH, S) -> h (B, NH, S, DV) in fp32. S must be a multiple of
    ``chunk_size``. Per-chunk summaries are computed batched, the (C, n, m)
    inter-chunk state is carried by a loop over chunks, and the intra- and
    inter-chunk contributions are combined vectorized. ``mm_dtype``: the
    operand type of the products (``mm_round``), rounded where the TPU
    kernel's ``_chunk_math`` casts: q and k of q k^T, the decayed E and v,
    q_inter and the carried C. The chunk summaries k^T (g v) that carry the
    state stay fp32 products: the backward replays the state in fp32 (the
    TPU kernel's phase 1), so the state the forward leaves for it is the
    fp32 one."""
    B, NH, S, DH = q.shape
    DV = v.shape[-1]
    CS = chunk_size
    if S % CS:
        raise ValueError(f"sequence length {S} must be divisible by chunk_size {CS}")
    NS = S // CS
    f32 = torch.float32

    qc = q.to(f32).reshape(B, NH, NS, CS, DH) / math.sqrt(DH)
    kc = k.to(f32).reshape(B, NH, NS, CS, DH)
    vc = v.to(f32).reshape(B, NH, NS, CS, DV)
    logf = F.logsigmoid(f_preact.to(f32)).reshape(B, NH, NS, CS)
    logi = _log_igate(i_preact.to(f32), igate_act).reshape(B, NH, NS, CS)

    b = torch.cumsum(logf, dim=-1)  # inclusive within-chunk cumsum
    btot = b[..., -1]  # (B, NH, NS) total chunk decay

    # contribution of step t to the end-of-chunk state decays by (btot - b_t)
    g_acc = logi + (btot[..., None] - b)
    m_loc = g_acc.amax(dim=-1)  # (B, NH, NS)
    gw = torch.exp(g_acc - m_loc[..., None])
    R = lambda t: mm_round(t, mm_dtype)
    kv = torch.einsum("bncsd,bncse->bncde", R(kc * gw[..., None]), R(vc))
    ksum = (kc * gw[..., None]).sum(dim=-2)  # (B, NH, NS, DH)

    c_st = q.new_zeros((B, NH, DH, DV), dtype=f32)
    n_st = q.new_zeros((B, NH, DH), dtype=f32)
    m_st = q.new_zeros((B, NH), dtype=f32)

    c_prev, n_prev, m_prev = [], [], []
    for j in range(NS):
        c_prev.append(c_st)
        n_prev.append(n_st)
        m_prev.append(m_st)
        m_new = torch.maximum(btot[..., j] + m_st, m_loc[..., j])
        decay_old = torch.exp(btot[..., j] + m_st - m_new)
        decay_new = torch.exp(m_loc[..., j] - m_new)
        c_st = c_st * decay_old[..., None, None] + kv[:, :, j] * decay_new[..., None, None]
        n_st = n_st * decay_old[..., None] + ksum[:, :, j] * decay_new[..., None]
        m_st = m_new
    c_prev = torch.stack(c_prev, dim=2)  # (B, NH, NS, DH, DV) carry-in per chunk
    n_prev = torch.stack(n_prev, dim=2)  # (B, NH, NS, DH)
    m_prev = torch.stack(m_prev, dim=2)  # (B, NH, NS)

    # intra-chunk D matrix: log_d[t, s] = (b_t - b_s) + logi_s for s <= t
    log_fg = b[..., :, None] - b[..., None, :]
    causal = torch.ones(CS, CS, dtype=torch.bool, device=q.device).tril()
    log_d = torch.where(causal, log_fg + logi[..., None, :],
                        torch.tensor(float("-inf"), device=q.device))
    d_max = log_d.amax(dim=-1)  # (B, NH, NS, CS)

    # the stabilizer covers both the intra max and the inter-chunk term
    inter_decay_log = m_prev[..., None] + b
    stab = torch.maximum(d_max, inter_decay_log)

    d = torch.exp(log_d - stab[..., None])
    e = torch.einsum("bncsd,bnctd->bncst", R(qc), R(kc)) * d

    q_inter = qc * torch.exp(inter_decay_log - stab)[..., None]
    inter_num = torch.einsum("bncsd,bncde->bncse", R(q_inter), R(c_prev))
    inter_norm = torch.einsum("bncsd,bncd->bncs", q_inter, n_prev)

    normalizer = torch.maximum((e.sum(dim=-1) + inter_norm).abs(),
                               torch.exp(-stab))[..., None] + eps
    intra_num = torch.einsum("bncst,bnctd->bncsd", R(e), R(vc))
    h = ((intra_num + inter_num) / normalizer).reshape(B, NH, S, DV)
    if return_last_state:
        return h, (c_st, n_st, m_st)
    return h
