"""Sequence-parallel chunkwise mLSTM over a mesh axis.

Port of ``xlstm_yolo_tpu/kernels/mlstm_sp.py``. The chunkwise form carries
only a small per-head state (C (DQK, DV), n (DQK), m) from one chunk to the
next, so the sequence splits into segments, one a rank, joined by a
prefix over the segments' summaries:

1. ``segment_summary``: each segment's state from a zero initial state
   (C, n, m), plus its total log forget gate ``btot``;
2. ``exclusive_prefix``: the state that enters each segment, the
   composition (``_combine``) of the summaries before it, from zeros;
3. ``seeded_pass``: each segment's output from that state.

``mlstm_chunkwise_sp`` runs the three on a rank's segment, with one
all-gather of the packed summaries over the ``sp`` group between 1 and 2 (its
backward sums each summary's gradient over the ranks that read it). The
three functions need no collective, so one process can run the algorithm
over segments of a sequence it holds whole. The local passes are
``mlstm_native.mlstm_chunkwise``, as the JAX function runs
``mlstm_native`` (not a Pallas kernel): the port's kernel K1 takes no
initial state and returns no last state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .mlstm_native import mlstm_chunkwise


def _combine(seg_a, seg_b):
    """Sequential composition of two segment summaries (A then B), each
    (C, n, m, btot)."""
    c_a, n_a, m_a, b_a = seg_a
    c_b, n_b, m_b, b_b = seg_b
    m = torch.maximum(m_a + b_b, m_b)
    decay_a = torch.exp(m_a + b_b - m)[..., None, None]
    decay_b = torch.exp(m_b - m)[..., None, None]
    c = c_a * decay_a + c_b * decay_b
    n = n_a * decay_a[..., 0] + n_b * decay_b[..., 0]
    return (c, n, m, b_a + b_b)


def segment_summary(q, k, v, i_preact, f_preact, chunk_size: int = 64,
                    igate_act: str = "exp"):
    """A segment's (C, n, m) from a zero state and its total log forget
    gate btot (B, NH); fp32."""
    _, (c, n, m) = mlstm_chunkwise(q, k, v, i_preact, f_preact, chunk_size=chunk_size,
                                   igate_act=igate_act, return_last_state=True)
    btot = F.logsigmoid(f_preact.float()).sum(-1)
    return c, n, m, btot


def exclusive_prefix(summaries) -> list:
    """The state (C, n, m) entering each segment, given every segment's
    summary in order: the first is zeros, each next one the previous
    composed with that segment's summary. The zeros are the first summary
    times 0, so that every state is a function of the summaries (each rank
    of ``mlstm_chunkwise_sp`` then runs the gather's backward, its
    collective, whichever segment it holds)."""
    carry = tuple(t * 0 for t in summaries[0])
    out = []
    for seg in summaries:
        out.append(carry[:3])
        carry = _combine(carry, seg)
    return out


def seeded_pass(q, k, v, i_preact, f_preact, state, chunk_size: int = 64,
                igate_act: str = "exp"):
    """A segment's output (B, NH, S_seg, DV) from the state ``state`` = (C,
    n, m) that enters it."""
    return mlstm_chunkwise(q, k, v, i_preact, f_preact, chunk_size=chunk_size,
                           igate_act=igate_act, initial_state=state)


def mlstm_chunkwise_sp(q, k, v, i_preact, f_preact, mesh, axis: str = "sp",
                       chunk_size: int = 64, igate_act: str = "exp"):
    """This rank's segment of the chunkwise mLSTM with the sequence split
    over ``axis`` of ``mesh`` (``parallel.mesh.Mesh``): q, k (B, NH, S_seg,
    DQK), v (B, NH, S_seg, DV), gates (B, NH, S_seg), the segment of group
    rank r being positions [r S_seg, (r + 1) S_seg) of the whole. S_seg must
    divide by ``chunk_size``. Returns the segment's output, as
    ``mlstm_chunkwise`` on the whole sequence gives it there."""
    from ..parallel.distributed import all_gather

    if q.shape[2] % chunk_size:
        raise ValueError(f"segment length {q.shape[2]} must divide by chunk_size {chunk_size}")
    group, idx, sp = mesh.group_of(axis), mesh.index(axis), mesh.shape[axis]
    summ = segment_summary(q, k, v, i_preact, f_preact, chunk_size, igate_act)
    packed = all_gather(torch.cat([t.reshape(1, -1) for t in summ], 1), group)  # (sp, ...)
    sizes = [t.numel() for t in summ]
    segs = [tuple(p.reshape(t.shape) for p, t in zip(row.split(sizes), summ)) for row in packed]
    prefix = exclusive_prefix(segs)
    return seeded_pass(q, k, v, i_preact, f_preact, prefix[idx], chunk_size, igate_act)
