"""GPipe over the ``pp`` axis of a mesh.

Port of ``xlstm_yolo_tpu/parallel/pipeline.py``. Each pp rank holds one
stage's parameters (``stage_slice`` of ``stack_stage_params``); the batch
splits into M microbatches that pass rank to rank, one hop a tick, in the
GPipe schedule of M + P - 1 ticks: at tick t rank r works (``active``) when
r <= t < M + r, on microbatch t - r, which rank 0 takes from the queue and
every other rank from its left neighbour; the last stage banks its
outputs, and the result is then broadcast from it, so that every pp rank
holds it (JAX: a psum of a one-hot).

Torch has no autograd through ``send`` / ``recv``, so the schedule is one
``torch.autograd.Function``. Its forward runs the ticks without recording,
keeping each microbatch's input to this rank's stage. Its backward runs the
schedule in reverse (the last stage first, one hop to rank - 1 a tick):
each rank recomputes its stage on the kept input under grad, as reentrant
checkpointing does, and takes the gradients of its stage's parameters
(summed over microbatches) and of the stage's input; rank 0's input
gradients are broadcast, so that the code before the pipeline, which every
pp rank runs alike, sees the whole gradient on every rank. The output's
gradient is the same on every pp rank (the code after the pipeline also
runs alike); the last stage reads it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def stack_stage_params(stage_params: list) -> dict:
    """Per-stage {name: tensor} dicts -> {name: tensor stacked on a new
    leading stage axis}."""
    return {k: torch.stack([p[k] for p in stage_params]) for k in stage_params[0]}


def stage_slice(mesh, stacked: dict) -> dict:
    """This pp rank's stage of stacked parameters (what JAX's
    ``stage_sharding`` places on its device)."""
    return {k: v[mesh.index("pp")] for k, v in stacked.items()}


def _hop(t: torch.Tensor, group, dst: int, src: int) -> torch.Tensor:
    """Send ``t`` to global rank ``dst`` and receive a tensor like it from
    ``src`` (a ring step, every rank at once)."""
    t = t.contiguous()  # NCCL sends and receives contiguous tensors
    buf = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, dst, group),
                                   dist.P2POp(dist.irecv, buf, src, group)])
    for r in reqs:
        r.wait()
    return buf


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x, *params):
        mesh, stage_fn, names, M = sched
        group, P, r = mesh.group_of("pp"), mesh.shape["pp"], mesh.index("pp")
        peers = dist.get_process_group_ranks(group)
        stage = dict(zip(names, params))
        mb = x.contiguous().reshape(M, x.shape[0] // M, *x.shape[1:])
        inputs, buf = [None] * M, torch.zeros_like(mb)
        cur = torch.zeros_like(mb[0])
        for t in range(M + P - 1):
            if r == 0:
                cur = mb[min(t, M - 1)]
            if r <= t < M + r:
                inputs[t - r] = cur
                out = stage_fn(stage, cur)
            else:
                out = cur
            if r == P - 1 and t >= P - 1:
                buf[t - (P - 1)] = out
            if t < M + P - 2:
                cur = _hop(out, group, peers[(r + 1) % P], peers[(r - 1) % P])
        dist.broadcast(buf, src=peers[P - 1], group=group)
        ctx.sched, ctx.inputs, ctx.shape = sched, inputs, x.shape
        ctx.save_for_backward(*params)
        return buf.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        mesh, stage_fn, names, M = ctx.sched
        group, P, r = mesh.group_of("pp"), mesh.shape["pp"], mesh.index("pp")
        peers = dist.get_process_group_ranks(group)
        params = ctx.saved_tensors
        gmb = g.contiguous().reshape(M, g.shape[0] // M, *g.shape[1:])
        gparams = [torch.zeros_like(p) for p in params]
        gx = torch.zeros_like(gmb)
        cur = torch.zeros_like(gmb[0])
        d = P - 1 - r  # this rank's place in the reverse schedule
        for t in range(M + P - 1):
            if r == P - 1:
                cur = gmb[min(t, M - 1)]
            if d <= t < M + d:
                with torch.enable_grad():
                    a = ctx.inputs[t - d].detach().requires_grad_()
                    ps = [p.detach().requires_grad_(p.requires_grad) for p in params]
                    out = stage_fn(dict(zip(names, ps)), a)
                    wrt = [a] + [p for p in ps if p.requires_grad]
                    got = iter(torch.autograd.grad(out, wrt, cur, allow_unused=True))
                ga = next(got)
                ga = torch.zeros_like(a) if ga is None else ga
                for i, p in enumerate(ps):
                    if p.requires_grad:
                        gp = next(got)
                        if gp is not None:
                            gparams[i] += gp
                out_g = ga
            else:
                out_g = cur
            if r == 0 and t >= P - 1:
                gx[t - (P - 1)] = out_g
            if t < M + P - 2:
                cur = _hop(out_g, group, peers[(r - 1) % P], peers[(r + 1) % P])
        dist.broadcast(gx, src=peers[0], group=group)
        return (None, gx.reshape(ctx.shape),
                *[gp if p.requires_grad else None for gp, p in zip(gparams, params)])


def _run(mesh, stage_fn, stage_params: dict, x: torch.Tensor, M: int) -> torch.Tensor:
    if mesh.shape["pp"] == 1 or mesh.group_of("pp") is None:
        if mesh.shape["pp"] != 1:
            raise ValueError(f"a pipeline over pp={mesh.shape['pp']} needs a mesh in a world")
        return stage_fn(stage_params, x)
    names = list(stage_params)
    return _GPipe.apply((mesh, stage_fn, names, M), x, *[stage_params[k] for k in names])


def pipeline_apply(mesh, stage_fn, stage_params: dict, x: torch.Tensor, *,
                   num_microbatches: int) -> torch.Tensor:
    """``x`` (B, ...) through the pp stages; every pp rank returns the last
    stage's output. ``stage_fn(stage_params, activations) -> activations``
    of the same shape, applied by each rank to its own stage's
    ``stage_params``; B must divide into ``num_microbatches``, which must
    fill the pipeline."""
    pp, B, M = mesh.shape["pp"], x.shape[0], num_microbatches
    assert B % M == 0, f"batch {B} % microbatches {M} != 0"
    assert M >= pp, f"need >= {pp} microbatches to fill a {pp}-stage pipeline"
    return _run(mesh, stage_fn, stage_params, x, M)


def pipeline_apply_nested(mesh, stage_fn, stage_params: dict, x: torch.Tensor, *,
                          num_microbatches: int) -> torch.Tensor:
    """GPipe over the pp axis of a (dp, tp, sp, pp, ep) mesh inside a step:
    ``x`` is this rank's dp slice (each dp rank pipelines its own), the
    other axes replicate."""
    M = num_microbatches
    assert x.shape[0] % M == 0, f"local batch {x.shape[0]} % microbatches {M} != 0"
    return _run(mesh, stage_fn, stage_params, x, M)
