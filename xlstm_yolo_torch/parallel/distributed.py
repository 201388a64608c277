"""The torchrun bootstrap, and the collectives the model code calls.

Port of ``xlstm_yolo_tpu/parallel/distributed.py``. JAX connects its
processes with ``jax.distributed.initialize`` and then jits over a global
mesh; here each rank is a process that torchrun starts with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set, and
``ensure_initialized`` joins them into one ``torch.distributed`` world:
NCCL when the run's device is CUDA (each rank on the card ``cuda:{LOCAL_RANK}``,
``utils.resolve_device``), gloo on the CPU. With none of those variables it
is a no-op that returns (0, 1), so every entry point may call it.

The collectives are autograd functions, each with the backward its use
needs. A rank's loss is its share of the global loss (the data-parallel
ranks' losses sum to it: ``utils.loss`` divides by global normalizers), so
a sum over ranks in the forward sums the gradients in the backward
(``all_reduce_sum``, ``all_gather``); a value that every rank of a group
computes alike takes the gradient its own computation gives it
(``gather_shard`` averages the identical gradients and keeps its slice,
``reduce_from`` passes the gradient through, Megatron's g), and an input
whose uses are split over a group sums their gradients (``copy_to``,
Megatron's f).

``data_parallel(group)`` names the data-parallel group for the code that
reduces over the global batch: the train-mode BatchNorm's statistics
(``nn.modules.batch_norm_train``), the loss's normalizers
(``utils.loss``) and the MoE load-balance loss (``parallel.moe``). Without
one (the default), nothing is reduced.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch
import torch.distributed as dist

_DP_GROUP = None  # the data-parallel group of the step running now (data_parallel)


def ensure_initialized(device: str | torch.device = "cuda") -> tuple[int, int]:
    """Join torchrun's world if this process was started in one; returns
    (rank, world size). The backend is NCCL for a CUDA ``device`` and gloo
    for the CPU; idempotent."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return 0, 1
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return rank, world


def local_shard() -> tuple[int, int]:
    """(shard index, shard count) of this process: its rank and the world's
    size, (0, 1) outside a world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """Rank 0, or a process outside any world: the one that logs and writes."""
    return local_shard()[0] == 0


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)  # NCCL takes contiguous tensors
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """All ranks' ``x`` concatenated along ``dim`` in group-rank order; the
    backward sums the output's gradient over the group, scaled by
    ``scale``, and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, dim, scale):
        ctx.group, ctx.dim, ctx.scale = group, dim, scale
        ctx.n, ctx.me = x.shape[dim], dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        if ctx.scale != 1.0:
            g = g * ctx.scale
        return g.narrow(ctx.dim, ctx.me * ctx.n, ctx.n).contiguous(), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient is summed over the
    group too (each rank's loss a share of the total)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; the gradient of each
    rank's part is the sum over the group of the gradients it received."""
    return x if group is None else _AllGather.apply(x, group, dim, 1.0)


def gather_shard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A parameter's shards made whole, for ranks that all compute the same
    thing with it: the gradient each rank gets is the mean over the group of
    the whole gradient, sliced to its shard (the means of equal values)."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim, 1.0 / dist.get_world_size(group))


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, whose gradient sums its uses over ``group`` (each
    rank uses it for its share of the work)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of the ranks' shares, a value every rank then
    holds alike: its gradient passes to each share unchanged."""
    return x if group is None else _ReduceFrom.apply(x, group)


@contextmanager
def data_parallel(group):
    """Name ``group`` as the data-parallel group for the code run inside."""
    global _DP_GROUP
    old, _DP_GROUP = _DP_GROUP, group
    try:
        yield
    finally:
        _DP_GROUP = old


def dp_group():
    return _DP_GROUP


def dp_size() -> int:
    return 1 if _DP_GROUP is None else dist.get_world_size(_DP_GROUP)


def dp_total(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data-parallel group, with no gradient; ``x``
    itself when there is none."""
    if _DP_GROUP is None:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=_DP_GROUP)
    return y


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data-parallel group, differentiably."""
    return all_reduce_sum(x, _DP_GROUP)
