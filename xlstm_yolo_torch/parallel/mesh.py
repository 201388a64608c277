"""The (dp, tp, sp, pp, ep) mesh of ranks, and the sharding of a model
over it.

Port of ``xlstm_yolo_tpu/parallel/mesh.py``. ``build_mesh`` arranges the
ranks (all of the world, or the first n of it) as a ``DeviceMesh`` with the
five axis names, row-major as JAX reshapes its devices; each axis is a
process group, the ranks that differ only along it. The axes:

* ``dp``: each rank takes its contiguous slice of the global batch
  (``shard_batch``, or its loader's shard); the losses, BatchNorm
  statistics and load-balance loss reduce over the dp group
  (``distributed.data_parallel``) and the gradients are summed over it
  (``reduce_grads``), so the step computes what one process computes on the
  global batch;
* ``tp``: parameters the rules shard are stored as this rank's slice and
  made whole for the forward (``gathered``); every tp rank computes the
  same, so per-rank parameter and optimizer memory falls by the rules'
  share while the numbers stay those of the one-process step;
* ``sp``: nothing is sharded over it (as in the JAX trainer): its ranks
  repeat their dp slice's work. ``kernels.mlstm_sp`` is the sequence-
  parallel mLSTM a model may call;
* ``pp``: a pipelined ViL trunk's stacked pairs (``nn.tasks.enable_pipeline``)
  are stored as this rank's stage and run as a GPipe pipeline
  (``parallel.pipeline``);
* ``ep``: an MoE FFN's experts are stored as this rank's share, whose
  outputs are summed over ep (``parallel.moe``).

``param_sharding_rules`` are the JAX rules, read on the JAX tree names and
shapes that ``utils.jax_weights.jax_items`` gives a port model, each mapped
to the port tensor's dimension. A single-process mesh (no world) has no
groups, and every collective is skipped.
"""
from __future__ import annotations

import copy
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from . import distributed as D

AXES = ("dp", "tp", "sp", "pp", "ep")


class Mesh:
    """This rank's view of the mesh: ``shape`` {axis: size}, its coordinate
    along each axis (``index``), each axis's process group (``group_of``)
    and the group of all the mesh's ranks (``group``, the world's when the
    mesh covers it). ``member`` is False on a rank left out of the mesh. A
    mesh is a handle: copying a module that refers to one shares it."""

    def __init__(self, shape: dict, device_mesh=None, group=None, ranks=(0,)):
        self.shape = dict(shape)
        self.device_mesh = device_mesh
        self.group = group
        self.ranks = tuple(ranks)
        coord = None if device_mesh is None else device_mesh.get_coordinate()
        self.member = device_mesh is None or coord is not None
        self._coord = dict(zip(AXES, coord or (0,) * len(AXES)))

    def __deepcopy__(self, memo):
        return self

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES]))

    def index(self, axis: str) -> int:
        return self._coord[axis]

    def group_of(self, axis: str):
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def __repr__(self):
        return "Mesh(" + ", ".join(f"{a}={self.shape[a]}" for a in AXES) + ")"

    # -- the data-parallel step ---------------------------------------------
    @contextmanager
    def step_context(self, model: nn.Module):
        """The forward of one step: the dp group named for the reductions
        over the global batch, the tp-sharded parameters made whole."""
        with D.data_parallel(self.group_of("dp")), self.gathered(model):
            yield

    @torch.no_grad()
    def reduce_grads(self, params) -> None:
        """Sum the gradients of ``params`` over the dp group, in one flat
        all-reduce (a missing gradient counts as zeros)."""
        group = self.group_of("dp")
        if group is None:
            return
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        off = 0
        for p, g in zip(params, grads):
            n = g.numel()
            p.grad = flat[off:off + n].view_as(g).clone()
            off += n

    def global_sq_norm(self, model: nn.Module, names, sq: torch.Tensor) -> torch.Tensor:
        """The squared global norm over every shard, given the squared norm
        of each local gradient (``sq``, in the order of ``names``): the
        replicated parameters' counted once, each sharded axis's summed
        over its group."""
        shards = getattr(model, "_shards", {})
        total = sq.new_zeros(())
        by_axis = {}
        for name, s in zip(names, sq):
            axis = shards[name][0] if name in shards else None
            by_axis[axis] = by_axis.get(axis, 0.0) + s
        for axis in sorted(by_axis, key=str):
            part = by_axis[axis]
            if axis is not None and self.group_of(axis) is not None:
                part = part.clone()
                dist.all_reduce(part, group=self.group_of(axis))
            total = total + part
        return total

    # -- sharded parameters -------------------------------------------------
    @contextmanager
    def gathered(self, model: nn.Module):
        """Inside, each parameter sharded over tp reads as the whole tensor,
        gathered with ``distributed.gather_shard`` (its gradient reaches the
        shard); the pp and ep shards are computed on as they are."""
        swaps = []
        for name, (axis, dim) in getattr(model, "_shards", {}).items():
            if axis != "tp" or self.group_of(axis) is None:
                continue
            mod, leaf = _owner(model, name)
            p = mod._parameters[leaf]
            mod._parameters[leaf] = D.gather_shard(p, self.group_of(axis), dim)
            swaps.append((mod, leaf, p))
        try:
            yield
        finally:
            for mod, leaf, p in reversed(swaps):
                mod._parameters[leaf] = p

    @torch.no_grad()
    def full_values(self, model: nn.Module, values=None) -> list:
        """``values`` (tensors shaped as ``model``'s parameters, in
        ``named_parameters`` order; the parameters themselves when None)
        made whole: each sharded one gathered over its axis. Every rank of
        the mesh must call it."""
        shards = getattr(model, "_shards", {})
        named = list(model.named_parameters())
        values = [p for _, p in named] if values is None else list(values)
        out = []
        for (name, _), v in zip(named, values):
            v = v.detach()
            if name in shards and self.group_of(shards[name][0]) is not None:
                axis, dim = shards[name]
                group = self.group_of(axis)
                v = v.contiguous()
                parts = [torch.empty_like(v) for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, v, group=group)
                v = torch.cat(parts, dim)
            out.append(v)
        return out

    def unsharded(self, model: nn.Module, values=None) -> nn.Module:
        """A copy of ``model`` holding whole parameters (``full_values`` of
        ``values``), its pipelines and expert shares off: what one process
        would hold. Every rank of the mesh must call it."""
        full = self.full_values(model, values)
        out = copy.deepcopy(model)
        for (name, _), v in zip(list(out.named_parameters()), full):
            mod, leaf = _owner(out, name)
            setattr(mod, leaf, nn.Parameter(v.clone(), requires_grad=False))
        for m in out.modules():
            if hasattr(m, "leave_mesh"):
                m.leave_mesh()
        out._shards = {}
        return out

    @torch.no_grad()
    def broadcast_params(self, model: nn.Module) -> None:
        """Every parameter and buffer of ``model`` from the mesh's first
        rank to all of its ranks."""
        if self.group is None:
            return
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t.data, src=self.ranks[0], group=self.group)

    def broadcast_object(self, obj):
        """``obj`` (picklable) from the mesh's first rank to all of its ranks."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.group)
        return box[0]


def _owner(model: nn.Module, name: str):
    *path, leaf = name.split(".")
    return model.get_submodule(".".join(path)), leaf


def build_mesh(dp: int = -1, tp: int = 1, sp: int = 1, pp: int = 1, ep: int = 1,
               ranks=None) -> Mesh:
    """A (dp, tp, sp, pp, ep) mesh over ``ranks`` (the world's, in order,
    when None); dp = -1 fills the rest. Outside a world the mesh is this one
    process. Every rank of the world calls it (the groups are created
    collectively); a rank outside ``ranks`` gets a mesh with ``member``
    False."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    ranks = list(range(world)) if ranks is None else list(ranks)
    n = len(ranks)
    if dp == -1:
        dp = n // (tp * sp * pp * ep)
    assert dp * tp * sp * pp * ep == n, f"mesh {dp}x{tp}x{sp}x{pp}x{ep} != {n} devices"
    shape = dict(zip(AXES, (dp, tp, sp, pp, ep)))
    if world == 1 and not (dist.is_available() and dist.is_initialized()):
        return Mesh(shape)
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.tensor(ranks).reshape(dp, tp, sp, pp, ep),
                    mesh_dim_names=AXES)
    group = dist.group.WORLD if n == world else dist.new_group(ranks)
    return Mesh(shape, dm, group if dist.get_rank() in ranks else None, ranks)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's contiguous dp slice of a global batch (the rows ``P("dp")``
    puts on its device); 0-d entries (scalars) are replicated."""
    dp, i = mesh.shape["dp"], mesh.index("dp")

    def put(x):
        if np.ndim(x) == 0:
            return x
        if x.shape[0] % dp:
            raise ValueError(f"batch of {x.shape[0]} rows does not split over dp={dp}")
        b = x.shape[0] // dp
        return x[i * b:(i + 1) * b]

    return {k: put(v) for k, v in batch.items()}


# the JAX rules' module names (parallel/mesh.py:param_sharding_rules)
COL = ("proj_up", "ffn_proj_up", "igate", "fgate")  # output axis sharded
ROW = ("proj_down", "ffn_proj_down")  # input axis sharded
HEADWISE = ("q_proj", "k_proj", "v_proj", "igate", "fgate", "zgate", "ogate")
FLAT_TP = ("learnable_skip",)
EXPERTS = ("w_gate", "w_up", "w_down")


def jax_rule(mesh: Mesh, names: list, shape: tuple):
    """The JAX rule for one parameter of the JAX tree (its path ``names``,
    its ``shape``): (axis, sharded axis of the JAX array) or None."""
    tp, pp, ep = mesh.shape["tp"], mesh.shape["pp"], mesh.shape["ep"]
    ndim = len(shape)
    if pp > 1 and "pairs" in names and ndim >= 1 and shape[0] % pp == 0:
        return "pp", 0
    if ep > 1 and names[-1] in EXPERTS and ndim >= 1 and shape[0] % ep == 0:
        return "ep", 0
    if tp <= 1:
        return None
    mod, leaf = (names[-2] if len(names) > 1 else ""), names[-1]
    if mod in COL:
        if leaf == "kernel" and ndim == 2 and shape[1] % tp == 0:
            return "tp", 1
        if leaf == "bias" and shape[0] % tp == 0:
            return "tp", 0
    if mod in ROW and leaf == "kernel" and ndim == 2 and shape[0] % tp == 0:
        return "tp", 0
    if mod in HEADWISE and leaf == "weight" and ndim == 3 and shape[0] % tp == 0:
        return "tp", 0
    if mod in HEADWISE and leaf == "bias" and shape[0] % tp == 0:
        return "tp", 0
    if leaf in FLAT_TP and ndim == 1 and shape[0] % tp == 0:
        return "tp", 0
    if ndim >= 2 and shape[-1] % tp == 0 and shape[-1] >= 256:
        return "tp", ndim - 1
    return None


def _port_dim(key: str, shape: tuple, axis: int, transposed) -> int:
    """The dimension of the port tensor that axis ``axis`` of the JAX array
    at ``key`` becomes (``jax_weights.torch_name`` run on a probe that
    counts along that axis)."""
    from ..utils.jax_weights import torch_name

    idx = [1] * len(shape)
    idx[axis] = shape[axis]
    probe = np.broadcast_to(np.arange(shape[axis], dtype=np.float32).reshape(idx), shape)
    _, t = torch_name(key, np.ascontiguousarray(probe), transposed)
    dims = [d for d in range(t.ndim) if t.shape[d] == shape[axis]
            and np.ptp(t, axis=d).any()]
    if len(dims) != 1:
        raise ValueError(f"cannot place axis {axis} of {key!r} {shape} in the port's layout")
    return dims[0]


def param_sharding_rules(mesh: Mesh, model: nn.Module) -> dict:
    """{parameter name: (mesh axis, port tensor dim) or None} for every
    parameter of ``model``: the JAX rules on the JAX tree names and shapes
    (``jax_weights.jax_items``)."""
    from ..utils.jax_weights import jax_items, transposed_convs

    transposed = transposed_convs(model)
    params = dict(model.named_parameters())
    out = {}
    for name, key, jarr in jax_items(model):
        if name not in params:
            continue
        rule = jax_rule(mesh, key.split("/")[1:], jarr.shape)
        out[name] = None if rule is None else (
            rule[0], _port_dim(key, jarr.shape, rule[1], transposed))
    return out


@torch.no_grad()
def shard_params(mesh: Mesh, model: nn.Module) -> dict:
    """Store each parameter the rules shard as this rank's slice (a new
    leaf parameter), and tell the modules that compute on their share
    (``shard_mesh``: the MoE experts) which mesh they are in; returns the
    rules' {name: (axis, dim)} of the sharded ones, kept as
    ``model._shards``. Call it before the optimizer reads the parameters."""
    shards = {}
    if mesh.device_mesh is not None and max(mesh.shape[a] for a in ("tp", "pp", "ep")) > 1:
        shards = {n: r for n, r in param_sharding_rules(mesh, model).items() if r is not None}
    for name, (axis, dim) in shards.items():
        mod, leaf = _owner(model, name)
        p = getattr(mod, leaf)
        n = p.shape[dim] // mesh.shape[axis]
        local = p.detach().narrow(dim, mesh.index(axis) * n, n).clone()
        setattr(mod, leaf, nn.Parameter(local, requires_grad=p.requires_grad))
    for m in model.modules():
        if hasattr(m, "shard_mesh"):
            m.shard_mesh(mesh)
    model._shards = shards
    return shards
