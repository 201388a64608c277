"""Mixture-of-experts feed-forward, with expert parallelism over an ``ep``
axis.

Port of ``xlstm_yolo_tpu/parallel/moe.py``: top-k token routing over E
SwiGLU experts, a dense one-hot combine (every expert sees every token,
the combine zeroes the unrouted pairs), and the Switch load-balance loss
E * sum(frac * imp). Under a mesh with ep > 1 (``parallel.mesh.shard_params``
stores E / ep experts a rank and calls ``shard_mesh``) each rank computes
its experts' share of the combine on its tokens, and the shares are summed
over ep: the sum's gradient passes to each share (``reduce_from``), the
combine weights' and the expert input's gradients, split by expert over
the ranks, are summed back (``copy_to``), so that every ep rank holds the
whole gradient of the router and of the code before it.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import distributed as D


def _lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    """flax's ``lecun_normal`` on a kernel whose last two axes are (in,
    out): truncated normal with variance 1 / (in x the leading axes'
    size)."""
    fan_in = w.numel() // w.shape[-1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


class MoEFeedForward(nn.Module):
    """Top-k routed SwiGLU expert FFN: x (B, S, D) -> (B, S, D) in x's
    dtype (the experts compute in fp32, the router in x's dtype). Parameters
    ``router.weight`` (E, D) (no bias), ``w_gate`` / ``w_up`` (E, D, F),
    ``w_down`` (E, F, D), F = dim x ``proj_factor`` rounded up to
    ``round_up_to``. After each forward ``aux`` holds the load-balance loss
    over the global batch, divided by the data-parallel size (the ranks'
    shares sum to it; ``distributed.data_parallel``)."""

    def __init__(self, dim: int, num_experts: int = 4, top_k: int = 1,
                 proj_factor: float = 2.6667, round_up_to: int = 64):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must be in [1, num_experts={num_experts}]")
        D_, E = dim, num_experts
        F_ = int(-(-dim * proj_factor // round_up_to) * round_up_to)
        self.dim, self.num_experts, self.top_k, self.hidden = D_, E, top_k, F_
        self.router = nn.Linear(D_, E, bias=False)
        self.w_gate = nn.Parameter(torch.empty(E, D_, F_))
        self.w_up = nn.Parameter(torch.empty(E, D_, F_))
        self.w_down = nn.Parameter(torch.empty(E, F_, D_))
        self.ep_mesh = None
        self.aux = None

    @torch.no_grad()
    def init_params(self, g: torch.Generator) -> None:
        w = torch.empty(self.dim, self.num_experts)  # flax's (in, out) kernel
        _lecun_normal_(w, g)
        self.router.weight.copy_(w.T)
        for p in (self.w_gate, self.w_up, self.w_down):
            _lecun_normal_(p, g)

    def shard_mesh(self, mesh) -> None:
        """Compute on this rank's share of the experts when
        ``shard_params`` stored one."""
        if self.w_gate.shape[0] < self.num_experts:
            self.ep_mesh = mesh

    def leave_mesh(self) -> None:
        self.ep_mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        E, K = self.num_experts, self.top_k
        logits = F.linear(x, self.router.weight.to(x.dtype))
        probs = logits.float().softmax(-1)  # (B, S, E)
        topi = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :K]
        topv = probs.gather(-1, topi)
        topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
        comb = (F.one_hot(topi, E).float() * topv[..., None]).sum(-2)  # (B, S, E)

        xf = x.float()
        group = None if self.ep_mesh is None else self.ep_mesh.group_of("ep")
        e_loc = self.w_gate.shape[0]
        e0 = 0 if self.ep_mesh is None else self.ep_mesh.index("ep") * e_loc
        comb_loc = D.copy_to(comb, group)[..., e0:e0 + e_loc]
        xe = D.copy_to(xf, group)
        g = torch.einsum("bsd,edf->besf", xe, self.w_gate.float())
        u = torch.einsum("bsd,edf->besf", xe, self.w_up.float())
        y_e = torch.einsum("besf,efd->besd", F.silu(g) * u, self.w_down.float())
        y = D.reduce_from(torch.einsum("besd,bse->bsd", y_e, comb_loc), group)

        # the Switch load-balance loss over the global batch
        n_tok = D.dp_total(torch.tensor(float(probs.shape[0] * probs.shape[1]),
                                        device=probs.device))
        frac = D.dp_total((comb > 0).float().sum((0, 1))) / n_tok
        imp = D.dp_sum(probs.sum((0, 1))) / n_tok
        self.aux = E * (frac * imp).sum() / D.dp_size()
        return y.to(x.dtype)


def expert_sharding(mesh, model: nn.Module) -> dict:
    """{parameter name: ("ep", dim) or None}: the ep entries of the mesh's
    rules (``mesh.param_sharding_rules``: a leading expert axis over ep),
    the rest replicated (the JAX ``expert_sharding``)."""
    from .mesh import param_sharding_rules

    return {n: r if r is not None and r[0] == "ep" else None
            for n, r in param_sharding_rules(mesh, model).items()}
