"""The per-step parameter update of the JAX trainer.

Port of ``_is_no_decay`` and of the update ``build_flat_step`` builds in
``xlstm_yolo_tpu/utils/train_utils.py`` (optimizer "SGD"): global-norm
clipping, coupled weight decay under the no-decay mask, nesterov SGD, the
step ``p + u * lr`` and the parameter EMA with its warm-up ramp. The JAX
package ravels the trees into one vector to save launches on the TPU; here
the same elementwise chain runs on the parameter list with multi-tensor
(``torch._foreach_*``) ops.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

CLIP_NORM = 0.5  # a quirk of the reference fork (the reference default is 10)
EMA_DECAY, EMA_TAU = 0.9999, 2000.0  # EMA decay 0.9999 * (1 - exp(-n / 2000))


def is_no_decay(name: str) -> bool:
    """True for the parameters the JAX ``_is_no_decay`` exempts from weight
    decay, read on the port's names: biases, and BatchNorm scale and bias
    (``bn.weight``/``bn.bias``). RMSNorm and outnorm scales and
    ``learnable_skip`` are decayed (a quirk of the reference fork kept by
    the JAX package)."""
    *mods, leaf = name.split(".")
    if leaf == "bias":
        return True
    return leaf in ("weight", "scale") and any(m in ("bn", "norm2") for m in mods)


class StepUpdate:
    """clip (global norm ``CLIP_NORM``) -> coupled decay -> nesterov SGD ->
    ``p + u * lr`` -> EMA over a model's parameters, reading their ``.grad``. ``trace`` is the momentum
    buffer (optax's trace, zero at start) and ``ema`` the averaged
    parameters (BatchNorm statistics are not averaged), both in
    ``model.named_parameters()`` order."""

    def __init__(self, model: nn.Module, lr: float = 0.01, momentum: float = 0.937,
                 weight_decay: float = 5e-4):
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.decayed = [not is_no_decay(n) for n in self.names]
        self.lr, self.momentum, self.weight_decay = lr, momentum, weight_decay
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.ema = [p.detach().clone() for p in self.params]

    @torch.no_grad()
    def __call__(self, n_updates: int) -> None:
        """Apply one update; ``n_updates`` counts this one (1 on the first
        step), as the JAX step receives it."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        # optax.clip_by_global_norm: unchanged below the limit, else g / |g| * limit
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < CLIP_NORM, torch.ones_like(norm), CLIP_NORM / norm)
        grads = torch._foreach_mul(grads, scale)
        dec = [i for i, d in enumerate(self.decayed) if d]
        torch._foreach_add_([grads[i] for i in dec], [self.params[i] for i in dec],
                            alpha=self.weight_decay)
        # optax.trace(nesterov=True): t = g + m t;  u = -(g + m t)
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, grads)
        step = torch._foreach_add(grads, self.trace, alpha=self.momentum)
        torch._foreach_add_(self.params, step, alpha=-self.lr)
        d = EMA_DECAY * (1.0 - math.exp(-n_updates / EMA_TAU))
        torch._foreach_mul_(self.ema, d)
        torch._foreach_add_(self.ema, self.params, alpha=1.0 - d)
