"""The per-step parameter update, learning-rate schedule and early stopping
of the JAX trainer.

Port of ``_is_no_decay``, ``auto_optimizer_name``, the update
``build_flat_step`` builds (``_flat_parts`` wrapped in ``optax.MultiSteps``
when accumulating), ``lr_schedule``, ``warmup_lr`` and ``EarlyStopping`` in
``xlstm_yolo_tpu/utils/train_utils.py``. The update: global-norm clipping,
coupled weight decay under the no-decay mask, the optimizer's direction
(SGD with nesterov momentum, Adam, AdamW, NAdam, RAdam or RMSProp, each as
optax computes it at learning rate 1), the step ``p + u * lr`` and the
parameter EMA with its warm-up ramp. The JAX package ravels the trees into
one vector to save launches on the TPU; here the same elementwise chain
runs on the parameter list with multi-tensor (``torch._foreach_*``) ops.
Parameters, optimizer state and EMA are fp32 whatever the step's compute
dtype, as in the JAX AMP step.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

CLIP_NORM = 0.5  # a quirk of the reference fork (the reference default is 10)
EMA_DECAY, EMA_TAU = 0.9999, 2000.0  # EMA decay 0.9999 * (1 - exp(-n / 2000))
OPTIMIZERS = ("SGD", "Adam", "AdamW", "NAdam", "RAdam", "RMSProp")
ADAM_B2, ADAM_EPS = 0.999, 1e-8  # optax.adam / nadam / radam as _flat_parts builds them
RMS_DECAY, RMS_EPS = 0.9, 1e-8  # optax.rmsprop's defaults (eps inside the square root)
RADAM_THRESHOLD = 5.0


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


def auto_optimizer_name(nc: int, iterations: float) -> tuple[str, float, float]:
    """The optimizer ``"auto"`` resolves to: SGD (lr 0.01, momentum 0.937)
    for runs of more than 10,000 iterations, else AdamW with the fitted lr
    and momentum 0.9 -> (name, lr, momentum)."""
    if iterations > 10000:
        return "SGD", 0.01, 0.937
    return "AdamW", round(0.002 * 5 / (4 + nc), 6), 0.9


class StepUpdate:
    """clip (global norm ``CLIP_NORM``) -> coupled decay -> the optimizer's
    direction -> ``p + u * lr`` -> EMA over a model's parameters, reading
    their ``.grad``. ``name`` is one of ``OPTIMIZERS`` or ``"auto"``
    (``auto_optimizer_name`` of ``nc`` and ``iterations`` then sets it, lr
    and momentum); ``momentum`` is Adam's b1 for the Adam family. With
    ``accumulate`` k > 1 the update is ``optax.MultiSteps``: the mean of the
    gradients of k calls drives one optimizer step on the k-th, the others
    leave the parameters (and the optimizer state) as they are; the EMA
    moves on every call. State, in ``model.named_parameters()`` order:
    ``trace`` (SGD's and RMSProp's momentum), ``mu``/``nu`` (the Adam
    family's moments; ``nu`` also RMSProp's), ``acc`` (the running gradient
    mean), ``count`` (optimizer steps taken), ``mini_step`` and ``ema``
    (the averaged parameters; BatchNorm statistics are not averaged)."""

    def __init__(self, model: nn.Module, lr: float = 0.01, momentum: float = 0.937,
                 weight_decay: float = 5e-4, name: str = "SGD", nc: int = 80,
                 iterations: float = 1e5, accumulate: int = 1):
        if name == "auto":
            name, lr, momentum = auto_optimizer_name(nc, iterations)
        if name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name!r}; one of {OPTIMIZERS} or 'auto'")
        if accumulate < 1:
            raise ValueError(f"accumulate must be at least 1, got {accumulate}")
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.decayed = [not is_no_decay(n) for n in self.names]
        self.name, self.lr, self.momentum, self.weight_decay = name, lr, momentum, weight_decay
        self.accumulate = accumulate
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        self.trace = zeros() if name in ("SGD", "RMSProp") else []
        self.mu = zeros() if name not in ("SGD", "RMSProp") else []
        self.nu = zeros() if name != "SGD" else []
        self.acc = zeros() if accumulate > 1 else []
        self.count = self.mini_step = 0
        self.ema = [p.detach().clone() for p in self.params]

    STATE = ("trace", "mu", "nu", "acc", "ema")

    def state_dict(self) -> dict:
        """Everything a resumed run needs, as tensors and plain numbers."""
        return {"name": self.name, "lr": self.lr, "momentum": self.momentum,
                "count": self.count, "mini_step": self.mini_step,
                **{k: list(getattr(self, k)) for k in self.STATE}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if state["name"] != self.name:
            raise ValueError(f"optimizer state of {state['name']!r}, this update is {self.name!r}")
        self.lr, self.momentum = state["lr"], state["momentum"]
        self.count, self.mini_step = state["count"], state["mini_step"]
        for k in self.STATE:
            mine, theirs = getattr(self, k), state[k]
            if len(mine) != len(theirs):
                raise ValueError(f"optimizer state {k}: {len(theirs)} tensors, expected {len(mine)}")
            for a, b in zip(mine, theirs):
                a.copy_(b)

    @torch.no_grad()
    def __call__(self, n_updates: int, lr: float | None = None) -> None:
        """Apply one update at learning rate ``lr`` (the constructor's when
        None); ``n_updates`` counts this call (1 on the first), as the JAX
        step receives it."""
        lr = self.lr if lr is None else lr
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.accumulate > 1:
            # optax.MultiSteps: the running mean acc += (g - acc) / (mini_step + 1)
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            emit = self.mini_step == self.accumulate - 1
            self.mini_step = (self.mini_step + 1) % self.accumulate
            if emit:
                grads = [a.clone() for a in self.acc]
                torch._foreach_zero_(self.acc)
            else:
                self._ema(n_updates)
                return
        torch._foreach_add_(self.params, self._direction(grads), alpha=lr)
        self._ema(n_updates)

    def _direction(self, grads):
        """The update u of one optimizer step at learning rate 1 (the step
        is p + u * lr): optax's clip_by_global_norm, the masked coupled
        decay, then the optimizer's chain."""
        # optax.clip_by_global_norm: unchanged below the limit, else g / |g| * limit
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < CLIP_NORM, torch.ones_like(norm), CLIP_NORM / norm)
        g = torch._foreach_mul(grads, scale)
        dec = [i for i, d in enumerate(self.decayed) if d]
        torch._foreach_add_([g[i] for i in dec], [self.params[i] for i in dec],
                            alpha=self.weight_decay)
        self.count += 1
        m = self.momentum
        if self.name == "SGD":  # optax.trace(nesterov=True): t = g + m t;  u = -(g + m t)
            torch._foreach_mul_(self.trace, m)
            torch._foreach_add_(self.trace, g)
            u = torch._foreach_add(g, self.trace, alpha=m)
            torch._foreach_neg_(u)
            return u
        if self.name == "RMSProp":  # scale_by_rms, the sign, then trace(m)
            torch._foreach_mul_(self.nu, RMS_DECAY)
            torch._foreach_addcmul_(self.nu, g, g, value=1.0 - RMS_DECAY)
            den = torch._foreach_add(self.nu, RMS_EPS)
            torch._foreach_rsqrt_(den)
            s = torch._foreach_mul(g, den)
            torch._foreach_neg_(s)
            torch._foreach_mul_(self.trace, m)
            torch._foreach_add_(self.trace, s)
            return [t.clone() for t in self.trace]
        # the Adam family (scale_by_adam / scale_by_radam with b1 = momentum)
        torch._foreach_mul_(self.mu, m)
        torch._foreach_add_(self.mu, g, alpha=1.0 - m)
        torch._foreach_mul_(self.nu, ADAM_B2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - ADAM_B2)
        n = self.count
        mu_hat = torch._foreach_div(self.mu, 1.0 - m ** n)
        if self.name == "NAdam":  # b1 mu / (1 - b1^(n+1)) + (1 - b1) g / (1 - b1^n)
            mu_hat = torch._foreach_div(self.mu, (1.0 - m ** (n + 1)) / m)
            torch._foreach_add_(mu_hat, torch._foreach_div(g, (1.0 - m ** n) / (1.0 - m)))
        den = torch._foreach_div(self.nu, 1.0 - ADAM_B2 ** n)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        scale = -1.0
        if self.name == "RAdam":
            ro_inf = 2.0 / (1.0 - ADAM_B2) - 1.0
            b2n = ADAM_B2 ** n
            ro = ro_inf - 2.0 * n * b2n / (1.0 - b2n)
            if ro < RADAM_THRESHOLD:  # the variance is not tractable yet: momentum alone
                return torch._foreach_mul(mu_hat, -1.0)
            scale = -math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                               / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        u = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(u, scale)
        return u

    def _ema(self, n_updates: int) -> None:
        d = EMA_DECAY * (1.0 - math.exp(-n_updates / EMA_TAU))
        torch._foreach_mul_(self.ema, d)
        torch._foreach_add_(self.ema, self.params, alpha=1.0 - d)


def lr_schedule(lr0: float, lrf: float, epochs: int, cos_lr: bool = False):
    """Per-epoch learning rate (the reference's one_cycle, or linear):
    f(epoch) -> lr."""
    if cos_lr:
        return lambda e: lr0 * (((1 - math.cos(e * math.pi / epochs)) / 2) * (lrf - 1) + 1)
    return lambda e: lr0 * max(1 - e / epochs, 0) * (1.0 - lrf) + lr0 * lrf


def warmup_lr(step: int, epoch_f: float, warmup_steps: float, base_lr: float,
              warmup_bias_lr: float = 0.1) -> float:
    """Linear warm-up from 0 to ``base_lr`` over ``warmup_steps`` steps
    (the JAX package's single-scalar form of the reference's; ``epoch_f``
    and ``warmup_bias_lr`` are taken and not read, as there)."""
    if warmup_steps <= 0 or step >= warmup_steps:
        return base_lr
    return base_lr * step / warmup_steps


def warmup_steps_for(warmup_epochs: float, nb: int, epochs: int) -> int:
    """The trainer's warm-up length: ``warmup_epochs`` epochs of ``nb``
    batches, at least 100 steps (the reference's floor), at most half the
    run (so a short run does not spend it all warming up); 0 without
    warm-up."""
    if warmup_epochs <= 0:
        return 0
    return min(max(round(warmup_epochs * nb), 100), max(epochs * nb // 2, 1))


class EarlyStopping:
    """Stop after ``patience`` epochs without a fitness at least as good as
    the best (the reference's EarlyStopping); ``patience`` 0 never stops."""

    def __init__(self, patience: int = 100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float | None) -> bool:
        if fitness is None:
            return False
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        return (epoch - self.best_epoch) >= self.patience
