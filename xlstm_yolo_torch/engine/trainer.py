"""Detection training: one step, and the loop of steps around it.

Port of the ``train_step`` that ``Trainer._build_step`` builds in
``xlstm_yolo_tpu/engine/trainer.py``, without mesh or device augmentation,
and of the learning-rate part of ``Trainer.train``'s loop. A step: uint8
images are normalized on the device in fp32, then (AMP, the JAX ``dtype:
bfloat16`` default) cast to bf16; the train-mode forward computes in the
activations' dtype (each module casts its fp32 weights at use, norms and
BatchNorm compute in fp32, the ViL layers run their bf16 kernels on the
card), the v8 loss in fp32; the backward brings fp32 gradients to the fp32
parameters; then the step update (``utils.train_utils.StepUpdate``: clip,
decay, the optimizer, accumulation, EMA) at the step's learning rate. The
stages are also callable one by one, for timing.

``fit_steps`` is the loop's schedule: the per-epoch ``lr_schedule`` with the
trainer's linear warm-up over the first steps. The dataset, loader and
validation of ``Trainer.train``'s epoch loop (and with them its callbacks,
CSV log, best-fitness checkpoints and ``EarlyStopping``) wait for the
validation slice, which brings the data path; ``fit_steps`` takes batches
that are already on the device.
"""
from __future__ import annotations

import torch

from ..utils.train_utils import StepUpdate, lr_schedule, warmup_lr, warmup_steps_for


class TrainStep:
    """``TrainStep(model)(batch) -> (loss, {"box", "cls", "dfl"})``; puts
    ``model`` in train mode. ``amp`` (default, as the JAX ``dtype`` key
    defaults to bfloat16): activations in bf16, parameters, optimizer state
    and EMA fp32; ``amp=False``: fp32 throughout. The optimizer
    (``optimizer`` one of ``train_utils.OPTIMIZERS`` or ``"auto"``, resolved
    from the model's class count and ``iterations`` as the JAX trainer
    resolves it; ``lr`` and ``momentum`` are then its),
    its state, the accumulation and the EMA live in ``self.update``;
    ``n_updates`` counts the calls to the update."""

    def __init__(self, model, lr: float = 0.01, momentum: float = 0.937,
                 weight_decay: float = 5e-4, optimizer: str = "auto", iterations: float = 1e5,
                 accumulate: int = 1, amp: bool = True):
        self.model = model.train()
        self.amp = amp
        self.update = StepUpdate(model, lr=lr, momentum=momentum, weight_decay=weight_decay,
                                 name=optimizer, nc=getattr(model, "nc", 80),
                                 iterations=iterations, accumulate=accumulate)
        self.n_updates = 0

    def forward_loss(self, batch: dict):
        """Normalize uint8 images (/255, fp32), cast them to bf16 under AMP,
        then forward + loss."""
        img = batch["img"]
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        if self.amp:
            img = img.to(torch.bfloat16)
        return self.model.loss({**batch, "img": img})

    def backward(self, total: torch.Tensor) -> None:
        for p in self.update.params:
            p.grad = None
        total.backward()

    def apply_update(self, lr: float | None = None) -> None:
        """One call of the update at ``lr`` (the optimizer's own when None)."""
        self.n_updates += 1
        self.update(self.n_updates, lr)

    def __call__(self, batch: dict, lr: float | None = None):
        total, aux = self.forward_loss(batch)
        self.backward(total)
        self.apply_update(lr)
        return total.detach(), {k: v.detach() for k, v in aux.items()}

    def fit_steps(self, batches, epochs: int, nb: int | None = None, lrf: float = 0.01,
                  warmup_epochs: float = 3.0, cos_lr: bool = False) -> list:
        """``epochs`` passes over ``batches`` (``nb`` of them an epoch, all
        of them when None), one step each, at the learning rate
        ``Trainer.train`` gives the step: ``lr_schedule(epoch)`` from the
        optimizer's lr with final factor ``lrf``, under the linear warm-up
        of ``warmup_steps_for(warmup_epochs, nb, epochs)`` steps (at least
        100, at most half the run). Returns one dict a step: epoch, lr,
        loss and its terms (floats)."""
        batches = list(batches)
        nb = len(batches) if nb is None else nb
        sched = lr_schedule(self.update.lr, lrf, epochs, cos_lr=cos_lr)
        warmup = warmup_steps_for(warmup_epochs, nb, epochs)
        step, log = 0, []
        for epoch in range(epochs):
            for batch in batches[:nb]:
                lr = warmup_lr(step, epoch, warmup, sched(epoch))
                total, aux = self(batch, lr)
                log.append({"epoch": epoch, "lr": lr, "loss": float(total),
                            **{k: float(v) for k, v in aux.items()}})
                step += 1
        return log
