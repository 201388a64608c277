"""One detection training step.

Port of the ``train_step`` that ``Trainer._build_step`` builds in
``xlstm_yolo_tpu/engine/trainer.py``, without mesh, device augmentation or
gradient accumulation: uint8 images are normalized on the device, the
train-mode forward and the v8 loss run, then the backward and the step
update (``utils.train_utils.StepUpdate``). The stages are also callable one
by one, for timing. The epoch loop (dataset, loader, validation,
checkpoints, warm-up and schedule) is not ported yet.
"""
from __future__ import annotations

import torch

from ..utils.train_utils import StepUpdate


class TrainStep:
    """``TrainStep(model)(batch) -> (loss, {"box", "cls", "dfl"})``; puts
    ``model`` in train mode. The optimizer's trace and the EMA live in
    ``self.update``; ``n_updates`` counts the steps taken."""

    def __init__(self, model, lr: float = 0.01, momentum: float = 0.937,
                 weight_decay: float = 5e-4):
        self.model = model.train()
        self.update = StepUpdate(model, lr=lr, momentum=momentum, weight_decay=weight_decay)
        self.n_updates = 0

    def forward_loss(self, batch: dict):
        """Normalize uint8 images (/255), then forward + loss."""
        img = batch["img"]
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        return self.model.loss({**batch, "img": img})

    def backward(self, total: torch.Tensor) -> None:
        for p in self.update.params:
            p.grad = None
        total.backward()

    def apply_update(self) -> None:
        self.n_updates += 1
        self.update(self.n_updates)

    def __call__(self, batch: dict):
        total, aux = self.forward_loss(batch)
        self.backward(total)
        self.apply_update()
        return total.detach(), {k: v.detach() for k, v in aux.items()}
