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

``fit_steps`` is the loop's schedule alone, over batches that are already
on the device: the per-epoch ``lr_schedule`` with the trainer's linear
warm-up over the first steps.

``Trainer`` is the port of the JAX ``Trainer`` (``train``, without the
device mesh, device augmentation, multi-scale, profiling and preemption):
the dataset's loader (uint8 batches, pinned for the copy to the card), the
model rebuilt to the dataset's class count with the weights of matching
name and shape carried over, accumulation to a nominal batch of ``nbs``,
the schedule and warm-up of ``fit_steps``, ``close_mosaic``, validation of
the EMA parameters (with the live BatchNorm statistics) after every epoch,
``best.pt`` / ``last.pt``, ``resume`` from ``last.pt`` (weights, optimizer
state, EMA, update count and the loader's epoch, so that a resumed run
continues as the uninterrupted one would), ``EarlyStopping``, the CSV log
with the JAX trainer's columns, and the callbacks.
"""
from __future__ import annotations

import copy
import csv
import math
import time
from pathlib import Path

import torch

from ..cfg import amp_of, get_cfg
from ..utils import resolve_device
from ..utils.callbacks import default_callbacks
from ..utils.checkpoint import load_checkpoint, load_optimizer_state, save_checkpoint
from ..utils.train_utils import (EarlyStopping, StepUpdate, lr_schedule, warmup_lr,
                                 warmup_steps_for)


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


BATCH_KEYS = ("img", "cls_boxes", "mask")


class Trainer:
    """``Trainer(model, overrides={"data": ..., ...}).train()`` -> the last
    validation's metrics. ``overrides`` are ``cfg/default.yaml`` keys; the
    ``device`` key (default ``cuda``) places the run."""

    def __init__(self, model, overrides: dict | None = None, callbacks=None):
        overrides = {k: v for k, v in (overrides or {}).items() if v is not None}
        self.args = get_cfg(overrides=overrides)
        self.device = resolve_device(self.args.device or "cuda")
        self.model = model.to(self.device)
        self.step = None
        self.epoch = self.start_epoch = 0
        self.best_fitness = 0.0
        self.metrics = None
        self.save_dir = Path(self.args.project or "runs/detect") / (self.args.name or "train")
        self.csv = self.save_dir / "results.csv"
        self.callbacks = callbacks if callbacks is not None else default_callbacks()

    def add_callback(self, event: str, func) -> None:
        self.callbacks.add(event, func)

    def run_callbacks(self, event: str) -> None:
        self.callbacks.run(event, self)

    def rebuild(self, nc: int):
        """The model rebuilt with ``nc`` classes (weights from the seed) and
        every tensor of the old one whose name and shape match carried over;
        ``self.transferred`` = (carried, of all). BatchNorm's batch counter,
        which the JAX variables do not hold, is not counted."""
        from ..nn.tasks import TaskModel

        old = self.model
        new = TaskModel(old.yaml, ch=old.ch, nc=nc, scale=old.scale, device=self.device,
                        seed=int(self.args.seed))
        old_state, new_state = old.state_dict(), new.state_dict()
        keys = [k for k in new_state if not k.endswith("num_batches_tracked")]
        hit = [k for k in keys if k in old_state and old_state[k].shape == new_state[k].shape]
        new.load_state_dict({**new_state, **{k: old_state[k] for k in hit}})
        self.transferred = (len(hit), len(keys))
        print(f"rebuilt the model with nc={nc} (was {old.nc}); transferred "
              f"{len(hit)}/{len(keys)} weight tensors")
        return new

    def ema_model(self):
        """A copy of the model holding the EMA parameters and the live
        BatchNorm statistics, in eval mode: what validation and the final
        model read. The training model is left as it is."""
        model = copy.deepcopy(self.step.model)
        with torch.no_grad():
            for p, e in zip(model.parameters(), self.step.update.ema):
                p.grad = None
                p.copy_(e)
        return model.eval().requires_grad_(False)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
                for k in BATCH_KEYS}

    def train(self) -> dict:
        from ..data.dataset import build_dataloader
        from .validator import Validator

        args = self.args
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.run_callbacks("on_pretrain_routine_start")
        imgsz, batch, epochs = int(args.imgsz), int(args.batch), int(args.epochs)
        self.loader, self.data = build_dataloader(
            args.data, "train", batch=batch, imgsz=imgsz, hyp=dict(vars(args)),
            max_labels=int(args.max_labels), seed=int(args.seed), fraction=float(args.fraction),
            single_cls=bool(args.single_cls), cache=args.cache, workers=int(args.workers or 0))
        self.loader.ds.uint8_images = True  # normalized on the device
        self.loader.pin = self.device.type == "cuda"
        resume = None
        if args.resume:
            resume = (Path(args.resume) if isinstance(args.resume, str)
                      else self.save_dir / "last.pt")
            self.model, meta = load_checkpoint(resume, use_ema=False, device=self.device)
            self.start_epoch = int(meta["epoch"]) + 1
            self.best_fitness = float(meta["best_fitness"])
        if self.model.nc != self.data["nc"]:
            self.model = self.rebuild(self.data["nc"])
        self.model.names = self.data["names"] or self.model.names
        nb = len(self.loader)
        accumulate = max(round(args.nbs / batch), 1)
        self.iterations = math.ceil(nb / accumulate) * epochs
        self.step = TrainStep(self.model, lr=args.lr0, momentum=args.momentum,
                              weight_decay=args.weight_decay, optimizer=args.optimizer,
                              iterations=self.iterations, accumulate=accumulate, amp=amp_of(args))
        if resume is not None:
            if not load_optimizer_state(resume, self.step):
                raise ValueError(f"{resume} holds no optimizer state to resume from")
            self.loader.epoch = self.start_epoch
            print(f"resuming from {resume} at epoch {self.start_epoch}")
        self.lr0 = self.step.update.lr
        sched = lr_schedule(self.lr0, args.lrf, epochs, cos_lr=bool(args.cos_lr))
        warmup = warmup_steps_for(args.warmup_epochs, nb, epochs)
        stopper = EarlyStopping(patience=int(args.patience))
        print(f"training {self.model.task} model: {epochs} epochs x {nb} batches (batch {batch}, "
              f"imgsz {imgsz}, optimizer {self.step.update.name}, lr0 {self.lr0}, accumulate "
              f"{accumulate}, {'bf16 AMP' if self.step.amp else 'fp32'}, {self.device})")
        self.run_callbacks("on_pretrain_routine_end")
        self.run_callbacks("on_train_start")

        step = self.start_epoch * nb
        t_start = time.time()
        means, val_metrics, lr = {"loss": float("nan")}, {}, 0.0
        for epoch in range(self.start_epoch, epochs):
            self.epoch = epoch
            self.run_callbacks("on_train_epoch_start")
            if args.close_mosaic and epoch >= max(epochs - int(args.close_mosaic), 0):
                self.loader.ds.hyp["mosaic"] = 0.0
            terms = []
            t0 = time.time()
            for batch_data in self.loader:
                self.run_callbacks("on_train_batch_start")
                lr = warmup_lr(step, epoch, warmup, sched(epoch), args.warmup_bias_lr)
                total, aux = self.step(self._to_device(batch_data), lr)
                terms.append(torch.stack([aux["box"], aux["cls"], aux["dfl"], total]))
                step += 1
                self.run_callbacks("optimizer_step")
                self.run_callbacks("on_before_zero_grad")
                self.run_callbacks("on_train_batch_end")
            # the epoch's mean of each term, in the JAX trainer's (sorted) order
            means = dict(zip(("box", "cls", "dfl", "loss"),
                             torch.stack(terms).double().cpu().numpy().mean(0).tolist()))
            imps = nb * batch / (time.time() - t0)

            fitness, val_metrics = None, {}
            if args.val:
                val_metrics = Validator(self.ema_model(), data=self.data, imgsz=imgsz,
                                        max_labels=int(args.max_labels),
                                        callbacks=self.callbacks)()
                fitness = val_metrics["fitness"]
                if fitness >= self.best_fitness:
                    self.best_fitness = fitness
                    self._save("best", epoch)
            self._log_csv({"epoch": epoch, **{f"train/{k}": v for k, v in means.items()},
                           **{f"metrics/{k}": v for k, v in val_metrics.items()}, "lr": lr,
                           "img_s": round(imps, 1)})
            self.run_callbacks("on_train_epoch_end")
            self.run_callbacks("on_fit_epoch_end")
            print(f"epoch {epoch + 1}/{epochs}: loss {means['loss']:.3f} (box {means['box']:.3f} "
                  f"cls {means['cls']:.3f} dfl {means['dfl']:.3f}) {imps:.0f} img/s"
                  + (f" | fitness {fitness:.4f}" if fitness is not None else ""))
            self._save("last", epoch)
            if stopper(epoch, fitness):
                print(f"early stopping at epoch {epoch} (best {stopper.best_epoch})")
                break

        self.model = self.ema_model()
        self.metrics = val_metrics if args.val else {"train_loss": means["loss"]}
        self.run_callbacks("on_params_update")
        self.run_callbacks("on_train_end")
        print(f"done in {(time.time() - t_start) / 3600:.2f} h; results -> {self.save_dir}")
        self.run_callbacks("teardown")
        return self.metrics

    def _save(self, name: str, epoch: int) -> None:
        if not self.args.save:
            return
        self.run_callbacks("on_model_save")
        save_checkpoint(self.save_dir / f"{name}.pt", self.step, epoch=epoch,
                        best_fitness=self.best_fitness)

    def _log_csv(self, row: dict) -> None:
        new = not self.csv.exists()
        with open(self.csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row.keys()))
            if new:
                w.writeheader()
            w.writerow(row)
