"""Detection training: one step, and the loop of steps around it.

Port of the ``train_step`` that ``Trainer._build_step`` builds in
``xlstm_yolo_tpu/engine/trainer.py``, without mesh, and of the
learning-rate part of ``Trainer.train``'s loop. A step: uint8 images are
normalized on the device in fp32; with ``augment`` (the ``device_augment``
key) the batch is augmented there in fp32 (``data.device_augment``: mosaic,
affine, HSV, flip, drawn from a generator seeded by the seed and the update
count); then (AMP, the JAX ``dtype: bfloat16`` default) cast to bf16; the
train-mode forward computes in the activations' dtype (each module casts
its fp32 weights at use, norms and BatchNorm compute in fp32, the ViL layers
run their bf16 kernels on the card), the v8 loss in fp32; the backward brings fp32 gradients to the fp32
parameters; then the step update (``utils.train_utils.StepUpdate``: clip,
decay, the optimizer, accumulation, EMA) at the step's learning rate. The
stages are also callable one by one, for timing.

``fit_steps`` is the loop's schedule alone, over batches that are already
on the device: the per-epoch ``lr_schedule`` with the trainer's linear
warm-up over the first steps.

``Trainer`` is the port of the JAX ``Trainer`` (``train``, without the
device mesh, profiling and preemption): the dataset's loader (uint8
batches, pinned for the copy to the card; letterbox only, in file order and
keeping the last partial batch, under ``device_augment``), ``multi_scale``
(each batch rescaled on the device to a size drawn on the host from five
stride-aligned sizes, ``multi_scale_sizes`` and ``ms_rescale``), the
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

import numpy as np
import torch

from ..cfg import amp_of, get_cfg
from ..data import device_augment as DA
from ..ops.letterbox import resize_bilinear
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
    ``n_updates`` counts the calls to the update. ``augment`` (hyp keys,
    ``device_augment.aug_hyp``; None: off) augments every batch on its
    device before the forward, from draws seeded by (``seed``,
    ``n_updates``); whether the mosaic canvas is used is fixed here by
    ``augment["mosaic"]`` > 0, and ``mosaic_p``, the chance an image takes
    it, starts at that value (``close_mosaic`` zeros it)."""

    def __init__(self, model, lr: float = 0.01, momentum: float = 0.937,
                 weight_decay: float = 5e-4, optimizer: str = "auto", iterations: float = 1e5,
                 accumulate: int = 1, amp: bool = True, augment: dict | None = None,
                 seed: int = 0):
        self.model = model.train()
        self.amp = amp
        self.update = StepUpdate(model, lr=lr, momentum=momentum, weight_decay=weight_decay,
                                 name=optimizer, nc=getattr(model, "nc", 80),
                                 iterations=iterations, accumulate=accumulate)
        self.n_updates = 0
        self.augment = None if augment is None else DA.aug_hyp(augment)
        self.mosaic_p = None if augment is None else self.augment["mosaic"]
        self.seed = int(seed)

    def augment_draws(self, B: int, S: int, device) -> DA.Draws:
        """This step's random choices for B images of (S, S), on ``device``."""
        g = DA.step_generator(self.seed, self.n_updates, device)
        return DA.draw(B, S, self.augment, self.mosaic_p, g)

    def augment_batch(self, batch: dict) -> dict:
        """The batch (images fp32 in [0, 1]) augmented on its device, as the
        JAX step augments it: on the images times 255, the result over 255."""
        img = batch["img"]
        d = self.augment_draws(img.shape[0], img.shape[1], img.device)
        out, cb, mk = DA.apply(img * 255.0, batch["cls_boxes"], batch["mask"], d, self.augment)
        return {**batch, "img": out / 255.0, "cls_boxes": cb, "mask": mk}

    def forward_loss(self, batch: dict):
        """Normalize uint8 images (/255, fp32), augment the batch when
        ``augment`` is set, cast the images to bf16 under AMP, then forward +
        loss."""
        img = batch["img"]
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        batch = {**batch, "img": img}
        if self.augment is not None:
            batch = self.augment_batch(batch)
        if self.amp:
            batch["img"] = batch["img"].to(torch.bfloat16)
        return self.model.loss(batch)

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


def multi_scale_sizes(imgsz: int, multi_scale: bool, strides) -> list:
    """The sizes a ``multi_scale`` run draws from, as the JAX trainer's
    bucket: (0.5, 0.75, 1, 1.25, 1.5) times ``imgsz``, rounded to the
    largest stride (at least 32); none when off."""
    if not multi_scale:
        return []
    ms, gs = 0.5, max(32, int(max(strides)))
    return sorted({max(gs, int(round(imgsz * f / gs)) * gs)
                   for f in (1 - ms, 1 - ms / 2, 1.0, 1 + ms / 2, 1 + ms)})


def ms_rescale(batch: dict, sz: int, imgsz: int) -> dict:
    """A batch of ``imgsz`` images rescaled on its device to ``sz``: uint8
    images to fp32 / 255 first, resized as ``jax.image.resize`` bilinear;
    the boxes scaled by sz / imgsz."""
    img = batch["img"]
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    cb = batch["cls_boxes"]
    return {**batch, "img": resize_bilinear(img, sz, sz),
            "cls_boxes": torch.cat([cb[..., :1], cb[..., 1:] * (sz / imgsz)], -1)}


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
        dev_aug = bool(args.device_augment)
        # with the augmentation on the device the host path is letterbox-only
        self.loader, self.data = build_dataloader(
            args.data, "train", batch=batch, imgsz=imgsz, augment=False if dev_aug else None,
            hyp=dict(vars(args)), max_labels=int(args.max_labels), seed=int(args.seed),
            fraction=float(args.fraction), single_cls=bool(args.single_cls), cache=args.cache,
            workers=int(args.workers or 0))
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
                              iterations=self.iterations, accumulate=accumulate, amp=amp_of(args),
                              augment=vars(args) if dev_aug else None, seed=int(args.seed))
        # multi-scale: one size a batch, drawn on the host from a fixed bucket
        ms_sizes = multi_scale_sizes(imgsz, args.multi_scale, self.model.strides)
        ms_rng = np.random.default_rng(int(args.seed) + 4242)
        self._ms_sizes_used = set()
        if resume is not None:
            if not load_optimizer_state(resume, self.step):
                raise ValueError(f"{resume} holds no optimizer state to resume from")
            self.loader.epoch = self.start_epoch
            for _ in range(self.start_epoch * nb if ms_sizes else 0):  # the sizes drawn so far
                ms_rng.choice(ms_sizes)
            print(f"resuming from {resume} at epoch {self.start_epoch}")
        self.lr0 = self.step.update.lr
        sched = lr_schedule(self.lr0, args.lrf, epochs, cos_lr=bool(args.cos_lr))
        warmup = warmup_steps_for(args.warmup_epochs, nb, epochs)
        stopper = EarlyStopping(patience=int(args.patience))
        print(f"training {self.model.task} model: {epochs} epochs x {nb} batches (batch {batch}, "
              f"imgsz {imgsz}, optimizer {self.step.update.name}, lr0 {self.lr0}, accumulate "
              f"{accumulate}, {'bf16 AMP' if self.step.amp else 'fp32'}, {self.device}"
              + (", device augmentation" if dev_aug else "")
              + (f", multi-scale {ms_sizes}" if ms_sizes else "") + ")")
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
                if dev_aug:  # the step keeps its 2S canvas; no image takes the mosaic
                    self.step.mosaic_p = 0.0
            terms = []
            t0 = time.time()
            for batch_data in self.loader:
                self.run_callbacks("on_train_batch_start")
                lr = warmup_lr(step, epoch, warmup, sched(epoch), args.warmup_bias_lr)
                db = self._to_device(batch_data)
                if ms_sizes:
                    sz = int(ms_rng.choice(ms_sizes))
                    self._ms_sizes_used.add(sz)
                    if sz != imgsz:
                        db = ms_rescale(db, sz, imgsz)
                total, aux = self.step(db, lr)
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
