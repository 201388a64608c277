"""Training of the detect, segment, pose, obb and classify tasks: one step,
and the loop of steps around it.

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
device mesh and preemption): the dataset's loader (uint8
batches, pinned for the copy to the card; letterbox only, in file order and
keeping the last partial batch, under ``device_augment``), ``multi_scale``
(each batch rescaled on the device to a size drawn on the host from five
stride-aligned sizes, ``multi_scale_sizes`` and ``ms_rescale``), the
model rebuilt to the dataset's class count with the weights of matching
name and shape carried over, accumulation to a nominal batch of ``nbs``,
the schedule and warm-up of ``fit_steps``, ``close_mosaic``, the task's
batch keys (``masks`` at ``mask_ratio``, ``keypoints`` with the dataset's
``flip_idx``; an OBB run augments on the host, as the JAX trainer falls
back, whatever ``device_augment`` says; ``multi_scale`` resizes masks by
nearest neighbour and scales keypoints), the ``pose`` / ``kobj`` gains,
validation of
the EMA parameters (with the live BatchNorm statistics) after every epoch,
``best.pt`` / ``last.pt``, ``resume`` from ``last.pt`` (weights, optimizer
state, EMA, update count and the loader's epoch, so that a resumed run
continues as the uninterrupted one would), ``EarlyStopping``, the CSV log
with the JAX trainer's columns, the loss gains of the ``box`` / ``cls`` /
``dfl`` keys, ``plots`` (the last epoch's validation writes its confusion
matrix and curves into the run's directory), ``profile`` (a
``torch.profiler`` trace of the first three steps, each in one
``train_step`` span, written to ``<run>/profile/trace.json``), and the
callbacks. A classify run, as the JAX trainer's: the folder-per-class
loader with the run's keys as its hyp (``auto_augment``, ``erasing``,
``scale``, the flips and HSV gains; ``dropout`` is read by neither
trainer), float32 batches of ``img`` and ``label``, the augmentation on
the host whatever ``device_augment`` says, the ``Classify`` linear rebuilt
to the dataset's classes; per-epoch validation takes the set's root. An
RT-DETR run (task ``rtdetr``), as the JAX trainer's: the dataset assembles
its samples as the point tasks' with no points (the mosaic halved, no
perspective; ``cls_boxes`` as detect's), the augmentation on the host
whatever ``device_augment`` says, the loss with its denoising groups; it
cannot be validated, so ``val=True`` raises before the first step. A
YOLO-World run (task ``world``), as the JAX trainer's: the loader is a
``MultiModalDataset`` that samples each image's class texts (with no
``text_cfg``, as in JAX: unseeded) and, with the trainer's
``text_encoder`` (a ``list[str] -> (n, C)`` callable, e.g.
``nn.clip_text.ClipTextEncoder``), attaches their embeddings as the step's
guide ``txt_feats``; the host-only ``texts`` stay on the host; the
augmentation on the host whatever ``device_augment`` says; validation
scores against the model's own ``txt_feats``.
"""
from __future__ import annotations

import copy
import csv
import json
import math
import time
from contextlib import contextmanager, nullcontext
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
    """``TrainStep(model)(batch) -> (loss, {"box", "cls", "dfl"})`` (the
    task's terms: a classify model's {"cls"}); puts
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
    it, starts at that value (``close_mosaic`` zeros it). ``gains`` (box,
    cls, dfl) weight the loss's terms (the model's defaults when None).
    With a ``mesh`` (``parallel.mesh.Mesh``, the model's parameters already
    sharded by ``shard_params``) the forward runs in its ``step_context``
    (the dp group's reductions, the tp shards gathered), the gradients are
    summed over dp before the update, the clip's norm is over every shard,
    and the loss and terms returned are the global batch's."""

    def __init__(self, model, lr: float = 0.01, momentum: float = 0.937,
                 weight_decay: float = 5e-4, optimizer: str = "auto", iterations: float = 1e5,
                 accumulate: int = 1, amp: bool = True, augment: dict | None = None,
                 seed: int = 0, gains=None, pose_gains=(12.0, 1.0), flip_idx=None,
                 mesh=None):
        self.model = model.train()
        self.mesh = mesh
        self.amp = amp
        self.gains = gains
        self.pose_gains = tuple(pose_gains)
        self.flip_idx = None if flip_idx is None else tuple(int(i) for i in flip_idx)
        self.update = StepUpdate(model, lr=lr, momentum=momentum, weight_decay=weight_decay,
                                 name=optimizer, nc=getattr(model, "nc", 80),
                                 iterations=iterations, accumulate=accumulate)
        if mesh is not None:
            self.update.sq_norm_reduce = (
                lambda sq: mesh.global_sq_norm(model, self.update.names, sq))
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
        JAX step augments it: on the images times 255, the result over 255;
        its masks and keypoints where it has them (``flip_idx``)."""
        img = batch["img"]
        d = self.augment_draws(img.shape[0], img.shape[1], img.device)
        res = DA.apply(img * 255.0, batch["cls_boxes"], batch["mask"], d, self.augment,
                       masks=batch.get("masks"), keypoints=batch.get("keypoints"),
                       flip_idx=self.flip_idx)
        out = {**batch, "img": res[0] / 255.0, "cls_boxes": res[1], "mask": res[2]}
        extra = iter(res[3:])
        for key in ("masks", "keypoints"):
            if key in batch:
                out[key] = next(extra)
        return out

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
        kw = {"pose_gains": self.pose_gains} if getattr(self.model, "task", "") == "pose" else {}
        with self.mesh.step_context(self.model) if self.mesh is not None else nullcontext():
            return self.model.loss(batch, self.gains, **kw)

    def backward(self, total: torch.Tensor) -> None:
        for p in self.update.params:
            p.grad = None
        total.backward()
        if self.mesh is not None:
            self.mesh.reduce_grads(self.update.params)

    def apply_update(self, lr: float | None = None) -> None:
        """One call of the update at ``lr`` (the optimizer's own when None)."""
        self.n_updates += 1
        self.update(self.n_updates, lr)

    def __call__(self, batch: dict, lr: float | None = None):
        total, aux = self.forward_loss(batch)
        self.backward(total)
        self.apply_update(lr)
        total, aux = total.detach(), {k: v.detach() for k, v in aux.items()}
        group = None if self.mesh is None else self.mesh.group_of("dp")
        if group is not None:  # the ranks' shares summed: the global batch's values
            vals = torch.stack([total, *aux.values()])
            torch.distributed.all_reduce(vals, group=group)
            total, aux = vals[0], dict(zip(aux, vals[1:]))
        return total, aux

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


BATCH_KEYS = ("img", "cls_boxes", "mask", "masks", "keypoints", "label", "txt_feats")


def multi_scale_sizes(imgsz: int, multi_scale: bool, strides) -> list:
    """The sizes a ``multi_scale`` run draws from, as the JAX trainer's
    bucket: (0.5, 0.75, 1, 1.25, 1.5) times ``imgsz``, rounded to the
    largest stride (at least 32); none when off."""
    if not multi_scale:
        return []
    ms, gs = 0.5, max(32, int(max(strides, default=32)))
    return sorted({max(gs, int(round(imgsz * f / gs)) * gs)
                   for f in (1 - ms, 1 - ms / 2, 1.0, 1 + ms / 2, 1 + ms)})


def ms_rescale(batch: dict, sz: int, imgsz: int, mask_ratio: int = 4) -> dict:
    """A batch of ``imgsz`` images rescaled on its device to ``sz``: uint8
    images to fp32 / 255 first, resized as ``jax.image.resize`` bilinear;
    the boxes' pixel coordinates scaled by sz / imgsz (an OBB box's angle
    kept), where the batch has boxes; masks to sz / ``mask_ratio`` by
    nearest neighbour (the source index floor((i + 0.5) * in / out), as
    ``jax.image.resize``), keypoints' x, y scaled."""
    img = batch["img"]
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    f = sz / imgsz
    out = {**batch, "img": resize_bilinear(img, sz, sz)}
    if "cls_boxes" in batch:
        cb = batch["cls_boxes"]
        out["cls_boxes"] = torch.cat([cb[..., :1], cb[..., 1:5] * f, cb[..., 5:]], -1)
    if "masks" in batch:
        m = batch["masks"]
        n_in, n_out = m.shape[1], sz // mask_ratio
        idx = ((torch.arange(n_out, device=m.device) + 0.5) * (n_in / n_out)).floor().long()
        out["masks"] = m[:, idx.clamp(max=n_in - 1)][:, :, idx.clamp(max=n_in - 1)]
    if "keypoints" in batch:
        kp = batch["keypoints"]
        out["keypoints"] = torch.cat([kp[..., :2] * f, kp[..., 2:]], -1)
    return out


class StepTrace:
    """A ``torch.profiler`` trace of the first ``n`` train steps (CPU and,
    on the card, CUDA activity), each step in one ``train_step`` span,
    written as a Chrome trace to ``directory/trace.json`` after the n-th
    step, or when the run ends first. ``n`` 0: off. The session ends with
    the trace: the steps after it run as in an untraced run
    (``tools/detect_keys_measure.py`` measures both)."""

    SPAN = "train_step"

    def __init__(self, directory: Path, n: int, device: torch.device):
        self.dir, self.left, self.device = Path(directory), int(n), device
        self.prof = self.path = None
        if self.left > 0:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        if self.prof is not None:
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.stop()

    @contextmanager
    def step(self):
        """One step's span; the trace stops after the n-th."""
        if self.prof is None:
            yield
            return
        with torch.profiler.record_function(self.SPAN):
            yield
        self.left -= 1
        if self.left == 0:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the last step's kernels in the trace
        prof.__exit__(None, None, None)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "trace.json"
        prof.export_chrome_trace(str(self.path))
        print(f"profile: the first train steps' trace -> {self.path}")


def read_step_trace(path) -> dict:
    """A ``StepTrace`` file: its ``train_step`` spans (the CPU side), the
    device activities each launched (a launch's runtime call lies inside the
    span on any thread, the autograd engine's included; its kernel shares the
    call's correlation id), and the card's busy and idle ms in each step's
    window, from its span's start to the end of the last kernel it launched
    (busy: the union of kernel, copy and set intervals in it). A trace
    without CUDA activity gives empty steps and no busy or idle ms."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == StepTrace.SPAN), key=lambda e: e["ts"])
    device = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                    key=lambda e: e["ts"])
    by_corr = {e["args"]["correlation"]: e for e in device if "correlation" in e.get("args", {})}
    calls = [e for e in events if e.get("cat", "").startswith("cuda_")  # cudaLaunchKernel, ...
             and e.get("args", {}).get("correlation") in by_corr]
    steps, busy, idle = [], [], []
    for sp in spans:
        t0, t1 = sp["ts"], sp["ts"] + sp["dur"]
        ks = [by_corr[c["args"]["correlation"]] for c in calls if t0 <= c["ts"] <= t1]
        steps.append(ks)
        if not ks:
            continue
        hi, b, end = max(k["ts"] + k["dur"] for k in ks), 0.0, t0
        for e in device:
            lo_e, hi_e = max(e["ts"], end), min(e["ts"] + e["dur"], hi)
            if hi_e > lo_e:
                b += hi_e - lo_e
                end = hi_e
        busy.append(b / 1e3)
        idle.append((hi - t0 - b) / 1e3)
    return {"spans": len(spans), "steps": steps, "busy_ms": busy, "idle_ms": idle}


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
        self.text_encoder = None  # a world run's text tower (module docstring)
        self.mesh, self._main = None, True  # set by train (_build_mesh)

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
        model read. The training model is left as it is. Under a mesh that
        shards or stacks parameters the copy is whole and unstacked (every
        rank of the mesh calls it: the shards are gathered)."""
        if self._split():
            model = self.mesh.unsharded(self.step.model, self.step.update.ema)
            model.disable_pipeline()
            return model.eval().requires_grad_(False)
        model = copy.deepcopy(self.step.model)
        with torch.no_grad():
            for p, e in zip(model.parameters(), self.step.update.ema):
                p.grad = None
                p.copy_(e)
        return model.eval().requires_grad_(False)

    def _split(self) -> bool:
        """Whether the run's parameters are sharded or stacked (tp, pp, ep)."""
        return self.mesh is not None and (bool(getattr(self.step.model, "_shards", {}))
                                          or self.mesh.shape["pp"] > 1)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
                for k in BATCH_KEYS if k in batch}

    def _build_mesh(self, batch: int):
        """The run's mesh from the ``mesh_*`` keys over torchrun's world
        (``parallel.distributed.ensure_initialized``; one process without
        it): dp = -1 fills the world, and shrinks, with a warning, until it
        divides ``batch``; the ranks it leaves out sit idle."""
        from ..parallel.distributed import ensure_initialized
        from ..parallel.mesh import build_mesh

        args = self.args
        _, world = ensure_initialized(self.device)
        tp, sp, pp, ep = (int(args.mesh_tp), int(args.mesh_sp), int(args.mesh_pp),
                          int(args.mesh_ep))
        dp = int(args.mesh_dp)
        if dp == -1:
            dp = world // (tp * sp * pp * ep)
        dp_want = dp
        while dp > 1 and batch % dp != 0:  # dp must divide the global batch
            dp -= 1
        if dp != dp_want:
            print(f"WARNING: batch={batch} is not divisible by dp={dp_want}; shrinking to "
                  f"dp={dp} — {(dp_want - dp) * tp * sp * pp * ep} rank(s) will sit IDLE. "
                  f"Pick batch as a multiple of dp to use every card.")
        n = dp * tp * sp * pp * ep
        if n > world:
            raise ValueError(f"a mesh of {n} ranks (dp={dp} tp={tp} sp={sp} pp={pp} ep={ep}) "
                             f"needs a world of {n} processes, this one has {world}: launch "
                             f"with torchrun --nproc_per_node {n}")
        return build_mesh(dp, tp, sp, pp, ep, ranks=range(n))

    def train(self) -> dict:
        from ..data.dataset import build_dataloader
        from ..parallel.mesh import shard_params
        from .validator import Validator

        args = self.args
        imgsz, batch, epochs = int(args.imgsz), int(args.batch), int(args.epochs)
        self.mesh = mesh = self._build_mesh(batch)
        if not mesh.member:
            print(f"rank {torch.distributed.get_rank()} is outside the {mesh} mesh: it sits "
                  f"idle for this run")
            self.metrics = {}
            return self.metrics
        self._main = mesh.group is None or torch.distributed.get_rank() == mesh.ranks[0]
        dp, dp_index = mesh.shape["dp"], mesh.index("dp")
        if args.resume and max(mesh.shape[a] for a in ("tp", "pp", "ep")) > 1:
            raise ValueError("resume under a mesh that shards or stacks parameters (mesh_tp, "
                             "mesh_pp or mesh_ep > 1) is not supported; its checkpoints hold "
                             "the whole model, without optimizer state")
        if self._main:
            self.save_dir.mkdir(parents=True, exist_ok=True)
        self.run_callbacks("on_pretrain_routine_start")
        task = self.model.task
        if task == "rtdetr" and args.val:
            from .validator import RTDETR_NO_VAL

            raise ValueError(RTDETR_NO_VAL)
        dev_aug = bool(args.device_augment)
        if dev_aug and task not in ("detect", "segment", "pose"):
            # the device path warps boxes, slot masks and keypoints, not OBB
            # corners, and has no classify crop or policy
            print(f"WARNING: device_augment covers detect, segment and pose (got {task!r}); "
                  f"augmenting on the host")
            dev_aug = False
        # with the augmentation on the device the host path is letterbox-only
        self.loader, self.data = build_dataloader(
            args.data, "train", batch=batch // dp, imgsz=imgsz,
            augment=False if dev_aug else None,
            hyp=dict(vars(args)), max_labels=int(args.max_labels), seed=int(args.seed),
            fraction=float(args.fraction), single_cls=bool(args.single_cls), cache=args.cache,
            workers=int(args.workers or 0), task=task, mask_ratio=int(args.mask_ratio),
            embed_fn=self.text_encoder, shard=(dp_index, dp))
        if hasattr(self.loader.ds, "uint8_images"):  # a classify batch ships float32
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
        if mesh.shape["pp"] > 1:
            n_piped = self.model.enable_pipeline(mesh, microbatches=int(args.pp_microbatches))
            if self._main:
                print(f"pipeline parallelism: {n_piped} ViL stage(s) over pp={mesh.shape['pp']}")
        mesh.broadcast_params(self.model)
        shard_params(mesh, self.model)
        nb = len(self.loader)
        accumulate = max(round(args.nbs / batch), 1)
        self.iterations = math.ceil(nb / accumulate) * epochs
        self.step = TrainStep(self.model, lr=args.lr0, momentum=args.momentum,
                              weight_decay=args.weight_decay, optimizer=args.optimizer,
                              iterations=self.iterations, accumulate=accumulate, amp=amp_of(args),
                              augment=vars(args) if dev_aug else None,
                              seed=int(args.seed) + dp_index,
                              gains=(float(args.box), float(args.cls), float(args.dfl)),
                              pose_gains=(float(args.pose), float(args.kobj)),
                              flip_idx=self.data.get("flip_idx") if task == "pose" else None,
                              mesh=mesh if mesh.device_mesh is not None else None)
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
        if self._main:
            print(f"training {self.model.task} model: {epochs} epochs x {nb} batches (batch "
                  f"{batch}, imgsz {imgsz}, optimizer {self.step.update.name}, lr0 {self.lr0}, "
                  f"accumulate {accumulate}, {'bf16 AMP' if self.step.amp else 'fp32'}, "
                  f"{self.device}" + (", device augmentation" if dev_aug else "")
                  + (f", multi-scale {ms_sizes}" if ms_sizes else "")
                  + (f", {mesh}" if mesh.size > 1 else "") + ")")
        self.run_callbacks("on_pretrain_routine_end")
        self.run_callbacks("on_train_start")

        step = self.start_epoch * nb
        t_start = time.time()
        means, val_metrics, lr = {"loss": float("nan")}, {}, 0.0
        self.trace = StepTrace(self.save_dir / "profile", 3 if args.profile and self._main else 0,
                               self.device)
        with self.trace:
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
                            db = ms_rescale(db, sz, imgsz, int(args.mask_ratio))
                    with self.trace.step():
                        total, aux = self.step(db, lr)
                    names = sorted([*aux, "loss"])  # the JAX trainer's (sorted) order
                    terms.append(torch.stack([total if k == "loss" else aux[k] for k in names]))
                    step += 1
                    self.run_callbacks("optimizer_step")
                    self.run_callbacks("on_before_zero_grad")
                    self.run_callbacks("on_train_batch_end")
                # the epoch's mean of each term
                means = dict(zip(names, torch.stack(terms).double().cpu().numpy().mean(0).tolist()))
                imps = nb * batch / (time.time() - t0)

                fitness, val_metrics = None, {}
                if args.val:
                    # the first rank validates over the whole set, as JAX's one
                    # process does, and shares the metrics so early stopping agrees;
                    # plots on the last epoch only, as the JAX trainer
                    ema = self.ema_model() if self._main or self._split() else None
                    if self._main:
                        val_metrics = Validator(ema, data=self.data, imgsz=imgsz,
                                                max_labels=int(args.max_labels),
                                                callbacks=self.callbacks, save_dir=self.save_dir,
                                                plots=bool(args.plots) and epoch == epochs - 1)()
                    val_metrics = mesh.broadcast_object(val_metrics)
                    fitness = val_metrics["fitness"]
                    if fitness >= self.best_fitness:
                        self.best_fitness = fitness
                        self._save("best", epoch)
                if self._main:
                    self._log_csv({"epoch": epoch,
                                   **{f"train/{k}": v for k, v in means.items()},
                                   **{f"metrics/{k}": v for k, v in val_metrics.items()},
                                   "lr": lr, "img_s": round(imps, 1)})
                self.run_callbacks("on_train_epoch_end")
                self.run_callbacks("on_fit_epoch_end")
                if self._main:
                    print(f"epoch {epoch + 1}/{epochs}: loss {means['loss']:.3f} ("
                          + " ".join(f"{k} {v:.3f}" for k, v in means.items() if k != "loss")
                          + f") {imps:.0f} img/s"
                          + (f" | fitness {fitness:.4f}" if fitness is not None else ""))
                self._save("last", epoch)
                if stopper(epoch, fitness):
                    print(f"early stopping at epoch {epoch} (best {stopper.best_epoch})")
                    break

        self.model = self.ema_model()
        self.metrics = val_metrics if args.val else {"train_loss": means["loss"]}
        self.run_callbacks("on_params_update")
        self.run_callbacks("on_train_end")
        if self._main:
            print(f"done in {(time.time() - t_start) / 3600:.2f} h; results -> {self.save_dir}")
        self.run_callbacks("teardown")
        return self.metrics

    def _save(self, name: str, epoch: int) -> None:
        """The first rank writes; under a mesh that shards or stacks
        parameters every rank first joins in gathering the whole live and
        EMA models, which the checkpoint then holds (unstacked, without
        optimizer state)."""
        if not self.args.save:
            return
        if self._split():
            live = self.mesh.unsharded(self.step.model)
            live.disable_pipeline()
            ema = self.ema_model()
            if self._main:
                self.run_callbacks("on_model_save")
                save_checkpoint(self.save_dir / f"{name}.pt", live, epoch=epoch,
                                best_fitness=self.best_fitness, ema=ema)
            return
        if self._main:
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
