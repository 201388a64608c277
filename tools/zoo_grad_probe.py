"""Where a detector's fp32 train-step gradients part from fp64, and which
discrete choice moves them: the TAL assignment or a max pool's argmax.

    python3 tools/zoo_grad_probe.py [MODEL ...] [--devices cuda,cpu] [--imgsz N]
        [--nudges K] [--tensor NAME ...]

MODEL is a label of ``chip_smoke.ZOO`` (default: yolov3-tiny, yolov9t,
yolov9e), of ``chip_smoke.TASK_FLAGSHIPS`` (yolo11n-seg, -pose, -obb) or of
``chip_smoke.RTDETR_MODELS`` (rtdetr-l, ...). For each model, built as
``chip_smoke.py``'s ``detect_zoo_path``, ``tasks_path`` or ``rtdetr_path``
builds it, one train step (``chip_smoke.zoo_step``) on
``chip_smoke.train_batch``'s images (a task flagship: ``task_batch`` at its
own size; an RT-DETR model: ``rtdetr_batch`` at ``RTDETR_CPU_IMGSZ``, its
denoising queries drawn once) at batch ``chip_smoke.YOLO11_CPU_BATCH``:

* ``fp64``: the model, its inputs, the BatchNorms, the loss and the
  assigner in fp64, on each device (the reference is the first device's);
* ``fp32``: the step as the trainer takes it, on each device, with its own
  choices;
* ``fp32_shared``: the same step with the reference's discrete choices
  (``chip_smoke.SharedChoices``: its TAL assignment, every max pool's
  argmax, RT-DETR's selections, sampling cells and matches) in place of
  its own;
* ``fp64_nudged``: the reference step, its choices shared, on weights each
  moved by a relative N(0, 1) x 2^-24 (fp32's unit roundoff), on the first
  device: how far the exact gradient itself moves at fp32's resolution
  (``--nudges K``: K such steps, each on its own draw of the moves);
* ``fp32_nudged``: ``fp32_shared`` on the same moved weights (cast to
  fp32: some move one ulp), also held to ``fp32_shared``
  (``vs_fp32_shared``): how far fp32 steps that differ only below fp32's
  resolution stand apart.

Prints one JSON line per model: for every step, the worst gradient tensor
against the reference (each tensor over its own max, as
``chip_smoke.grad_errors`` holds it), ``chip_smoke.grad_spread``'s largest
error of any entry over the model's largest gradient and worst relative L2
error, the loss's relative error, how many anchors' assignment and pooled
outputs' argmax differ from the reference's, and each ``--tensor``'s error
over its own max (over the model's largest gradient, where its own is below
1e-6 of that); the same measures of the first device against the second for
each kind of step. Then the card's name and power limit. ``--imgsz`` below
640 crops the images and scales the boxes of a ``ZOO`` model (a CPU-sized
run); a task flagship's batch is drawn at ``--imgsz`` when it is given.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

DEFAULT = ("yolov3-tiny", "yolov9t", "yolov9e")


def batch_at(imgsz: int):
    """``chip_smoke.train_batch`` at YOLO11_CPU_BATCH on the CPU, cropped to
    ``imgsz`` with its boxes scaled to match."""
    b = cs.train_batch("cpu", batch=cs.YOLO11_CPU_BATCH)
    if imgsz != cs.IMGSZ:
        cb = b["cls_boxes"].clone()
        cb[..., 1:] *= imgsz / cs.IMGSZ
        b = {**b, "img": b["img"][:, :imgsz, :imgsz].contiguous(), "cls_boxes": cb}
    return b


def model_and_batch(label: str, imgsz: int | None):
    """(the model on the CPU, its batch, the batch's image size) of a
    ``ZOO``, ``TASK_FLAGSHIPS`` or ``RTDETR_MODELS`` label."""
    from xlstm_yolo_torch.nn.tasks import TaskModel

    rtdetr = next((t for t in cs.RTDETR_MODELS if t[0] == label), None)
    if rtdetr is not None:
        _, cfg, scale, _ = rtdetr
        model = TaskModel(cfg, scale=scale, device="cpu", seed=0)
        size = imgsz or cs.RTDETR_CPU_IMGSZ
        return model, cs.rtdetr_batch(model, "cpu", cs.YOLO11_CPU_BATCH, size), size
    task = next((t for t in cs.TASK_FLAGSHIPS if t[0] == label), None)
    if task is not None:
        _, cfg, nc, kpt, size, _, _ = task
        model = cs.task_model(cfg, nc=nc, kpt_shape=kpt, device="cpu")
        size = imgsz or size
        return model, cs.task_batch(model, "cpu", cs.YOLO11_CPU_BATCH, size), size
    _, cfg, scale, _, _ = next(z for z in cs.ZOO if z[0] == label)
    size = imgsz or cs.IMGSZ
    return TaskModel(cfg, scale=scale, device="cpu", seed=0), batch_at(size), size


def probe(label: str, devices, imgsz: int | None, nudges: int = 1, tensors=()) -> dict:
    import torch

    model, batch, imgsz = model_and_batch(label, imgsz)
    runs = {}
    for dev in devices:
        ch = cs.SharedChoices()
        runs[f"fp64_{dev}"] = (*cs.zoo_step(model, dev, torch.float64, batch, ch), ch)
    ref_loss, ref, ref_choices = runs[f"fp64_{devices[0]}"]
    for dev in devices:
        for kind, ch in (("fp32", cs.SharedChoices()),
                         ("fp32_shared", cs.SharedChoices(replay=ref_choices))):
            runs[f"{kind}_{dev}"] = (*cs.zoo_step(model, dev, torch.float32, batch, ch), ch)
    gen = torch.Generator().manual_seed(7)
    for k in range(nudges):
        nudged = copy.deepcopy(model).double()
        with torch.no_grad():
            for prm in nudged.parameters():
                prm.mul_(1 + 2.0 ** -24 * torch.randn(prm.shape, generator=gen,
                                                      dtype=torch.float64))
        for kind, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
            ch = cs.SharedChoices(replay=ref_choices)
            name = f"{kind}_nudged_{devices[0]}" + (f"_{k}" if nudges > 1 else "")
            runs[name] = (*cs.zoo_step(nudged, devices[0], dtype, batch, ch), ch)
    out = {"model": label, "imgsz": imgsz, "batch": cs.YOLO11_CPU_BATCH, "ref": f"fp64_{devices[0]}",
           "loss_ref": ref_loss, "runs": {}}
    fp32_shared = runs[f"fp32_shared_{devices[0]}"][1]
    for name, (loss, grads, ch) in runs.items():
        rel, worst, _, gmax = cs.grad_errors(grads, ref)
        out["runs"][name] = {"grad_maxrelerr_vs_ref": rel, "grad_worst": worst,
                             **cs.grad_spread(grads, ref),
                             "loss_relerr_vs_ref": abs(loss - ref_loss) / abs(ref_loss),
                             **{f"relerr_{t}": (grads[t] - ref[t]).abs().max().item()
                                / max(ref[t].abs().max().item(), 1e-6 * gmax) for t in tensors},
                             **ch.flips(ref_choices)}
        if name.startswith("fp32_nudged"):
            out["runs"][name]["vs_fp32_shared"] = cs.grad_spread(grads, fp32_shared)
    if len(devices) == 2:
        for kind in ("fp32", "fp32_shared", "fp64"):
            a, b = runs[f"{kind}_{devices[0]}"][1], runs[f"{kind}_{devices[1]}"][1]
            rel, worst, _, _ = cs.grad_errors(a, b)
            out[f"{kind}_{devices[0]}_vs_{devices[1]}"] = {"grad_maxrelerr": rel, "grad_worst": worst,
                                                           **cs.grad_spread(a, b)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("models", nargs="*", default=list(DEFAULT))
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--imgsz", type=int, default=None)
    ap.add_argument("--nudges", type=int, default=1)
    ap.add_argument("--tensor", action="append", default=[])
    args = ap.parse_args()
    import torch

    torch.manual_seed(0)
    devices = args.devices.split(",")
    if "cuda" in devices:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for label in args.models:
        print(json.dumps(probe(label, devices, args.imgsz, args.nudges, args.tensor)),
              flush=True)
    if "cuda" in devices:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
