"""Where a detector's fp32 train-step gradients part from fp64, and which
discrete choice moves them: the TAL assignment or a max pool's argmax.

    python3 tools/zoo_grad_probe.py [MODEL ...] [--devices cuda,cpu] [--imgsz N]

MODEL is a label of ``chip_smoke.ZOO`` (default: yolov3-tiny, yolov9t,
yolov9e). For each model, built as ``chip_smoke.py``'s ``detect_zoo_path``
builds it, one train step (``chip_smoke.zoo_step``) on
``chip_smoke.train_batch``'s images at batch ``chip_smoke.YOLO11_CPU_BATCH``:

* ``fp64``: the model, its inputs, the BatchNorms, the loss and the
  assigner in fp64, on each device (the reference is the first device's);
* ``fp32``: the step as the trainer takes it, on each device, with its own
  choices;
* ``fp32_shared``: the same step with the reference's discrete choices
  (``chip_smoke.SharedChoices``: its TAL assignment and every max pool's
  argmax) in place of its own;
* ``fp64_nudged``: the reference step, its choices shared, on weights each
  moved by a relative N(0, 1) x 2^-24 (fp32's unit roundoff), on the first
  device: how far the exact gradient itself moves at fp32's resolution.

Prints one JSON line per model: for every step, the worst gradient tensor
against the reference (each tensor over its own max, as
``chip_smoke.grad_errors`` holds it), the loss's relative error, and how
many anchors' assignment and pooled outputs' argmax differ from the
reference's, and the largest error of any entry over the model's largest
gradient; the worst tensor of the first device against the second for
each kind of step. Then the card's name and power limit. ``--imgsz`` below
640 crops the images and scales the boxes (a CPU-sized run).
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


def probe(label: str, devices, imgsz: int) -> dict:
    import torch

    from xlstm_yolo_torch.nn.tasks import TaskModel

    _, cfg, scale, _, _ = next(z for z in cs.ZOO if z[0] == label)
    model = TaskModel(cfg, scale=scale, device="cpu", seed=0)
    batch = batch_at(imgsz)
    runs = {}
    for dev in devices:
        ch = cs.SharedChoices()
        runs[f"fp64_{dev}"] = (*cs.zoo_step(model, dev, torch.float64, batch, ch), ch)
    ref_loss, ref, ref_choices = runs[f"fp64_{devices[0]}"]
    for dev in devices:
        for kind, ch in (("fp32", cs.SharedChoices()),
                         ("fp32_shared", cs.SharedChoices(replay=ref_choices))):
            runs[f"{kind}_{dev}"] = (*cs.zoo_step(model, dev, torch.float32, batch, ch), ch)
    nudged = copy.deepcopy(model).double()
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for prm in nudged.parameters():
            prm.mul_(1 + 2.0 ** -24 * torch.randn(prm.shape, generator=gen, dtype=torch.float64))
    ch = cs.SharedChoices(replay=ref_choices)
    runs[f"fp64_nudged_{devices[0]}"] = (*cs.zoo_step(nudged, devices[0], torch.float64, batch, ch),
                                         ch)
    out = {"model": label, "imgsz": imgsz, "batch": cs.YOLO11_CPU_BATCH, "ref": f"fp64_{devices[0]}",
           "loss_ref": ref_loss, "runs": {}}
    for name, (loss, grads, ch) in runs.items():
        rel, worst, _, gmax = cs.grad_errors(grads, ref)
        absmax = max((grads[n] - g).abs().max().item() for n, g in ref.items())
        out["runs"][name] = {"grad_maxrelerr_vs_ref": rel, "grad_worst": worst,
                             "grad_max_abs_err_over_grad_max": absmax / gmax,
                             "loss_relerr_vs_ref": abs(loss - ref_loss) / abs(ref_loss),
                             **ch.flips(ref_choices)}
    if len(devices) == 2:
        for kind in ("fp32", "fp32_shared", "fp64"):
            rel, worst, _, _ = cs.grad_errors(runs[f"{kind}_{devices[0]}"][1],
                                              runs[f"{kind}_{devices[1]}"][1])
            out[f"{kind}_{devices[0]}_vs_{devices[1]}"] = {"grad_maxrelerr": rel, "grad_worst": worst}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("models", nargs="*", default=list(DEFAULT))
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--imgsz", type=int, default=cs.IMGSZ)
    args = ap.parse_args()
    import torch

    torch.manual_seed(0)
    devices = args.devices.split(",")
    if "cuda" in devices:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for label in args.models:
        print(json.dumps(probe(label, devices, args.imgsz)), flush=True)
    if "cuda" in devices:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
