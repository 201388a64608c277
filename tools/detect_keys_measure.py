"""What the detect task's keys cost on one NVIDIA GPU (PyTorch port).

    python3 tools/detect_keys_measure.py                  # every part
    python3 tools/detect_keys_measure.py --part rect_val  # one part

Three parts, each variant in a fresh process (a profiler session, the
loader's threads and the allocator's state would otherwise carry over from
one variant to the next); one JSON line each, then the card's name and
power limit:

- ``after_profile``: does a ``torch.profiler`` session slow what the process
  does after it? Before and after three AMP train steps of ViL-YOLO-n (640
  px, batch 8, one fixed batch on the card), K3 (``vil_layer_fwd``) at P5
  14 x 20, batch 8, is timed by CUDA events and by the host's clock per
  call, and the same AMP step by CUDA events. The three steps run untraced
  (``control``), inside the trainer's ``StepTrace`` (``step_trace``), or
  inside ``StepTrace`` with the CPU activity only (``cpu_only``).
- ``trainer_steps``: ``Trainer.train`` of ViL-YOLO-n over one epoch of 96
  PNGs (32 each of 640 x 360, 480 x 480, 360 x 640) at batch 8, 640 px, AMP,
  no validation: each ``TrainStep`` call's ms by CUDA events (12 steps),
  with ``profile`` on and off, at ``mosaic_n`` 9 and 4, and K3 as above
  before and after the run. Steps 1-3 are the traced ones; steps 4-12 and
  K3 after the run show what a trace leaves behind.
- ``rect_val``: ``Validator(rect=True)`` against ``Validator(rect=False)``
  on 288 PNGs (96 of each shape), labelled with the detector's own jittered
  detections (``chip_smoke.shaped_detector``, ``write_own_labels``), in
  turns S R R S S R R S: img/s of each pass, with the pixels each way.

Needs a GPU; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

SHAPES = [("wide", (640, 360)), ("square", (480, 480)), ("tall", (360, 640))]
VARIANTS = {"after_profile": ("control", "step_trace", "cpu_only"),
            "trainer_steps": ("mosaic9_profile", "mosaic9", "mosaic4_profile", "mosaic4"),
            "rect_val": ("turns",)}
K3_P5 = ("P5_14x20", 14 * 20, 256, 512, 8)


def make_sets(root: str, n_train: int, n_val: int) -> dict:
    """SHAPES' PNG sets under ``root``, joined in one dataset dict."""
    from xlstm_yolo_torch.data.synthetic import CLASSES, make_synthetic_dataset

    for i, (name, (w, h)) in enumerate(SHAPES):
        make_synthetic_dataset(f"{root}/{name}", n_train=n_train, n_val=n_val, width=w,
                               height=h, seed=i)
    return {"path": root, "names": dict(enumerate(CLASSES)),
            "train": [f"{n}/images/train" for n, _ in SHAPES],
            "val": [f"{n}/images/val" for n, _ in SHAPES]}


def k3_reading(args, nh) -> dict:
    """K3's device ms (events, 50 calls) and host us per call (200 calls
    launched back to back, then one synchronize)."""
    import torch

    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd

    with torch.inference_mode():
        ms = cs.cuda_time_ms(lambda: vil_layer_fwd(*args, nh), iters=50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            vil_layer_fwd(*args, nh)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    return {"k3_ms": ms, "k3_host_us_per_call": host_us}


def step_ms(step, batch, n: int) -> list:
    import torch

    out = []
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step(batch, 0.01)
        ev[1].record()
        torch.cuda.synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
    return out


def after_profile(variant: str, tmp: str) -> dict:
    import torch

    from xlstm_yolo_torch.engine.trainer import StepTrace, TrainStep

    _, S, DIM, INNER, NH = K3_P5
    args = cs.layer_args(cs.BATCH, S, DIM, INNER, NH, seed=S + 31, device="cuda")
    batch = cs.train_batch("cuda")
    step = TrainStep(cs.build_main_model("cuda", train=True), amp=True, accumulate=2)
    step_ms(step, batch, 3)  # warm-up
    before = {**k3_reading(args, NH), "step_ms": step_ms(step, batch, 5)}
    trace = StepTrace(Path(tmp) / "profile", 3 if variant != "control" else 0,
                      torch.device("cpu") if variant == "cpu_only" else torch.device("cuda"))
    with trace:
        for _ in range(3):
            with trace.step():
                step(batch, 0.01)
    torch.cuda.synchronize()
    after = {**k3_reading(args, NH), "step_ms": step_ms(step, batch, 5)}
    return {"before": before, "after": after,
            "k3_ms_after_over_before": after["k3_ms"] / before["k3_ms"],
            "k3_host_after_over_before": after["k3_host_us_per_call"]
            / before["k3_host_us_per_call"],
            "step_median_after_over_before": statistics.median(after["step_ms"])
            / statistics.median(before["step_ms"])}


def trainer_steps(variant: str, tmp: str, data: str) -> dict:
    import json

    import torch

    from xlstm_yolo_torch import YOLO

    data = json.loads(Path(data).read_text())
    _, S, DIM, INNER, NH = K3_P5
    args = cs.layer_args(cs.BATCH, S, DIM, INNER, NH, seed=S + 31, device="cuda")
    before = k3_reading(args, NH)
    steps = []
    with cs.recording_steps(steps):
        YOLO("vil_yolon.yaml").train(
            data=data, epochs=1, batch=cs.BATCH, imgsz=cs.IMGSZ, seed=0, close_mosaic=0,
            val=False, plots=False, profile=variant.endswith("_profile"),
            mosaic_n=9 if variant.startswith("mosaic9") else 4, project=f"{tmp}/runs",
            name=variant)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for _, _, (a, b), _ in steps]
    after = k3_reading(args, NH)
    return {"k3_before": before, "k3_after": after, "step_ms": ms, "steps_1_3_ms": ms[:3],
            "steps_4_on_median_ms": statistics.median(ms[3:]) if len(ms) > 3 else None}


def rect_val(tmp: str) -> dict:
    import torch

    from xlstm_yolo_torch.data.dataset import build_dataloader
    from xlstm_yolo_torch.engine.validator import Validator

    data = make_sets(f"{tmp}/ds", n_train=1, n_val=96)
    shaped = cs.shaped_detector("cuda")
    labels = cs.write_own_labels(shaped, data, rect=True)
    img_s = {"square": [], "rect": []}
    for kind in ("square", "rect", "rect", "square") * 2:
        img_s[kind].append(Validator(shaped, imgsz=cs.IMGSZ, batch=cs.BATCH, max_labels=320,
                                     rect=kind == "rect")(data)["img_s"])
    torch.cuda.synchronize()
    loader = build_dataloader(data, "val", batch=cs.BATCH, imgsz=cs.IMGSZ, rect=True)[0]
    rect_px = sum(len(idx) * h * w for idx, (h, w) in loader.rect_batches())
    n = len(loader.ds)
    med = {k: statistics.median(v) for k, v in img_s.items()}
    return {"images": n, "own_labels": labels, "rect_img_s": img_s["rect"],
            "square_img_s": img_s["square"], "median_img_s": med,
            "spread_img_s": {k: [min(v), max(v)] for k, v in img_s.items()},
            "rect_over_square_median": med["rect"] / med["square"],
            "rect_pixels_over_square": rect_px / (n * cs.IMGSZ * cs.IMGSZ),
            "buckets": sorted({tuple(hw) for _, hw in loader.rect_batches()})}


def child(part: str, variant: str, data: str | None) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs its phases
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        if part == "after_profile":
            out = after_profile(variant, tmp)
        elif part == "trainer_steps":
            out = trainer_steps(variant, tmp, data)
        else:
            out = rect_val(tmp)
    cs.emit({"part": part, "variant": variant, **out, "seconds": time.perf_counter() - t0})


def main() -> int:
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=list(VARIANTS))
    ap.add_argument("--variant")
    ap.add_argument("--data", help="trainer_steps: the dataset dict's JSON file")
    a = ap.parse_args()
    if a.variant:  # one variant, in this process
        child(a.part, a.variant, a.data)
        return 0
    smi_line, _ = cs.phase_device()
    cs.phase_build()
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        data_file = Path(tmp) / "data.json"
        for part in [a.part] if a.part else list(VARIANTS):
            if part == "trainer_steps" and not data_file.exists():
                data_file.write_text(json.dumps(make_sets(f"{tmp}/ds", n_train=32, n_val=1)))
            for variant in VARIANTS[part]:
                proc = subprocess.run([sys.executable, __file__, "--part", part, "--variant",
                                       variant, "--data", str(data_file)], timeout=600)
                rc = rc or proc.returncode
    print(smi_line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
