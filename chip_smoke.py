"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``xlstm_yolo_torch/csrc``,
holds each against its plain PyTorch version at the shapes the main path
gives it, then drives the main path — ViL-YOLO-n detection inference,
uint8 540x810 frames -> letterbox -> forward -> decode -> NMS at 640 px —
through ``xlstm_yolo_torch.engine.predictor.Predictor`` on seeded random
weights, and checks what comes out against the same model with the plain
versions forced in. Every phase prints one JSON line; then come the
kernels line, the card's name and power limit as nvidia-smi gives them, and
last ``{"ok": true, "device": {...}}``, printed only when every phase passed. Exits
non-zero, printing no result, when there is no GPU or any phase fails.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 on the CUDA
# cores and HBM3 bandwidth — the kernel is fp32 without tensor cores.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOL_REL = 1e-3
BATCH, SRC_HW, IMGSZ = 8, (540, 810), 640
# ViL-YOLO-n stages at 640 px: (name, S, DIM, INNER, NH)
STAGES = [("P3", 6400, 64, 128, 2), ("P4", 1600, 128, 256, 4), ("P5", 400, 256, 512, 8)]
CHUNK = 128  # the YAML's chunk size, read by the plain version only


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def layer_args(B, S, DIM, INNER, NH, seed, device):
    """Seeded fp32 arguments of the ViL layer function (JAX layouts)."""
    import torch

    rng = np.random.default_rng(seed)
    DH = INNER // NH
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    return [mk(B, S, DIM), mk(B, S, INNER), 1.0 + mk(DIM) * 0.2,
            mk(DIM, 2 * INNER) * DIM ** -0.5, mk(2 * INNER) * 0.1,
            mk(NH, DH, DH) * 0.3, mk(INNER) * 0.1, mk(NH, DH, DH) * 0.3, mk(INNER) * 0.1,
            mk(NH, DH, DH) * 0.3, mk(INNER) * 0.1,
            mk(3 * INNER, NH) * 0.05, torch.full((NH,), -8.0, device=device),
            mk(3 * INNER, NH) * 0.05, torch.full((NH,), 4.0, device=device),
            1.0 + mk(INNER) * 0.2, mk(INNER) * 0.1, 1.0 + mk(INNER) * 0.1,
            mk(INNER, DIM) * INNER ** -0.5, mk(DIM) * 0.1]


def layer_bound(B, S, DIM, INNER, NH, n_weight_floats):
    """Least time for one layer call: the larger of its FLOPs over the fp32
    peak and the bytes of x, conv_act, out and the weights over the HBM rate.
    FLOPs count the work the CUDA function does per token: proj_up (both
    halves), headwise q/k/v, the two gate dots, per head the causal half of
    the intra-chunk q k^T and E v products over the kernel's chunk length
    plus the inter-chunk q C and chunk-summary k v^T products, and
    proj_down. Elementwise work (norms, exp, gating) is left out."""
    from xlstm_yolo_torch.kernels.vil_layer import KERNEL_CS

    dh = INNER // NH
    macs = (2 * INNER * DIM + 3 * INNER * dh + 6 * INNER * NH
            + NH * ((KERNEL_CS + 1) * dh + 2 * dh * dh) + INNER * DIM)
    flops = 2 * B * S * macs
    nbytes = 4 * (B * S * (2 * DIM + INNER) + n_weight_floats)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is False: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not available"
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi_line, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi_line, name


def phase_build():
    from xlstm_yolo_torch.kernels._build import CSRC_DIR, build_library

    t0 = time.perf_counter()
    sources = sorted(p.name for p in CSRC_DIR.glob("*.cu"))
    libs = [build_library(src) for src in sources]
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in libs for ln in lib.with_suffix(".log").read_text().splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "sources": sources, "seconds": seconds, "ptxas": ptxas})


def compare(got, want):
    """(max abs error, max relative error, finite) of a kernel's output."""
    import torch

    abs_err = (got - want).abs().max().item()
    return abs_err, abs_err / want.abs().max().item(), bool(torch.isfinite(got).all())


def phase_kernel_parity():
    """vil_layer_fwd vs vil_layer_ref at the stage shapes, at the main path's
    batch (the arguments that are then timed) and at batch 2."""
    import torch

    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd, vil_layer_ref

    dev = torch.device("cuda")
    worst_rel, worst_abs = 0.0, 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = set()
    for name, S, DIM, INNER, NH in STAGES:
        errs = {}
        for B in (BATCH, 2):
            args = layer_args(B, S, DIM, INNER, NH, seed=S + B, device=dev)
            errs[B] = compare(vil_layer_fwd(*args, NH, chunk_size=CHUNK),
                              vil_layer_ref(*args, NH, chunk_size=CHUNK))
            if B == BATCH:
                timed = args
        ok = all(fin and rel <= TOL_REL for _, rel, fin in errs.values())
        abs_err = max(e[0] for e in errs.values())
        rel = max(e[1] for e in errs.values())
        args = timed
        ms = cuda_time_ms(lambda: vil_layer_fwd(*args, NH, chunk_size=CHUNK), iters=20)
        plain_ms = cuda_time_ms(lambda: vil_layer_ref(*args, NH, chunk_size=CHUNK), iters=5)
        n_w = sum(a.numel() for a in args[2:])
        bound_ms, by = layer_bound(BATCH, S, DIM, INNER, NH, n_w)
        emit({"phase": "kernel_parity", "kernel": "vil_layer_fwd", "stage": name,
              "shape": [BATCH, S, DIM, INNER, NH],
              "maxrelerr_by_batch": {str(b): e[1] for b, e in errs.items()},
              "max_abs_err": abs_err, "maxrelerr": rel, "tol": TOL_REL, "ok": ok,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by})
        if not ok:
            raise PhaseError(f"vil_layer_fwd disagrees with vil_layer_ref at {name}: "
                             f"maxrelerr {rel}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["bound_ms"] += bound_ms
        bound_by.add(by)
    return {"maxrelerr": worst_rel, "max_abs_err": worst_abs, **totals,
            "bound_by": bound_by.pop() if len(bound_by) == 1 else "operations"}


def build_main_model(device):
    """ViL-YOLO-n on ``device``: seeded init with the JAX scheme, then seeded
    gate kernels (zero at init) and zero class biases, so the mLSTM gates
    vary along the sequence and detections clear the confidence threshold;
    conv+BN folded."""
    import torch

    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn
    from xlstm_yolo_torch.nn.tasks import TaskModel
    from xlstm_yolo_torch.nn.vil import MatrixLSTMCell

    model = TaskModel("vil_yolon.yaml", device=device, seed=0)
    g = torch.Generator(device="cpu").manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MatrixLSTMCell):
                for lin in (m.igate, m.fgate):
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
        det = getattr(model, f"l{model.parsed.head_index}")
        for i in range(det.nl):
            getattr(det, f"cv3_{i}_2").bias.zero_()
    return fuse_conv_bn(model)


def phase_main_path():
    import torch

    import xlstm_yolo_torch.nn.vil as vil_mod
    from xlstm_yolo_torch.engine.predictor import Predictor
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd, vil_layer_ref
    from xlstm_yolo_torch.nn.heads import decode_detections

    model = build_main_model("cuda")
    pred = Predictor(model, imgsz=IMGSZ)
    frames = np.random.default_rng(0).integers(0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)
    raw = torch.from_numpy(frames).cuda()

    vil_layer_fwd.launches = 0
    dets, valid, cands, meta = pred(raw)
    torch.cuda.synchronize()
    launches = vil_layer_fwd.launches
    with mock.patch.object(vil_mod, "vil_layer_fwd", vil_layer_ref), torch.inference_mode():
        x, _ = pred.preprocess(raw)
        ref = model.predictions(x)
    torch.cuda.synchronize()

    n_cand = sum((IMGSZ // s) ** 2 for s in model.strides)
    shapes_ok = (tuple(cands.shape) == (BATCH, n_cand, 4 + model.nc)
                 and tuple(dets.shape) == (BATCH, 300, 6) and tuple(valid.shape) == (BATCH, 300))
    finite = bool(torch.isfinite(cands).all() and torch.isfinite(dets).all())
    box_rel = ((cands[..., :4] - ref[..., :4]).abs().max() / ref[..., :4].abs().max()).item()
    score_abs = (cands[..., 4:] - ref[..., 4:]).abs().max().item()
    n_valid = int(valid.sum())

    with torch.inference_mode():
        times = {"letterbox": 0.0, "forward": 0.0, "decode_nms": 0.0}
        iters = 10
        for it in range(iters + 2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            x, _ = pred.preprocess(raw)
            ev[1].record()
            raw_maps = model(x.permute(0, 3, 1, 2))
            ev[2].record()
            c = decode_detections(raw_maps, model.strides, model.nc, model.reg_max)
            pred.postprocess(c)
            ev[3].record()
            torch.cuda.synchronize()
            if it >= 2:  # warm-up
                for k, (a, b) in zip(times, zip(ev[:3], ev[1:])):
                    times[k] += a.elapsed_time(b) / iters
    total_ms = sum(times.values())
    ok = shapes_ok and finite and launches == len(STAGES) and box_rel <= TOL_REL \
        and score_abs <= TOL_REL and n_valid > 0
    emit({"phase": "main_path", "model": "vil_yolon.yaml", "params_after_fuse": model.num_params(),
          "batch": BATCH, "src_hw": list(SRC_HW), "imgsz": IMGSZ, "launches": launches,
          "expected_launches": len(STAGES), "shapes_ok": shapes_ok, "finite": finite,
          "cands_box_maxrelerr": box_rel, "cands_score_max_abs_err": score_abs,
          "valid_dets": n_valid, "ms": times, "total_ms": total_ms,
          "img_per_s": BATCH / total_ms * 1e3, "ok": ok})
    if not ok:
        raise PhaseError("main path check failed")
    return launches


def main() -> int:
    phase = "device"
    try:
        smi_line, name = phase_device()
        phase = "build"
        phase_build()
        phase = "kernel_parity"
        k = phase_kernel_parity()
        phase = "main_path"
        launches = phase_main_path()
    except Exception as e:  # report the failed phase, print no result
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    import torch

    emit({"kernels": [{
        "name": "vil_layer_fwd", "route": "cuda", "source": "xlstm_yolo_torch/csrc/vil_layer.cu",
        "replaces": "xlstm_yolo_tpu/kernels/mlstm_pallas.py:1142 (_kernel_vil_layer)",
        "launches": launches, "max_abs_err": k["max_abs_err"], "maxrelerr": k["maxrelerr"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
