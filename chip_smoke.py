"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``xlstm_yolo_torch/csrc``
(one nvcc per source, all started together), holds each against its plain
PyTorch version at the shapes the main path gives it, then drives both ends
of the main path on seeded random ViL-YOLO-n weights at 640 px:

* inference — uint8 540x810 frames -> letterbox -> forward -> decode -> NMS
  through ``xlstm_yolo_torch.engine.predictor.Predictor``, checked against
  the same model with the plain versions forced in;
* the train step — uint8 images and padded labels -> train-mode forward ->
  v8 loss -> backward -> clip, decay, nesterov SGD, EMA through
  ``xlstm_yolo_torch.engine.trainer.TrainStep``; the loss and every
  parameter gradient are checked against the same step with the plain
  versions forced in, then the step is timed by stage.

Every phase prints one JSON line; then come the
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
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
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
N_LABELS = 32  # padded label slots of a train batch, as the JAX bench_train.py
TRAIN_TIMED, TRAIN_WARMUP = 3, 1


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
    with ThreadPoolExecutor(len(sources)) as pool:  # nvcc runs in subprocesses
        libs = list(pool.map(build_library, sources))
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in libs for ln in lib.with_suffix(".log").read_text().splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "sources": sources, "seconds": seconds, "ptxas": ptxas})


def compare(got, want):
    """(max abs error, max relative error, finite) of a kernel's output."""
    import torch

    abs_err = (got - want).abs().max().item()
    return abs_err, abs_err / want.abs().max().item(), bool(torch.isfinite(got).all())


def bwd_bound(B, S, INNER, NH):
    """Least time for one chunkwise-backward call. FLOPs count the
    multiply-adds the CUDA function does per chunk and head of the
    (padded) sequence: six products over the causal half of the chunk
    (q k^T, E v, E^T dA, dA v^T, dqk k, dqk^T q: 3 CS (CS+1) DH) and five
    DH x DH products per token (q C, dA C^T, the dC_attn sum, and the
    carry's dv and dk terms: 5 CS DH^2), times 2 FLOPs; bytes count q, k,
    v, dh, the gates and the carry states read once and dq, dk, dv, di, df
    written once. Elementwise work (exp, norms, scans) is left out."""
    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS as CS

    dh = INNER // NH
    ns = -(-S // CS)
    macs = B * NH * ns * (3 * CS * (CS + 1) * dh + 5 * CS * dh * dh)
    nbytes = 4 * (7 * B * S * INNER + 4 * B * NH * S + B * NH * ns * (dh * dh + dh + 3))
    t_ops, t_bytes = 2 * macs / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_parity(kernel, make_case, run, plain, bound):
    """``run`` (the kernel's wrapper) vs ``plain`` (its plain version) at
    the stage shapes, on ``make_case(B, stage)`` at the main path's batch
    (the case that is then timed) and at batch 2; both return a tuple of
    outputs, each held to TOL_REL of its own max. Emits one line per stage
    and returns the totals over the stages for the kernels line."""
    worst_rel, worst_abs = 0.0, 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by = set()
    for stage in STAGES:
        name, S, DIM, INNER, NH = stage
        errs = {}
        for B in (BATCH, 2):
            case = make_case(B, stage)
            per = [compare(g, w) for g, w in zip(run(case, NH), plain(case, NH))]
            errs[B] = (max(e[0] for e in per), max(e[1] for e in per), all(e[2] for e in per))
            if B == BATCH:
                timed = case
        ok = all(fin and rel <= TOL_REL for _, rel, fin in errs.values())
        abs_err = max(e[0] for e in errs.values())
        rel = max(e[1] for e in errs.values())
        ms = cuda_time_ms(lambda: run(timed, NH), iters=20)
        plain_ms = cuda_time_ms(lambda: plain(timed, NH), iters=5)
        bound_ms, by = bound(timed, stage)
        emit({"phase": "kernel_parity", "kernel": kernel, "stage": name,
              "shape": [BATCH, S, DIM, INNER, NH],
              "maxrelerr_by_batch": {str(b): e[1] for b, e in errs.items()},
              "max_abs_err": abs_err, "maxrelerr": rel, "tol": TOL_REL, "ok": ok,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by})
        if not ok:
            raise PhaseError(f"{kernel} disagrees with its plain version at {name}: "
                             f"maxrelerr {rel}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["bound_ms"] += bound_ms
        bound_by.add(by)
    return {"maxrelerr": worst_rel, "max_abs_err": worst_abs, **totals,
            "bound_by": bound_by.pop() if len(bound_by) == 1 else "operations"}


def phase_kernel_parity():
    """K3 (vil_layer_fwd vs vil_layer_ref) on seeded layer arguments, then
    K2 (mlstm_chunkwise_bwd vs mlstm_chunkwise_bwd_plain) on the
    activations and carry states the layer kernel's forward leaves for
    seeded layer arguments, with a seeded output gradient."""
    import torch

    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd, mlstm_chunkwise_bwd_plain
    from xlstm_yolo_torch.kernels.vil_layer import _launch, vil_layer_fwd, vil_layer_ref

    dev = torch.device("cuda")
    k3 = kernel_parity(
        "vil_layer_fwd",
        lambda B, st: layer_args(B, *st[1:], seed=st[1] + B, device=dev),
        lambda args, nh: (vil_layer_fwd(*args, nh, chunk_size=CHUNK),),
        lambda args, nh: (vil_layer_ref(*args, nh, chunk_size=CHUNK),),
        lambda args, st: layer_bound(BATCH, *st[1:], sum(a.numel() for a in args[2:])))

    def bwd_case(B, stage):
        _, S, DIM, INNER, NH = stage
        args = layer_args(B, S, DIM, INNER, NH, seed=S + B + 1, device=dev)
        _, (_, q, k, v, ig, fg), carry = _launch(args, NH, "exp", 1e-6, 1e-3, 1e-6)
        dh = torch.from_numpy(np.random.default_rng(S + B).normal(
            size=(B, S, INNER)).astype(np.float32)).to(dev)
        return (q, k, v, ig, fg, dh), carry

    k2 = kernel_parity(
        "mlstm_chunkwise_bwd", bwd_case,
        lambda case, nh: mlstm_chunkwise_bwd(*case[0], nh, carry=case[1]),
        lambda case, nh: mlstm_chunkwise_bwd_plain(*case[0], nh),
        lambda case, st: bwd_bound(BATCH, st[1], st[3], st[4]))
    return k3, k2


def build_main_model(device, train: bool = False):
    """ViL-YOLO-n on ``device``: seeded init with the JAX scheme, then seeded
    gate kernels (zero at init), so the mLSTM gates vary along the
    sequence. For inference, zero class biases (detections clear the
    confidence threshold) and conv+BN folded; for training (``train``), the
    init class biases and separate BatchNorms, as a run starts."""
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
        if train:
            return model
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


@contextmanager
def plain_vil_kernels():
    """The ViL layer's autograd Function with the plain versions forced in:
    the plain forward instead of the layer kernel, the plain chunkwise
    backward instead of its kernel."""
    import xlstm_yolo_torch.kernels.vil_layer as vl
    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd_plain

    def plain_launch(args, num_heads, igate_act, eps, norm_eps, rms_eps):
        out, acts = vl._vil_layer_plain(*args, num_heads, CHUNK, igate_act, eps, norm_eps,
                                        rms_eps)
        return out, acts, ()

    def plain_bwd(*a, carry=None, **kw):
        return mlstm_chunkwise_bwd_plain(*a, **kw)

    with mock.patch.object(vl, "_launch", plain_launch), \
            mock.patch.object(vl, "mlstm_chunkwise_bwd", plain_bwd):
        yield


def train_batch(device):
    """Seeded uint8 640 px images and fixed padded labels: three boxes per
    image in N_LABELS slots, (cls, x1, y1, x2, y2) pixels."""
    import torch

    imgs = np.random.default_rng(2).integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    cb = np.zeros((BATCH, N_LABELS, 5), np.float32)
    mask = np.zeros((BATCH, N_LABELS), bool)
    boxes = [[1, 100, 100, 400, 400], [7, 320, 40, 600, 260], [15, 20, 380, 250, 630]]
    cb[:, :3] = boxes
    mask[:, :3] = True
    return {"img": torch.from_numpy(imgs).to(device), "cls_boxes": torch.from_numpy(cb).to(device),
            "mask": torch.from_numpy(mask).to(device)}


def phase_train_path():
    """One TrainStep with the kernels against the same step with the plain
    versions forced in (loss, and every parameter gradient within TOL_REL of
    that tensor's max), then TRAIN_TIMED steps after TRAIN_WARMUP timed by
    stage with CUDA events."""
    import torch

    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd

    batch = train_batch("cuda")
    steps = {}
    for kind in ("kernels", "plain"):
        model = build_main_model("cuda", train=True)
        step = TrainStep(model)
        ctx = plain_vil_kernels() if kind == "plain" else nullcontext()
        with ctx:
            vil_layer_fwd.launches = mlstm_chunkwise_bwd.launches = 0
            total, aux = step.forward_loss(batch)
            step.backward(total)
            torch.cuda.synchronize()
            launches = (vil_layer_fwd.launches, mlstm_chunkwise_bwd.launches)
        grads = {n: p.grad for n, p in model.named_parameters()}
        steps[kind] = (step, float(total.detach()), grads, launches,
                       {k: float(v.detach()) for k, v in aux.items()})
    step, loss_k, grads_k, launches, aux = steps["kernels"]
    _, loss_p, grads_p, plain_launches, _ = steps["plain"]
    del steps
    gmax = max(g.abs().max().item() for g in grads_p.values())
    worst_rel, worst_name, vanishing = 0.0, None, 0
    for n, gp in grads_p.items():
        scale = gp.abs().max().item()
        err = (grads_k[n] - gp).abs().max().item()
        if scale < 1e-6 * gmax:
            # zero up to rounding (a bias that a train-mode BatchNorm removes)
            vanishing += 1
            rel = err / gmax
        else:
            rel = err / scale
        if rel > worst_rel:
            worst_rel, worst_name = rel, n
    grads_finite = all(bool(torch.isfinite(g).all()) for g in grads_k.values())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    step.apply_update()

    times = {"forward_loss": 0.0, "backward": 0.0, "update_ema": 0.0}
    losses = [loss_k]
    vil_layer_fwd.launches = mlstm_chunkwise_bwd.launches = 0
    for it in range(TRAIN_WARMUP + TRAIN_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        total, _ = step.forward_loss(batch)
        ev[1].record()
        step.backward(total)
        ev[2].record()
        step.apply_update()
        ev[3].record()
        torch.cuda.synchronize()
        losses.append(float(total.detach()))
        if it >= TRAIN_WARMUP:
            for k, (a, b) in zip(times, zip(ev[:3], ev[1:])):
                times[k] += a.elapsed_time(b) / TRAIN_TIMED
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    per_step = (vil_layer_fwd.launches / n_steps, mlstm_chunkwise_bwd.launches / n_steps)
    total_ms = sum(times.values())
    finite = all(np.isfinite(losses)) and grads_finite
    expect = (len(STAGES), len(STAGES))
    ok = (finite and launches == expect and per_step == expect and plain_launches == (0, 0)
          and worst_rel <= TOL_REL and loss_rel <= TOL_REL)
    emit({"phase": "train_path", "model": "vil_yolon.yaml", "batch": BATCH, "imgsz": IMGSZ,
          "labels": N_LABELS, "launches_vil_layer_fwd": launches[0],
          "launches_mlstm_chunkwise_bwd": launches[1], "launches_per_timed_step": per_step,
          "expected_launches": expect, "loss": loss_k, "loss_plain": loss_p,
          "loss_relerr": loss_rel, "loss_terms": aux, "grad_maxrelerr": worst_rel,
          "grad_worst": worst_name, "grads_vanishing": vanishing, "grad_max": gmax,
          "losses": losses, "finite": finite, "ms": times, "total_ms": total_ms,
          "img_per_s": BATCH / total_ms * 1e3, "ok": ok})
    if not ok:
        raise PhaseError("train path check failed")
    return launches


def main() -> int:
    phase = "device"
    try:
        smi_line, name = phase_device()
        phase = "build"
        phase_build()
        phase = "kernel_parity"
        k, k2 = phase_kernel_parity()
        phase = "main_path"
        launches = phase_main_path()
        phase = "train_path"
        train_launches = phase_train_path()
    except Exception as e:  # report the failed phase, print no result
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    import torch

    emit({"kernels": [{
        "name": "vil_layer_fwd", "route": "cuda", "source": "xlstm_yolo_torch/csrc/vil_layer.cu",
        "replaces": "xlstm_yolo_tpu/kernels/mlstm_pallas.py:1142 (_kernel_vil_layer)",
        "launches": launches, "max_abs_err": k["max_abs_err"], "maxrelerr": k["maxrelerr"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}, {
        "name": "mlstm_chunkwise_bwd", "route": "cuda",
        "source": "xlstm_yolo_torch/csrc/mlstm_bwd.cu",
        "replaces": "xlstm_yolo_tpu/kernels/mlstm_pallas_bwd.py:255 (_kernel)",
        "launches": train_launches[1], "max_abs_err": k2["max_abs_err"],
        "maxrelerr": k2["maxrelerr"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
