"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``xlstm_yolo_torch/csrc``
(one nvcc per source, all started together), holds each against its plain
PyTorch version at the shapes the main paths give it, then drives the main
paths on seeded random weights. ViL-YOLO-n at 640 px:

* inference — uint8 540x810 frames -> letterbox -> forward -> decode -> NMS
  through ``xlstm_yolo_torch.engine.predictor.Predictor``, checked against
  the same model with the plain versions forced in;
* the train step — uint8 images and padded labels -> train-mode forward ->
  v8 loss -> backward -> clip, decay, nesterov SGD, EMA through
  ``xlstm_yolo_torch.engine.trainer.TrainStep``; the loss and every
  parameter gradient are checked against the same step with the plain
  versions forced in, then the step is timed by stage.

The xLSTM language model, through ``xlstm_yolo_torch.nn.xlstm``:

* serving — token ids -> ``xLSTMLMModel`` forward -> logits, and greedy
  ``generate`` from a prompt, at the configuration of the NX-AI xlstm
  library's README language-model example (vocab 50304, embedding 128, 7
  blocks, sLSTM at block 1, 4 heads, context 256), and one forward of a
  wider model (embedding 512, 8 blocks, S 1024); logits and generated
  tokens are checked against the same models with the plain versions
  forced in, then timed.

The standalone ViL classifier, through ``xlstm_yolo_torch.nn.vil_extra``:

* ``VisionLSTM2`` at its published width (dim 192, depth 12, patch 16, 224
  px, 1000 classes; head dim 64, stochastic depth 0.05 decayed over the
  depth), batch 64 of seeded images: one eval forward, and one train step
  (train-mode forward with a seeded generator -> cross-entropy -> backward
  -> clip, decay, nesterov SGD, EMA); logits, loss and every gradient are
  checked against the same model with the plain versions forced in (the
  same masks), then both are timed. The block-fused entry
  (``MatrixLSTMCell.forward_block``) is driven once on the first block's
  activations and held against that block's layer-fused output.

The two entries no model calls, each driven on a model's real data:

* the conv-fused ViL layer (``ViLLayer.forward_conv_fused``) — a forward hook
  takes the real input of every ViL layer of the full ViL-YOLO-n at batch 8
  and 640 px; the entry, with that layer's own weights, must give that
  layer's output, in the model's direction and in the flipped one; once per
  stage also under grad, input and weight gradients against the layer's
  own path;
* the row-wise kth value (``rowwise_kth_value``) — on the candidate metric
  the task-aligned assigner really sees in a train-mode forward of the
  model (batch 8 x 32 label slots over 8400 anchors, k 10): equal to the
  assigner's chain of max and suppress passes, and giving its membership.

Train steps of the language model: forward -> ``lm_loss`` -> backward ->
``StepUpdate``, for three models: the mLSTM-only one at the README widths
(``slstm_at=()``, the class default; the chunkwise backward kernel at head
dim 64), the README model itself (its sLSTM block trained through the
reverse-time sLSTM kernel at head dim 32) and the wide model at S 1024 (the
chunkwise backward kernel at head dim 256, the sLSTM one at 128); loss and
every gradient against the same step with the plain versions forced in,
then timed by stage.

ViL-YOLO-n in bf16, the JAX package's default arithmetic (bf16 operands,
fp32 accumulation; the layer kernel and the chunkwise backward in their
bf16 entries, whose ``kernel_parity`` lines also give each stage's device
time and the time at the JAX bf16 train bench's batch, 128):

* bf16 serving (``main_path_bf16``) — the inference path through
  ``Predictor(dtype="bfloat16")`` (parameters cast to bf16 as the JAX
  ``bench.py`` casts them, bf16 letterbox and forward), checked against
  the same bf16 model with the plain versions forced in, timed by stage;
* the AMP training loop (``train_loop_amp``) — the first AMP step (bf16
  activations, fp32 parameters and gradients) against the plain-forced AMP
  step, then ``TrainStep.fit_steps`` over 4 steps with warm-up and
  accumulation 2, stage times, peak memory, and a checkpoint saved and
  loaded back exactly.

The user's surface (``fit_path``): ``make_synthetic_dataset`` writes a
YOLO-format set of PNGs (64 train, 16 val, 640 x 480), then
``xlstm_yolo_torch.YOLO("vil_yolon.yaml")`` trains on it for 2 epochs at
batch 8 and 640 px with the defaults (bf16 AMP, mosaic, HSV, flip,
``optimizer: auto``, accumulation 8), validating the EMA weights after each
epoch; ``YOLO(last.pt)`` validates again and predicts the val directory.
Then a model whose detections are not degenerate is validated on its own
jittered detections with the kernels and with the plain versions forced in.

ViL-YOLO above scale n (``vil_yolo{s,m,l,x}``, ViL widths up to DIM 640,
INNER 1280, 20 heads): one inference forward of each at batch 2 and 640
px, and one train step of ``vil_yolox``, each against the same model with
the plain versions forced in.

Every phase prints one JSON line; then come the
kernels line, the card's name and power limit as nvidia-smi gives them, and
last ``{"ok": true, "device": {...}}``, printed only when every phase passed. Exits
non-zero, printing no result, when there is no GPU or any phase fails.
Imports nothing of JAX.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import NamedTuple
from unittest import mock

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 on the CUDA
# cores, TF32 and bf16 on the tensor cores and HBM3 bandwidth. ``bound_ms`` holds the
# kernels' multiply-adds to the fp32 CUDA-core rate (one yardstick for every
# version of a kernel); ``bound_tc_ms`` to the tensor cores at the three TF32
# passes the 3xTF32 tile product makes of each (csrc/tile_mma.cuh).
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
TF32_PASSES = 3
PEAK_BYTES_PER_S = 3.35e12
TOL_REL = 1e-3
TOL_BF16_GRAD = 3e-3  # the bf16 chunkwise backward against its plain version (relative L2)
BF16_MAX_EXCESS = 5e-3  # a bf16 entry's largest error beyond its rounding, of the max
BF16_METRIC = "relative L2 (bf16 outputs both rounded); max_abs_err beyond the bf16 rounding"
BATCH, SRC_HW, IMGSZ = 8, (540, 810), 640
# ViL-YOLO-n stages at 640 px: (name, S, DIM, INNER, NH)
STAGES = [("P3", 6400, 64, 128, 2), ("P4", 1600, 128, 256, 4), ("P5", 400, 256, 512, 8)]
CHUNK = 128  # the YAML's chunk size, read by the plain version only
N_LABELS = 32  # padded label slots of a train batch, as the JAX bench_train.py
TRAIN_TIMED, TRAIN_WARMUP = 3, 1
# fit_path: a YOLO-format set of PNGs written by the phase (train, val images of W x H)
FIT_IMAGES, FIT_WH, FIT_EPOCHS = (64, 16), (640, 480), 2
FIT_CSV = ["epoch", "train/box", "train/cls", "train/dfl", "train/loss", "metrics/precision",
           "metrics/recall", "metrics/mAP50", "metrics/mAP50-95", "metrics/fitness",
           "metrics/images", "metrics/img_s", "lr", "img_s"]  # the JAX trainer's columns
FIT_METRICS = ("precision", "recall", "mAP50", "mAP50-95", "fitness")
# xLSTM language model: the NX-AI xlstm README example, and the widest model
# whose sLSTM head dim (128) the sLSTM kernel still takes
LM_README = dict(vocab_size=50304, embedding_dim=128, num_blocks=7, slstm_at=(1,), num_heads=4)
LM_WIDE = dict(vocab_size=50304, embedding_dim=512, num_blocks=8, slstm_at=(1,), num_heads=4)
LM_CONTEXT, LM_PROMPT, LM_NEW, LM_WIDE_S = 256, 192, 64, 1024
# the models that train on the card: the README widths with every block an
# mLSTM block, the README model, and the wide model at LM_WIDE_S
LM_TRAIN = {**LM_README, "slstm_at": ()}
LM_TRAIN_MODELS = [("mlstm_only", LM_TRAIN, LM_CONTEXT), ("readme", LM_README, LM_CONTEXT),
                   ("wide", LM_WIDE, LM_WIDE_S)]
# kernel cases at the language model's shapes: (name, NH, S, DH)
K1_CASES = [("readme_S256_DH64", 4, 256, 64), ("ragged_S200_DH64", 4, 200, 64),
            ("wide_S1024_DH256", 4, 1024, 256)]
K5_CASES = [("readme_S256_DH32", 4, 256, 32), ("wide_S1024_DH128", 4, 1024, 128),
            ("S1024_DH64", 4, 1024, 64)]  # head dim 64: on no model path
# the chunkwise backward at the language model's wide head dims, on K1's workspace
K2_LM_CASES = [("wide_S1024_DH256", 4, 1024, 256), ("S1024_DH128", 4, 1024, 128)]
# the ViL classifier: VisionLSTM2's defaults (NX-AI vision-lstm's vil2-tiny
# widths) with the head dim the ViL kernels take and stochastic depth on
CLS = dict(dim=192, depth=12, patch_size=16, output_shape=(1000,), mode="classifier",
           pooling="bilateral_flatten", qkv_block_size=64, chunk_size=64, bidirectional=False,
           drop_path_rate=0.05, drop_path_decay=True)
CLS_BATCH, CLS_HW = 64, 224
# kernel cases at the ViL shapes: (name, S, DIM, INNER, NH, timed batch). The
# layer kernel and the chunkwise backward run at every ViL-YOLO-n stage, at the
# classifier's shape and at scale x's P5, the cell and block kernels at the
# classifier's, P3 and scale x's P5
CLS_CASE = ("cls_S196", 196, 192, 384, 6, CLS_BATCH)
# the widest ViL stage of the flagship YAML: scale x's P5 at 640 px (P4 has the
# same widths at S 1600)
X_P5_CASE = ("xP5_S400", 400, 640, 1280, 20, BATCH)
LAYER_CASES = [(*stage, BATCH) for stage in STAGES] + [CLS_CASE, X_P5_CASE]
BF16_CASES = [(*stage, BATCH) for stage in STAGES]  # the bf16 entries: ViL-YOLO-n's stages
BF16_BIG_BATCH = 128  # the JAX bf16 train bench's batch (bench_train.py): the bf16 entries' second time
FAMILY_CASES = [CLS_CASE, ("P3_S6400", 6400, 64, 128, 2, BATCH), X_P5_CASE]
# the flagship YAML's scales above n: (YAML, ViL layers per forward)
SCALES = [("vil_yolos.yaml", 3), ("vil_yolom.yaml", 3), ("vil_yolol.yaml", 6),
          ("vil_yolox.yaml", 6)]
SCALES_BATCH = 2
# the kth-value kernel: (name, R, N, k, rows with ties and few distinct values). The
# assigner at batch 8 (8 x 32 label slots over 8400 anchors), at the JAX
# bench's batch 128, and a small case with ties inside the top k
TAL_K = 10
K8_CASES = [("tal_b8_R256", BATCH * N_LABELS, 8400, TAL_K, False),
            ("tal_b128_R4096", 128 * N_LABELS, 8400, TAL_K, False),
            ("ties_R7_N300", 7, 300, TAL_K, True)]


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


def stage_device_ms(fn, iters: int = 10) -> dict:
    """Device time per call of every kernel ``fn`` launches, by its name
    (parameter list dropped), from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
        if us:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            out[name] = out.get(name, 0.0) + us / iters / 1e3
    return out


def gate_std(inner: int) -> float:
    """Spread of the seeded gate kernels (zero at init): 0.05, shrunk above
    INNER 512 (scale n's widest stage) by sqrt(1536 / (3 INNER)), so that
    the 3*INNER-long gate dots keep the spread they have at scale n. At a
    flat 0.05 the 3,840-long dots of scale x put exp input gates near e^30
    and the normalizer near cancellation, where two fp32 summation orders
    of the backward differ by 1e-3 of its largest gradient."""
    return 0.05 * min(1.0, (1536 / (3 * inner)) ** 0.5)


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
            mk(3 * INNER, NH) * gate_std(INNER), torch.full((NH,), -8.0, device=device),
            mk(3 * INNER, NH) * gate_std(INNER), torch.full((NH,), 4.0, device=device),
            1.0 + mk(INNER) * 0.2, mk(INNER) * 0.1, 1.0 + mk(INNER) * 0.1,
            mk(INNER, DIM) * INNER ** -0.5, mk(DIM) * 0.1]


def vil_bound(kind, B, S, DIM, INNER, NH, n_weight_floats):
    """Least time for one call of the ViL family's ``kind`` ("cell", "block"
    or "layer"): the larger of its FLOPs over the fp32 peak and the bytes of
    its inputs, output and weights over the HBM rate. FLOPs count the work
    the CUDA function does per token. The cell: headwise q/k/v, the two gate
    dots, per head the causal half of the intra-chunk q k^T and E v products
    over the kernel's chunk length plus the inter-chunk q C and
    chunk-summary k v^T products; it reads conv_act and x_mlstm and writes
    h. The block adds proj_down and reads z and the residual too, writing
    (B, S, DIM). The layer adds proj_up (both halves) and reads only x and
    conv_act. Elementwise work (norms, exp, gating) is left out."""
    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS

    dh = INNER // NH
    macs = 3 * INNER * dh + 6 * INNER * NH + NH * ((KERNEL_CS + 1) * dh + 2 * dh * dh)
    floats = 3 * INNER
    if kind != "cell":
        macs += INNER * DIM
        floats = 3 * INNER + 2 * DIM
    if kind == "layer":
        macs += 2 * INNER * DIM
        floats = 2 * DIM + INNER
    return roofline(2 * B * S * macs, 4 * (B * S * floats + n_weight_floats))


def conv_bound(B, S, DIM, INNER, NH, n_weight_floats):
    """Least time for one conv-fused layer call: the layer's operations
    (``vil_bound``) plus the nine multiply-adds per token and channel of the
    depthwise conv, against the bytes of x, out and the weights only."""
    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS

    dh = INNER // NH
    macs = (3 * INNER * dh + 6 * INNER * NH + NH * ((KERNEL_CS + 1) * dh + 2 * dh * dh)
            + 3 * INNER * DIM + 9 * INNER)
    return roofline(2 * B * S * macs, 4 * (2 * B * S * DIM + n_weight_floats))


def importable(module: str):
    """True if ``module`` imports, else the error it raised."""
    try:
        importlib.import_module(module)
    except Exception as e:  # a missing package, or one whose libraries fail to load
        return f"{type(e).__name__}: {e}"
    return True


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
    # the port decodes PNG and BMP itself; JPEG needs one of these two
    found = {m: importable(m) for m in ("cv2", "PIL")}
    emit({"phase": "device", "nvidia_smi": smi_line, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "importable": found})
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


def bf16_ulp(t):
    """One bf16 unit in the last place at each |t|: 2^(e - 8) for |t| in
    [2^(e-1), 2^e) (8 significant bits)."""
    import torch

    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def compare_bf16(got, want):
    """``compare`` for the bf16 entries: (max abs error beyond the bf16
    output's own rounding, relative L2 error, ok). A bf16 output is held to
    its plain version's fp32 value before that rounding: the relative L2
    error of the two rounded to bf16, and the largest error beyond half a
    bf16 ulp, which must stay within BF16_MAX_EXCESS of the max. The max
    alone is no gate here: two bf16 pipelines that sum in other orders
    round some intermediates the other way, and the plain version against
    itself on inputs one fp32 ulp apart is 3.0e-3 of the max beyond
    rounding at P3 (measured on an NVIDIA H100 80GB HBM3 at 700.00 W).
    fp32 outputs: the relative L2 error and the max error within
    BF16_MAX_EXCESS."""
    import torch

    g, w = got.float(), want.float()
    finite = bool(torch.isfinite(got).all())
    if got.dtype == torch.bfloat16:
        rel_l2 = ((g - w.bfloat16().float()).norm() / w.norm()).item()
        excess = ((g - w).abs() - 0.5 * bf16_ulp(torch.maximum(g.abs(), w.abs()))).clamp(min=0)
    else:
        rel_l2 = ((g - w).norm() / w.norm()).item()
        excess = (g - w).abs()
    abs_err = excess.max().item()
    return abs_err, rel_l2, finite and abs_err <= BF16_MAX_EXCESS * w.abs().max().item()


def grad_dist(grads_a, grads_b):
    """Relative L2 distance of two gradients of a model, each taken as one
    vector (the parameters in ``grads_b``'s order)."""
    import torch

    a = torch.cat([grads_a[n].float().flatten() for n in grads_b])
    b = torch.cat([g.float().flatten() for g in grads_b.values()])
    return ((a - b).norm() / b.norm()).item()


def grad_errors(grads_k, grads_p):
    """(worst relative error, its name, count of vanishing tensors, the
    largest gradient) of the kernels' gradients against the plain-forced
    ones, each tensor held to its own max; a tensor that is zero up to
    rounding is held to the largest gradient of the model."""
    gmax = max(g.abs().max().item() for g in grads_p.values())
    worst_rel, worst_name, vanishing = 0.0, None, 0
    for n, gp in grads_p.items():
        scale = gp.abs().max().item()
        err = (grads_k[n] - gp).abs().max().item()
        if scale < 1e-6 * gmax:
            vanishing += 1
            rel = err / gmax
        else:
            rel = err / scale
        if rel > worst_rel:
            worst_rel, worst_name = rel, n
    return worst_rel, worst_name, vanishing, gmax


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
    return roofline(2 * macs, 4 * (7 * B * S * INNER + 4 * B * NH * S
                                   + B * NH * ns * (dh * dh + dh + 3)))


def bf16_vil_bound(B, S, DIM, INNER, NH, n_weight_floats):
    """Least time for one call of the bf16 layer kernel: its multiply-adds
    (``vil_bound``'s count for the layer) over the 989 TFLOP/s bf16
    tensor-core peak, against the bytes of x, conv_act and out at 2 bytes
    an activation and of the fp32 weights; ``tc_ms`` is the operations'
    time alone."""
    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS

    dh = INNER // NH
    macs = (3 * INNER * dh + 6 * INNER * NH + NH * ((KERNEL_CS + 1) * dh + 2 * dh * dh)
            + 3 * INNER * DIM)
    return bf16_bound(2 * B * S * macs, 2 * B * S * (2 * DIM + INNER) + 4 * n_weight_floats)


def bf16_bwd_bound(B, S, INNER, NH):
    """Least time for one call of the bf16 chunkwise backward: ``bwd_bound``'s
    multiply-adds over the bf16 tensor-core peak, against its bytes with
    q, k, v, dq, dk, dv at 2 bytes and dh, the gates and the states at 4."""
    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS as CS

    dh = INNER // NH
    ns = -(-S // CS)
    macs = B * NH * ns * (3 * CS * (CS + 1) * dh + 5 * CS * dh * dh)
    return bf16_bound(2 * macs, 2 * 6 * B * S * INNER + 4 * (B * S * INNER + 4 * B * NH * S
                                                           + B * NH * ns * (dh * dh + dh + 3)))


def bf16_bound(flops, nbytes):
    """The ``Bound`` of bf16 tensor-core work: ``ms`` the larger of the
    operations at PEAK_BF16_FLOPS and the bytes at PEAK_BYTES_PER_S,
    ``tc_ms`` the operations alone."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return Bound(*((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")),
                 t_ops, "operations")


class Bound(NamedTuple):
    """Least time of a call: ``ms`` with its operations at the fp32
    CUDA-core peak, ``tc_ms`` with them at the TF32 tensor-core peak over
    TF32_PASSES (for work that is no product, the same as ``ms``), each
    against the bytes over the HBM rate; ``by`` and ``tc_by`` say which
    side bounds it."""
    ms: float
    by: str
    tc_ms: float
    tc_by: str


def roofline(flops, nbytes, products: bool = True) -> Bound:
    """The ``Bound`` of ``flops`` operations (multiply-adds count two;
    ``products``: they are matrix products the tensor cores can take) and
    ``nbytes`` bytes moved."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_tc = flops * TF32_PASSES / PEAK_TF32_FLOPS * 1e3 if products else t_ops
    side = lambda t: (t, "operations") if t >= t_bytes else (t_bytes, "bytes")
    return Bound(*side(t_ops), *side(t_tc))


def mlstm_fwd_bound(B, NH, S, DH):
    """Least time for one chunkwise-forward call. FLOPs count the
    multiply-adds the function needs per token and head at the kernel's
    chunk length: the causal half of q k^T and of E v ((CS + 1) DH), the
    inter-chunk q C and the chunk-summary k^T v (2 DH^2), times 2; bytes
    count q, k, v and the gates read once and h written once. Elementwise
    work (exp, scans, the normalizer) is left out."""
    from xlstm_yolo_torch.kernels.mlstm_fwd import KERNEL_CS

    flops = 2 * B * NH * S * ((KERNEL_CS + 1) * DH + 2 * DH * DH)
    return roofline(flops, 4 * (4 * B * NH * S * DH + 2 * B * NH * S))


def slstm_bwd_bound(B, NH, S, DH):
    """Least time for one sLSTM backward call (``slstm_scan_bwd``: the
    reverse-time kernel, then dr and db). FLOPs count the per-step
    transposed recurrent product R draw (DH x 4DH multiply-adds) and the dr
    sum y_{t-1}^T draw (as many), times 2; bytes count what the call reads
    once (the forward's saved gate values and states, 7 DH a step, y, dy and
    r) and writes once (dwx, dr, db). The kernel reads the forward's gate
    values in place of wx (the same 4 DH a step). The pointwise gate math is
    left out."""
    flops = 2 * 2 * B * S * NH * DH * 4 * DH
    return roofline(flops, 4 * (13 * B * S * NH * DH + 2 * NH * 4 * DH * (DH + 1)))


def merged(a, b):
    """The kernels-line totals of two ``kernel_parity`` runs of one kernel."""
    out = {k: a[k] + b[k] for k in ("ms", "plain_ms", "bound_ms", "bound_tc_ms")}
    out.update(maxrelerr=max(a["maxrelerr"], b["maxrelerr"]),
               max_abs_err=max(a["max_abs_err"], b["max_abs_err"]),
               bound_by=a["bound_by"] if a["bound_by"] == b["bound_by"] else "operations",
               bound_tc_by=a["bound_tc_by"] if a["bound_tc_by"] == b["bound_tc_by"]
               else "operations", ms_by_case={**a["ms_by_case"], **b["ms_by_case"]})
    return out


def slstm_bound(B, NH, S, DH):
    """Least time for one sLSTM scan call. FLOPs count the per-head
    recurrent product y R of every step (DH x 4DH multiply-adds, times 2;
    no block-diagonal zeros); bytes count wx, r and b read once and y
    written once. The pointwise gate math is left out."""
    flops = 2 * B * S * NH * DH * 4 * DH
    return roofline(flops, 4 * (5 * B * S * NH * DH + NH * 4 * DH * (DH + 1)))


def kernel_parity(kernel, cases, make_case, run, plain, bound, extra=None,
                  batch_of=lambda case: BATCH, cross=None, cmp=None, tol=TOL_REL,
                  metric="max relative error"):
    """``run`` (the kernel's wrapper) vs ``plain`` (its plain version) on
    ``make_case(B, case)`` for every case, at the main path's batch
    ``batch_of(case)`` (the arguments that are then timed) and at batch 2;
    ``bound(args, case)`` gives the case's ``Bound``;
    both return a tuple of outputs, each held to TOL_REL of its own max;
    ``cross(args, case)``, where given, returns further references the
    kernel's outputs are held to in the same way; its time at the timed
    batch is printed as ``cross_ms`` and used nowhere else.
    Emits one line per case (with ``extra(case, ms)`` merged in) and returns
    the totals over the cases for the kernels line. ``cmp`` (default
    ``compare``) measures one output against its reference -> (abs error,
    relative error, ok), ``tol`` bounds the relative error, ``metric``
    names it in the printed lines."""
    cmp = compare if cmp is None else cmp
    worst_rel, worst_abs = 0.0, 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_tc_ms": 0.0}
    bound_by, bound_tc_by, ms_by_case = set(), set(), {}
    for case in cases:
        errs = {}
        for B in (batch_of(case), 2):
            args = make_case(B, case)
            got = run(args, case)
            per = [cmp(g, w) for g, w in zip(got, plain(args, case))]
            if cross is not None:
                per += [compare(g, w) for g, w in zip(got, cross(args, case))]
            errs[B] = (max(e[0] for e in per), max(e[1] for e in per), all(e[2] for e in per))
            if B == batch_of(case):
                timed = args
        ok = all(fin and rel <= tol for _, rel, fin in errs.values())
        abs_err = max(e[0] for e in errs.values())
        rel = max(e[1] for e in errs.values())
        ms = cuda_time_ms(lambda: run(timed, case), iters=20)
        plain_ms = cuda_time_ms(lambda: plain(timed, case), iters=5)
        bnd = bound(timed, case)
        cross_ms = {"cross_ms": cuda_time_ms(lambda: cross(timed, case), iters=10)} if cross else {}
        emit({"phase": "kernel_parity", "kernel": kernel, "case": case[0], **cross_ms,
              "shape": [batch_of(case), *case[1:5]],
              "maxrelerr_by_batch": {str(b): e[1] for b, e in errs.items()},
              "max_abs_err": abs_err, "maxrelerr": rel, "relerr_metric": metric, "tol": tol,
              "ok": ok,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd.ms, "bound_by": bnd.by,
              "bound_tc_ms": bnd.tc_ms, "bound_tc_by": bnd.tc_by,
              **(extra(case, ms) if extra else {})})
        if not ok:
            raise PhaseError(f"{kernel} disagrees with its plain version at {case[0]}: "
                             f"maxrelerr {rel}")
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, abs_err)
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["bound_ms"] += bnd.ms
        totals["bound_tc_ms"] += bnd.tc_ms
        bound_by.add(bnd.by)
        bound_tc_by.add(bnd.tc_by)
        ms_by_case[case[0]] = ms
    one = lambda sides: sides.pop() if len(sides) == 1 else "operations"
    return {"maxrelerr": worst_rel, "max_abs_err": worst_abs, **totals,
            "bound_by": one(bound_by), "bound_tc_by": one(bound_tc_by), "ms_by_case": ms_by_case}


def kth_rows(R, N, ties, seed, device):
    """Rows as the assigner's masked metric has them: mostly zeros, no
    negatives. ``ties``: rows 0 and 1 tie their four largest values and
    their 6th with their 7th (ties inside the top k) and the last row holds
    fewer than TAL_K distinct values."""
    import torch

    rng = np.random.default_rng(seed)
    x = np.where(rng.random((R, N)) < 0.97, 0.0, np.abs(rng.standard_normal((R, N))))
    x = x.astype(np.float32)
    if ties:
        order = np.argsort(-x[:2], axis=1)
        for r in range(2):
            x[r, order[r, 1:4]] = x[r, order[r, 0]]
            x[r, order[r, 6]] = x[r, order[r, 5]]
        x[-1] = rng.integers(0, 4, N).astype(np.float32)
    return torch.from_numpy(x).to(device)


def kth_parity(device):
    """K8 (rowwise_kth_value vs rowwise_kth_value_plain) at K8_CASES: exact
    equality (the function selects, it does not round). ``library_ms`` times
    ``torch.topk(x, k).values[:, -1:]`` on the same rows: another function
    where values tie, a yardstick for time only. The bound is the bytes of
    x read once and the result written once; at R 256 that is 2.6 us, below
    the cost of a launch."""
    import torch

    from xlstm_yolo_torch.kernels.topk import rowwise_kth_value, rowwise_kth_value_plain

    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_tc_ms": 0.0, "library_ms": 0.0}
    worst_abs = 0.0
    for name, R, N, k, ties in K8_CASES:
        x = kth_rows(R, N, ties, seed=R + N, device=device)
        got, want = rowwise_kth_value(x, k), rowwise_kth_value_plain(x, k)
        torch.cuda.synchronize()
        exact = tuple(got.shape) == (R, 1) and bool(torch.equal(got, want))
        abs_err = (got - want).abs().max().item()
        below_k = int((want <= -1e30).sum())  # rows with fewer than k distinct values
        ok = exact and (not ties or below_k >= 1)
        ms = cuda_time_ms(lambda: rowwise_kth_value(x, k), iters=20)
        plain_ms = cuda_time_ms(lambda: rowwise_kth_value_plain(x, k), iters=5)
        library_ms = cuda_time_ms(lambda: torch.topk(x, k).values[:, -1:], iters=20)
        bound = roofline(R * N, 4 * (R * N + R), products=False)
        bound_ms, by = bound.ms, bound.by
        emit({"phase": "kernel_parity", "kernel": "rowwise_kth_value", "case": name,
              "shape": [R, N], "k": k, "exact": exact, "max_abs_err": abs_err,
              "rows_below_k_distinct": below_k, "tol": 0.0, "ok": ok, "ms": ms,
              "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": by, "gb_per_s": 4 * R * N / ms / 1e6})
        if not ok:
            raise PhaseError(f"rowwise_kth_value differs from its plain version at {name}: "
                             f"max abs err {abs_err}")
        worst_abs = max(worst_abs, abs_err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                         ("bound_tc_ms", bound.tc_ms), ("library_ms", library_ms)):
            totals[key] += val
    return {"maxrelerr": 0.0, "max_abs_err": worst_abs, **totals, "bound_by": "bytes",
            "bound_tc_by": "bytes"}


def phase_kernel_parity():
    """K3 (vil_layer_fwd vs vil_layer_ref) on seeded layer arguments; K2
    (mlstm_chunkwise_bwd vs mlstm_chunkwise_bwd_plain) on the activations
    and carry states the layer kernel's forward leaves for seeded layer
    arguments, with a seeded output gradient, both at the ViL-YOLO-n stages,
    at the classifier's shape and at scale x's P5; K1 (mlstm_chunkwise_fwd vs
    mlstm_chunkwise_fwd_plain) and K5 (slstm_scan_fwd vs slstm_scan) on
    seeded arguments at the language model's shapes (and K5 at head dim 64);
    K2 also at the language model's head dims 128 and 256 on K1's workspace
    (vs mlstm_chunkwise_bwd_ref), and the sLSTM backward (slstm_scan_bwd vs
    slstm_scan_bwd_plain) on K5's workspace at K5's shapes;
    K4 (vil_cell_fwd vs vil_cell_plain) and K7 (vil_block_fwd vs
    vil_block_plain) on arguments
    cut from seeded layer arguments at the classifier's shape, at
    ViL-YOLO's P3 and at scale x's P5, and the three of the family against
    each other; K6
    (vil_layer_conv_fwd vs vil_layer_conv_plain, and vs the library conv
    feeding K3) at the grids of K3's cases; K8
    (``kth_parity``). The bf16 entries of K3 and K2 at the ViL-YOLO-n stages
    against their plain bf16 versions (``compare_bf16``: relative L2 within
    TOL_REL forward and TOL_BF16_GRAD gradients, the max beyond rounding
    within BF16_MAX_EXCESS), each also timed at BF16_BIG_BATCH, with the
    device time of each stage at both batches (``bf16_extra``)."""
    import torch

    from xlstm_yolo_torch.kernels.mlstm_bwd import (KERNEL_CS, mlstm_chunkwise_bwd,
                                                    mlstm_chunkwise_bwd_plain,
                                                    mlstm_chunkwise_bwd_ref)
    from xlstm_yolo_torch.kernels.mlstm_fwd import (_carry_states, mlstm_chunkwise_bwd_heads,
                                                    mlstm_chunkwise_fwd, mlstm_chunkwise_fwd_plain)
    from xlstm_yolo_torch.kernels.mlstm_fwd import _launch as mlstm_fwd_launch
    from xlstm_yolo_torch.kernels.slstm import (SAVED, slstm_scan, slstm_scan_bwd,
                                                slstm_scan_bwd_plain, slstm_scan_fwd)
    from xlstm_yolo_torch.kernels.slstm import _launch as slstm_launch
    from xlstm_yolo_torch.kernels.vil_block import tail_plain, vil_block_fwd, vil_block_plain
    from xlstm_yolo_torch.kernels.vil_cell import Cfg, vil_cell_fwd, vil_cell_plain
    from xlstm_yolo_torch.kernels.vil_conv import (_conv_pre, vil_layer_conv_fwd,
                                                    vil_layer_conv_plain)
    from xlstm_yolo_torch.kernels.vil_layer import (_head, _launch, vil_layer_fwd,
                                                    vil_layer_ref)

    dev = torch.device("cuda")
    timed_batch = lambda case: case[5]
    k3 = kernel_parity(
        "vil_layer_fwd", LAYER_CASES,
        lambda B, case: layer_args(B, *case[1:5], seed=case[1] + B, device=dev),
        lambda args, case: (vil_layer_fwd(*args, case[4], chunk_size=CHUNK),),
        lambda args, case: (vil_layer_ref(*args, case[4], chunk_size=CHUNK),),
        lambda args, case: vil_bound("layer", case[5], *case[1:5],
                                     sum(a.numel() for a in args[2:])),
        batch_of=timed_batch)

    def bwd_case(B, case):
        _, S, DIM, INNER, NH, _ = case
        args = layer_args(B, S, DIM, INNER, NH, seed=S + B + 1, device=dev)
        _, (_, q, k, v, ig, fg), carry = _launch(args, Cfg(NH))
        dh = torch.from_numpy(np.random.default_rng(S + B).normal(
            size=(B, S, INNER)).astype(np.float32)).to(dev)
        return (q, k, v, ig, fg, dh), carry

    k2 = kernel_parity(
        "mlstm_chunkwise_bwd", LAYER_CASES, bwd_case,
        lambda args, case: mlstm_chunkwise_bwd(*args[0], case[4], carry=args[1]),
        lambda args, case: mlstm_chunkwise_bwd_plain(*args[0], case[4]),
        lambda args, case: bwd_bound(case[5], case[1], case[3], case[4]),
        batch_of=timed_batch)

    def seeded(seed):
        rng = np.random.default_rng(seed)
        return lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)

    def fwd_case(B, case):
        _, NH, S, DH = case
        mk = seeded(S + DH + B)
        return (mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S),
                mk(B, NH, S) + 2.0)

    k1 = kernel_parity(
        "mlstm_chunkwise_fwd", K1_CASES, fwd_case,
        lambda args, case: (mlstm_chunkwise_fwd(*args),),
        lambda args, case: (mlstm_chunkwise_fwd_plain(*args),),
        lambda args, case: mlstm_fwd_bound(BATCH, *case[1:]),
        extra=lambda case, ms: {"us_per_step": ms * 1e3 / case[2]})

    def scan_case(B, case):
        _, NH, S, DH = case
        mk = seeded(S + DH + B + 1)
        return mk(B, S, NH, 4, DH), mk(NH, DH, 4, DH) * DH ** -0.5, mk(NH, 4, DH)

    k5 = kernel_parity(
        "slstm_scan_fwd", K5_CASES, scan_case,
        lambda args, case: (slstm_scan_fwd(*args),),
        lambda args, case: (slstm_scan(*args),),
        lambda args, case: slstm_bound(BATCH, *case[1:]),
        extra=lambda case, ms: {"us_per_step": ms * 1e3 / case[2]})

    def k2_lm_case(B, case):
        """Aligned q and k (the normalizer away from zero), gates, dh, and
        the carry states K1's forward leaves in its workspace."""
        _, NH, S, DH = case
        mk = seeded(S + DH + B + 2)
        q = mk(B, NH, S, DH)
        args = (q, q + 0.3 * mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S) - 3.0,
                mk(B, NH, S) + 3.0)
        _, ws, off = mlstm_fwd_launch(*args, "exp", 1e-6, states=True)
        return (*args, mk(B, NH, S, DH)), _carry_states(ws, off, B * NH, S, DH)

    k2 = merged(k2, kernel_parity(
        "mlstm_chunkwise_bwd", K2_LM_CASES, k2_lm_case,
        lambda args, case: mlstm_chunkwise_bwd_heads(*args[0], carry=args[1]),
        lambda args, case: mlstm_chunkwise_bwd_ref(*args[0], chunk_size=64),
        lambda args, case: bwd_bound(BATCH, case[2], case[1] * case[3], case[1])))

    def scan_bwd_case(B, case):
        """K5's arguments, its forward's workspace and y, a seeded dy."""
        wx, r, b = scan_case(B, case)
        y, _, saved = slstm_launch(wx, r, b, None, return_last_state=False, save=True)
        return wx, r, b, y, saved, seeded(case[2] + B + 9)(*y.shape)

    k5b = kernel_parity(
        "slstm_scan_bwd", K5_CASES, scan_bwd_case,
        lambda args, case: slstm_scan_bwd(args[1], args[3], args[4], args[5]),
        lambda args, case: slstm_scan_bwd_plain(*args[:4], args[4][:, :, :, 4:SAVED].unbind(3),
                                                args[5]),
        lambda args, case: slstm_bwd_bound(BATCH, *case[1:]),
        extra=lambda case, ms: {"us_per_step": ms * 1e3 / case[2]})
    for case in K5_CASES:  # the state carried through the kernel: two halves are the full scan
        wx, r, b = scan_case(2, case)
        half = case[2] // 2
        launched = slstm_scan_fwd.launches
        y1, mid = slstm_scan_fwd(wx[:, :half], r, b, return_last_state=True)
        y2, last = slstm_scan_fwd(wx[:, half:], r, b, initial_state=mid, return_last_state=True)
        launched = slstm_scan_fwd.launches - launched
        want = slstm_scan(wx, r, b, return_last_state=True)
        per = [compare(g, w) for g, w in zip((torch.cat([y1, y2], 1), *last), (want[0], *want[1]))]
        rel = max(e[1] for e in per)
        ok = launched == 2 and all(e[2] for e in per) and rel <= TOL_REL
        wx, r, b = scan_case(BATCH, case)  # a carried call's time at the main path's batch
        state = slstm_scan_fwd(wx, r, b, return_last_state=True)[1]
        carry_ms = cuda_time_ms(lambda: slstm_scan_fwd(wx, r, b, initial_state=state,
                                                       return_last_state=True), iters=20)
        emit({"phase": "kernel_parity", "kernel": "slstm_scan_fwd", "case": case[0] + "_carry",
              "shape": [2, *case[1:]], "launches": launched, "maxrelerr": rel, "tol": TOL_REL,
              "ok": ok, "carry_ms_at_batch": {str(BATCH): carry_ms}})
        if not ok:
            raise PhaseError(f"slstm_scan_fwd's state carry disagrees with the plain scan at "
                             f"{case[0]}: maxrelerr {rel}")

    def block_case(B, case):
        """conv_act, x_mlstm, z, x_res, the cell's 10 and the tail's 5
        arguments, from seeded layer arguments."""
        _, S, DIM, INNER, NH, _ = case
        a = layer_args(B, S, DIM, INNER, NH, seed=S + B + 2, device=dev)
        mk = seeded(S + B + 3)
        return [a[1], mk(B, S, INNER), mk(B, S, INNER), a[0], *a[5:]]

    cell_of = lambda args: [args[0], args[1], *args[4:14]]
    k4 = kernel_parity(
        "vil_cell_fwd", FAMILY_CASES, lambda B, case: cell_of(block_case(B, case)),
        lambda args, case: (vil_cell_fwd(*args, case[4], chunk_size=CHUNK),),
        lambda args, case: (vil_cell_plain(*args, case[4], chunk_size=CHUNK),),
        lambda args, case: vil_bound("cell", case[5], *case[1:5], sum(a.numel() for a in args[2:])),
        batch_of=timed_batch)
    k7 = kernel_parity(
        "vil_block_fwd", FAMILY_CASES, block_case,
        lambda args, case: (vil_block_fwd(*args, case[4], chunk_size=CHUNK),),
        lambda args, case: (vil_block_plain(*args, case[4], chunk_size=CHUNK),),
        lambda args, case: vil_bound("block", case[5], *case[1:5],
                                     sum(a.numel() for a in args[4:])),
        batch_of=timed_batch)

    # one set of layer arguments three ways: the layer kernel; the block
    # kernel behind RMSNorm and proj_up in torch; the torch tail over the
    # cell kernel's h; each also against the plain layer
    _, S, DIM, INNER, NH, B = CLS_CASE
    a = layer_args(B, S, DIM, INNER, NH, seed=7, device=dev)
    x, conv_act = a[:2]
    *_, x_mlstm, z = _head(x, *a[2:5], 1e-6)
    layer = vil_layer_fwd(*a, NH)
    block = vil_block_fwd(conv_act, x_mlstm, z, x, *a[5:], NH)
    tail = tail_plain(vil_cell_fwd(conv_act, x_mlstm, *a[5:15], NH), conv_act, z, x, *a[15:],
                      Cfg(NH))
    plain = vil_layer_ref(*a, NH)
    rels = {"block_vs_layer": compare(block, layer)[1], "tail_over_cell_vs_layer":
            compare(tail, layer)[1], "tail_over_cell_vs_block": compare(tail, block)[1],
            "layer_vs_plain": compare(layer, plain)[1], "block_vs_plain": compare(block, plain)[1],
            "tail_over_cell_vs_plain": compare(tail, plain)[1]}
    ok = all(r <= TOL_REL for r in rels.values())
    emit({"phase": "kernel_parity", "kernel": "vil_family_three_way", "shape": [B, S, DIM, INNER, NH],
          "maxrelerr": rels, "tol": TOL_REL, "ok": ok})
    if not ok:
        raise PhaseError(f"the layer, block and cell kernels disagree with each other or "
                         f"with the plain layer: {rels}")

    def conv_case(B, case):
        """x, the norm and proj_up, a seeded depthwise kernel and bias, the
        cell's and the tail's arguments, from seeded layer arguments."""
        _, S, DIM, INNER, NH, _ = case
        a = layer_args(B, S, DIM, INNER, NH, seed=S + B + 4, device=dev)
        mk = seeded(S + B + 5)
        return [a[0], *a[2:5], mk(INNER, 1, 3, 3) * 0.3, mk(INNER) * 0.1, *a[5:]]

    grid = lambda case: (int(round(case[1] ** 0.5)),) * 2  # 80x80, 40x40, 20x20, 14x14

    def conv_then_layer(args, case):
        """The library's depthwise conv feeding the layer kernel."""
        import torch.nn.functional as F

        *_, x_mlstm, _ = _head(args[0], *args[1:4], 1e-6)
        conv_act = F.silu(_conv_pre(x_mlstm, args[4], args[5], grid(case)))
        return (vil_layer_fwd(args[0], conv_act, *args[1:4], *args[6:], case[4]),)

    k6 = kernel_parity(
        "vil_layer_conv_fwd", LAYER_CASES, conv_case,
        lambda args, case: (vil_layer_conv_fwd(*args, case[4], grid(case), chunk_size=CHUNK),),
        lambda args, case: (vil_layer_conv_plain(*args, case[4], grid(case), chunk_size=CHUNK),),
        lambda args, case: conv_bound(case[5], *case[1:5], sum(a.numel() for a in args[1:])),
        batch_of=timed_batch, cross=conv_then_layer,
        extra=lambda case, ms: {"grid": list(grid(case))})
    k8 = kth_parity(dev)

    # the bf16 entries at the ViL-YOLO-n stages (batch 8 timed, and 2): each
    # against its plain bf16 version at the kernel's chunk (the rounding of E
    # and of the carried C depends on the chunking), bf16 outputs held before
    # their rounding (compare_bf16); beside each, the fp32 kernel's time
    def bf16_layer_case(B, case):
        a = layer_args(B, *case[1:5], seed=case[1] + B + 20, device=dev)
        return [a[0].bfloat16(), a[1].bfloat16(), *a[2:]]

    def bf16_extra(k, make_case, run, bound):
        """Beside each bf16 case: the fp32 kernel's time and the speedup over
        it, each stage's device time at the timed batch, and the kernel's
        time, bound and stages at BF16_BIG_BATCH (timed only: the parity
        checks run at the timed batch and at 2)."""
        def extra(case, ms):
            args = make_case(BATCH, case)
            stages = stage_device_ms(lambda: run(args, case))
            big = make_case(BF16_BIG_BATCH, case)
            big_case = (*case[:5], BF16_BIG_BATCH)
            big_ms = cuda_time_ms(lambda: run(big, big_case), iters=10)
            out = {"fp32_ms": k["ms_by_case"][case[0]], "bf16_speedup": k["ms_by_case"][case[0]] / ms,
                   "stage_device_ms": stages,
                   f"ms_b{BF16_BIG_BATCH}": big_ms,
                   f"bound_ms_b{BF16_BIG_BATCH}": bound(big, big_case).ms,
                   f"stage_device_ms_b{BF16_BIG_BATCH}": stage_device_ms(lambda: run(big, big_case))}
            del big
            torch.cuda.empty_cache()
            return out
        return extra

    run_k3b = lambda args, case: (vil_layer_fwd(*args, case[4]),)
    bound_k3b = lambda args, case: bf16_vil_bound(case[5], *case[1:5],
                                                  sum(a.numel() for a in args[2:]))
    k3b = kernel_parity(
        "vil_layer_fwd_bf16", BF16_CASES, bf16_layer_case, run_k3b,
        lambda args, case: (vil_layer_ref(*args, case[4], chunk_size=KERNEL_CS, keep_fp32=True),),
        bound_k3b, batch_of=timed_batch, cmp=compare_bf16,
        extra=bf16_extra(k3, bf16_layer_case, run_k3b, bound_k3b), metric=BF16_METRIC)

    def bf16_bwd_case(B, case):
        _, S, DIM, INNER, NH, _ = case
        a = bf16_layer_case(B, case)
        _, (_, q, k, v, ig, fg), carry = _launch(a, Cfg(NH), True)
        dh = torch.from_numpy(np.random.default_rng(S + B + 21).normal(
            size=(B, S, INNER)).astype(np.float32)).to(dev)
        return (q, k, v, ig, fg, dh), carry

    run_k2b = lambda args, case: mlstm_chunkwise_bwd(*args[0], case[4], carry=args[1])
    bound_k2b = lambda args, case: bf16_bwd_bound(case[5], case[1], case[3], case[4])
    k2b = kernel_parity(
        "mlstm_chunkwise_bwd_bf16", BF16_CASES, bf16_bwd_case, run_k2b,
        lambda args, case: mlstm_chunkwise_bwd_plain(*args[0], case[4], keep_fp32=True),
        bound_k2b, batch_of=timed_batch, cmp=compare_bf16, tol=TOL_BF16_GRAD,
        extra=bf16_extra(k2, bf16_bwd_case, run_k2b, bound_k2b), metric=BF16_METRIC)
    return k3, k2, k1, k5, k5b, k4, k7, k6, k8, k3b, k2b


def build_main_model(device, train: bool = False, cfg: str = "vil_yolon.yaml"):
    """ViL-YOLO (scale n unless ``cfg`` names another) on ``device``: seeded
    init with the JAX scheme, then seeded gate kernels (zero at init;
    ``gate_std``), so the mLSTM gates vary along the sequence. For
    inference, zero class biases (detections clear the confidence
    threshold) and conv+BN folded; for training (``train``), the init class
    biases and separate BatchNorms, as a run starts."""
    import torch

    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn
    from xlstm_yolo_torch.nn.tasks import TaskModel
    from xlstm_yolo_torch.nn.vil import MatrixLSTMCell

    model = TaskModel(cfg, device=device, seed=0)
    g = torch.Generator(device="cpu").manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MatrixLSTMCell):
                for lin in (m.igate, m.fgate):
                    std = gate_std(lin.weight.shape[1] // 3)
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * std)
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
    """The ViL family's calls with the plain versions forced in on the card:
    the plain forward instead of the layer, cell and block kernels, and
    with it (no carry states kept) the plain chunkwise backward."""
    import xlstm_yolo_torch.kernels.vil_cell as vc

    with mock.patch.object(vc, "_on_card", lambda t: False):
        yield


def train_batch(device, batch: int = BATCH):
    """Seeded uint8 640 px images and fixed padded labels: three boxes per
    image in N_LABELS slots, (cls, x1, y1, x2, y2) pixels."""
    import torch

    imgs = np.random.default_rng(2).integers(0, 256, (batch, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    cb = np.zeros((batch, N_LABELS, 5), np.float32)
    mask = np.zeros((batch, N_LABELS), bool)
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
        step = TrainStep(model, amp=False)
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
    # a bias that a train-mode BatchNorm removes has a gradient that is zero up to rounding
    worst_rel, worst_name, vanishing, gmax = grad_errors(grads_k, grads_p)
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


def phase_main_path_bf16():
    """bf16 serving at the ``main_path`` boundary: ``Predictor(dtype=
    "bfloat16")`` (parameters cast to bf16 after the conv+BN fold, BatchNorm
    statistics fp32; bf16 letterbox and forward; decode and NMS fp32) on
    the same frames. Its candidates are held against the same bf16 model
    with the plain versions forced in, as ``main_path`` holds the fp32 ones:
    boxes within TOL_REL of their max, scores within TOL_REL; the same
    model's fp32-vs-bf16 gap (both plain-forced) is printed beside. One
    bf16 layer launch per ViL layer, no fp32 one; timed by stage as
    ``main_path``."""
    import torch

    from xlstm_yolo_torch.engine.predictor import Predictor
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd
    from xlstm_yolo_torch.nn.heads import decode_detections

    model = build_main_model("cuda")
    frames = np.random.default_rng(0).integers(0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)
    raw = torch.from_numpy(frames).cuda()
    with plain_vil_kernels(), torch.inference_mode():
        ref32 = model.predictions(Predictor(model, imgsz=IMGSZ).preprocess(raw)[0])
    pred = Predictor(model, imgsz=IMGSZ, dtype="bfloat16")

    vil_layer_fwd.launches = vil_layer_fwd.launches_bf16 = 0
    dets, valid, cands, meta = pred(raw)
    torch.cuda.synchronize()
    launches = (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16)
    with plain_vil_kernels(), torch.inference_mode():
        ref = model.predictions(pred.preprocess(raw)[0])
    torch.cuda.synchronize()

    box = lambda a, b: ((a[..., :4] - b[..., :4]).abs().max() / b[..., :4].abs().max()).item()
    score = lambda a, b: (a[..., 4:] - b[..., 4:]).abs().max().item()
    box_rel, score_abs = box(cands, ref), score(cands, ref)
    box_gap, score_gap = box(ref32, ref), score(ref32, ref)
    n_cand = sum((IMGSZ // s) ** 2 for s in model.strides)
    shapes_ok = (tuple(cands.shape) == (BATCH, n_cand, 4 + model.nc)
                 and tuple(dets.shape) == (BATCH, 300, 6) and tuple(valid.shape) == (BATCH, 300))
    finite = bool(torch.isfinite(cands).all() and torch.isfinite(dets).all())
    n_valid = int(valid.sum())
    bf16_params = {p.dtype for p in model.parameters()} == {torch.bfloat16}

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
    ok = (shapes_ok and finite and bf16_params and launches == (0, len(STAGES)) and n_valid > 0
          and box_rel <= TOL_REL and score_abs <= TOL_REL)
    emit({"phase": "main_path_bf16", "model": "vil_yolon.yaml", "batch": BATCH,
          "src_hw": list(SRC_HW), "imgsz": IMGSZ, "params_dtype": "bfloat16",
          "launches_vil_layer_fwd": launches[0], "launches_vil_layer_fwd_bf16": launches[1],
          "expected_launches": [0, len(STAGES)], "shapes_ok": shapes_ok, "finite": finite,
          "cands_box_maxrelerr": box_rel, "cands_box_fp32_gap": box_gap,
          "cands_score_max_abs_err": score_abs, "cands_score_fp32_gap": score_gap,
          "valid_dets": n_valid, "ms": times, "total_ms": total_ms,
          "img_per_s": BATCH / total_ms * 1e3, "ok": ok})
    if not ok:
        raise PhaseError("bf16 main path check failed")
    return launches[1]


def phase_train_loop_amp():
    """The AMP training loop. (a) The first AMP step (``TrainStep(amp=True)``:
    bf16 activations, fp32 parameters and gradients; forward, loss,
    backward) against the same step with the plain versions forced in, and
    the plain-forced fp32 step beside them: the loss within 1e-2 relative,
    and the model's gradient (one vector) no further from the plain-forced
    AMP gradient than 1.5 times the distance between that and the fp32
    gradient. A bf16 step's gradient is dominated by its rounding here:
    behind each train-mode BatchNorm, the weight gradient is the small part
    of a large one that the normalization leaves, so an intermediate that
    rounds the other way moves it by a share, and the kernels' rounding
    flips move the whole gradient about as far as bf16 itself does (the
    JAX package's bf16 step against its fp32 one likewise,
    ``tests/test_torch_amp.py``). The kernels are held at their own
    boundary instead: each ViL layer function of that step, on the inputs
    and output gradient the step gave it, against its plain version
    (``bf16_layer_grads``). One bf16 layer and one bf16 backward launch per
    ViL layer, no fp32 one. (b) ``fit_steps`` over two
    epochs of two batches (4 steps; warm-up over the first 2, the
    accumulation of 2 steps into each update), then stage times over
    TRAIN_TIMED steps, peak memory and launches. (c) A checkpoint of the
    loop saved and loaded back: weights, buffers, EMA, optimizer state and
    n_updates exactly."""
    import tempfile

    import torch

    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd
    from xlstm_yolo_torch.utils.checkpoint import (load_checkpoint, load_optimizer_state,
                                                   save_checkpoint)

    counters = lambda: (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16,
                        mlstm_chunkwise_bwd.launches, mlstm_chunkwise_bwd.launches_bf16)

    def reset():
        vil_layer_fwd.launches = vil_layer_fwd.launches_bf16 = 0
        mlstm_chunkwise_bwd.launches = mlstm_chunkwise_bwd.launches_bf16 = 0

    batch = train_batch("cuda")
    first, calls = {}, []
    for kind in ("kernels", "plain", "plain_fp32"):
        model = build_main_model("cuda", train=True)
        step = TrainStep(model, amp=kind != "plain_fp32", accumulate=2)
        record = recording_vil_layers(calls) if kind == "kernels" else nullcontext()
        with plain_vil_kernels() if kind != "kernels" else nullcontext(), record:
            reset()
            total, aux = step.forward_loss(batch)
            step.backward(total)
            torch.cuda.synchronize()
            launches = counters()
        first[kind] = (float(total.detach()), {n: p.grad for n, p in model.named_parameters()},
                       launches, {k: float(v.detach()) for k, v in aux.items()})
        del step, model, total
    loss_k, grads_k, launches, aux = first["kernels"]
    loss_p, grads_p, plain_launches, _ = first["plain"]
    loss_32, grads_32, _, _ = first["plain_fp32"]
    del first
    worst_rel, worst_name, vanishing, gmax = grad_errors(grads_k, grads_p)
    dist, gap = grad_dist(grads_k, grads_p), grad_dist(grads_32, grads_p)
    grads_fp32 = all(g.dtype == torch.float32 for g in grads_k.values())
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k.values())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    del grads_k, grads_p, grads_32
    layers = [bf16_layer_grads(**c) for c in calls]
    del calls
    n = len(STAGES)
    first_ok = (finite and grads_fp32 and launches == (0, n, 0, n)
                and plain_launches == (0, 0, 0, 0) and loss_rel <= 1e-2 and dist <= 1.5 * gap
                and len(layers) == n and all(lay["ok"] for lay in layers))

    model = build_main_model("cuda", train=True)
    step = TrainStep(model, amp=True, accumulate=2)
    batch2 = {**batch, "img": torch.flip(batch["img"], dims=(2,))}
    reset()
    torch.cuda.reset_peak_memory_stats()
    log = step.fit_steps([batch, batch2], epochs=2)
    torch.cuda.synchronize()
    loop_launches = counters()
    loop_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    times = {"forward_loss": 0.0, "backward": 0.0, "update_ema": 0.0}
    for it in range(TRAIN_WARMUP + TRAIN_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        total, _ = step.forward_loss(batch)
        ev[1].record()
        step.backward(total)
        ev[2].record()
        step.apply_update(log[-1]["lr"])
        ev[3].record()
        torch.cuda.synchronize()
        if it >= TRAIN_WARMUP:
            for k, (a, b) in zip(times, zip(ev[:3], ev[1:])):
                times[k] += a.elapsed_time(b) / TRAIN_TIMED
    total_ms = sum(times.values())
    loop_ok = (len(log) == 4 and all(np.isfinite(r["loss"]) for r in log)
               and [r["lr"] for r in log][:1] == [0.0] and log[1]["lr"] > 0.0
               and loop_launches == (0, 4 * n, 0, 4 * n) and step.n_updates == 4 + TRAIN_WARMUP
               + TRAIN_TIMED and step.update.mini_step == 0)

    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(f"{tmp}/last.pt", step, epoch=1)
        loaded, meta = load_checkpoint(path, use_ema=False, device=batch["img"].device)
        same_weights = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                              loaded.state_dict().values()))
        resumed = TrainStep(loaded, amp=True, accumulate=2)
        restored = load_optimizer_state(path, resumed)
        same_state = all(torch.equal(a, b) for k in ("trace", "mu", "nu", "acc", "ema")
                         for a, b in zip(getattr(step.update, k), getattr(resumed.update, k)))
        ckpt_ok = (same_weights and restored and same_state and meta["epoch"] == 1
                   and resumed.n_updates == step.n_updates)
    ok = first_ok and loop_ok and ckpt_ok
    emit({"phase": "train_loop_amp", "model": "vil_yolon.yaml", "batch": BATCH, "imgsz": IMGSZ,
          "optimizer": step.update.name, "accumulate": 2,
          "first_step": {"launches": dict(zip(("vil_layer_fwd", "vil_layer_fwd_bf16",
                                               "mlstm_chunkwise_bwd", "mlstm_chunkwise_bwd_bf16"),
                                              launches)),
                         "loss": loss_k, "loss_plain": loss_p, "loss_plain_fp32": loss_32,
                         "loss_relerr": loss_rel, "loss_terms": aux, "grad_dist": dist,
                         "grad_dist_fp32_gap": gap, "grad_worst_tensor_relerr": worst_rel,
                         "grad_worst": worst_name, "grads_vanishing": vanishing,
                         "grads_fp32": grads_fp32, "vil_layers": layers, "ok": first_ok},
          "fit_steps": {"steps": log, "launches": list(loop_launches), "peak_memory_gib":
                        loop_peak_gib, "ok": loop_ok},
          "ms": times, "total_ms": total_ms, "img_per_s": BATCH / total_ms * 1e3,
          "checkpoint": {"same_weights": same_weights, "same_optimizer_state": same_state,
                         "ok": ckpt_ok}, "ok": ok})
    if not ok:
        raise PhaseError("AMP train loop check failed")
    return {"vil_layer_fwd_bf16": launches[1] + loop_launches[1],
            "mlstm_chunkwise_bwd_bf16": launches[3] + loop_launches[3]}


def shaped_detector(device, nc: int = 3, seed: int = 1):
    """ViL-YOLO-n with ``nc`` classes whose detections are not degenerate, as
    ``tests/test_torch_val.py`` shapes its model: seeded noise on every
    parameter (0.05) and BatchNorm variances in [0.5, 1.5], so that every
    weight and statistic matters; class biases ~ N(-10, 1) and class
    weights ~ N(0, 3) (most anchors background, a few percent of the
    (anchor, class) scores above 0.05); DFL biases that decay over the 16
    bins (boxes of a few strides)."""
    import torch

    from xlstm_yolo_torch.nn.tasks import TaskModel

    model = TaskModel("vil_yolon.yaml", nc=nc, device="cpu", seed=0)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
        det = getattr(model, f"l{model.parsed.head_index}")
        for i in range(det.nl):
            cls, box = getattr(det, f"cv3_{i}_2"), getattr(det, f"cv2_{i}_2")
            cls.bias.copy_(torch.randn(cls.bias.shape, generator=g) - 10.0)
            cls.weight.copy_(torch.randn(cls.weight.shape, generator=g) * 3.0)
            box.bias.copy_(torch.arange(16.0).repeat(4) * -0.9
                           + torch.randn(box.bias.shape, generator=g) * 0.4)
            box.weight.copy_(torch.randn(box.weight.shape, generator=g) * 0.02)
    return model.to(device).eval()


def write_own_labels(model, data, imgsz: int = IMGSZ, seed: int = 3) -> int:
    """The model's own detections on ``data``'s val images (multi-label,
    conf 0.05, up to 300 an image, as many as validation keeps), jittered so that their IoU with the
    detections varies, written as the val labels; returns the count."""
    import torch

    from xlstm_yolo_torch.data.dataset import build_dataloader
    from xlstm_yolo_torch.ops.nms import non_max_suppression

    loader, _ = build_dataloader(data, "val", batch=BATCH, imgsz=imgsz, augment=False)
    loader.ds.uint8_images = True
    rng = np.random.default_rng(seed)
    n = 0
    for batch in loader:
        with torch.inference_mode():
            x = torch.from_numpy(batch["img"]).cuda().float() / 255.0
            dets, valid = non_max_suppression(model.predictions(x), conf_thres=0.05,
                                              iou_thres=0.7, max_det=300, multi_label=True)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        for bi, idx in enumerate(batch["im_idx"]):
            (h0, w0), f = batch["ori_shape"][bi], loader.ds.files[int(idx)]
            r = imgsz / max(h0, w0)  # the loader's long-side resize; the letterbox pads
            pad = ((imgsz - w0 * r) / 2, (imgsz - h0 * r) / 2)
            lines = []
            for x1, y1, x2, y2, _, c in dets[bi][valid[bi]]:
                wh = np.array([x2 - x1, y2 - y1] * 2)
                box = np.array([x1, y1, x2, y2]) + wh * rng.uniform(-0.08, 0.08, 4) * [-1, -1, 1, 1]
                box += rng.uniform(-3, 3, 4)
                # back to the image's own pixels, inside it
                box = (box - [pad[0], pad[1], pad[0], pad[1]]) / r
                box = np.clip(box, 0, [w0, h0, w0, h0])
                if box[2] - box[0] >= 2 and box[3] - box[1] >= 2:
                    lines.append(f"{int(c)} {(box[0] + box[2]) / 2 / w0:.6f} "
                                 f"{(box[1] + box[3]) / 2 / h0:.6f} {(box[2] - box[0]) / w0:.6f} "
                                 f"{(box[3] - box[1]) / h0:.6f}")
            lines = lines or ["1 0.5 0.5 0.25 0.25"]  # an unmatched object: false negatives too
            n += len(lines)
            lbl = f.replace("/images/", "/labels/").rsplit(".", 1)[0] + ".txt"
            with open(lbl, "w") as fh:
                fh.write("\n".join(lines) + "\n")
    for cache in Path(loader.ds.files[0]).parent.glob("labels_*.cache.npz"):
        cache.unlink()
    return n


def phase_fit_path(smi_line):
    """The user's surface: train and validate ViL-YOLO-n on a YOLO-format
    dataset on disk, then predict. (a) ``make_synthetic_dataset`` writes
    FIT_IMAGES PNGs of FIT_WH (1-3 objects of 3 classes each);
    ``YOLO("vil_yolon.yaml").train(data, epochs=2, batch=8, imgsz=640)`` at
    the defaults (bf16 AMP, mosaic, HSV, flip, ``optimizer: auto``, ``nbs``
    64 so accumulation 8) but ``close_mosaic=1``: the default 10 would turn
    mosaic off from the first of 2 epochs, so the first epoch runs mosaic
    and the second closes it. Gates: the CSV's two rows with the JAX
    trainer's columns; ``best.pt`` and ``last.pt``; ``YOLO(last.pt).val``
    gives the last epoch's metrics again within 1e-6; ``.predict`` of the
    val directory gives 16 ``Results`` with boxes inside each image's
    frame; per train step 3 launches each of the bf16 layer and backward
    kernels and none of the fp32 ones, per validation batch 3 of the fp32
    layer kernel and none else (counters read around each step and batch).
    Timed: the epochs' img/s, each step on the card (CUDA events at the
    step's callbacks), the host's seconds to read, augment, collate and
    pin each batch (the loader's own clock, in its thread), validation
    img/s; then the trained step's stages (3 steps after 1 warm-up). (b) A
    validation that is not degenerate: ``shaped_detector`` on the val
    images with the model's own jittered detections as labels, through
    ``Validator`` with the kernels and with the plain versions forced in
    (320 label slots an image, so that every label counts): mAP50 and
    mAP50-95 within 1e-3 of each other, mAP50-95 in [0.2, 0.95].
    Only (a)'s launches count for the path."""
    import csv
    import shutil
    import tempfile

    import torch

    from xlstm_yolo_torch import YOLO
    from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset
    from xlstm_yolo_torch.engine.validator import Validator
    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd

    names = ("vil_layer_fwd", "vil_layer_fwd_bf16", "mlstm_chunkwise_bwd",
             "mlstm_chunkwise_bwd_bf16")
    counters = lambda: np.array([vil_layer_fwd.launches, vil_layer_fwd.launches_bf16,
                                 mlstm_chunkwise_bwd.launches, mlstm_chunkwise_bwd.launches_bf16])
    n = len(STAGES)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = make_synthetic_dataset(f"{tmp}/ds", n_train=FIT_IMAGES[0], n_val=FIT_IMAGES[1],
                                      width=FIT_WH[0], height=FIT_WH[1], seed=0)
        write_s = time.perf_counter() - t0
        model = YOLO("vil_yolon.yaml")
        steps, val_batches, host_s, events = [], [], [], []
        mark = {}

        def start(kind):
            def fn(_):
                mark[kind] = counters()
                if kind == "train":
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[0].record()
                    events.append(ev)
            return fn

        def end(kind, out):
            def fn(obj):
                out.append(counters() - mark[kind])
                if kind == "train":
                    events[-1][1].record()
            return fn

        model.add_callback("on_train_batch_start", start("train"))
        model.add_callback("on_train_batch_end", end("train", steps))
        model.add_callback("on_val_batch_start", start("val"))
        model.add_callback("on_val_batch_end", end("val", val_batches))
        model.add_callback("on_train_epoch_end",
                           lambda tr: host_s.append(list(tr.loader.batch_seconds)))
        vil_layer_fwd.launches = vil_layer_fwd.launches_bf16 = 0
        mlstm_chunkwise_bwd.launches = mlstm_chunkwise_bwd.launches_bf16 = 0
        t0 = time.perf_counter()
        model.train(data=data, epochs=FIT_EPOCHS, batch=BATCH, imgsz=IMGSZ, seed=0,
                    close_mosaic=1, project=f"{tmp}/runs", name="fit")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        trainer = model.trainer
        run = Path(trainer.save_dir)
        with open(run / "results.csv") as f:
            rows = list(csv.DictReader(f))
        last_val = {k: float(rows[-1][f"metrics/{k}"]) for k in FIT_METRICS}
        reloaded = YOLO(run / "last.pt")
        again = reloaded.val(data=data, imgsz=IMGSZ, batch=16)
        results = reloaded.predict(Path(data).parent / "images" / "val", imgsz=IMGSZ, conf=0.001)
        torch.cuda.synchronize()
        fit_launches = dict(zip(names, counters().tolist()))

        inside = all(len(r.boxes) == 0 or (
            (r.boxes.xyxy >= 0).all() and (r.boxes.xyxy[:, [0, 2]] <= r.orig_shape[1]).all()
            and (r.boxes.xyxy[:, [1, 3]] <= r.orig_shape[0]).all()) for r in results)
        n_boxes = sum(len(r) for r in results)
        frames = {tuple(r.orig_shape) for r in results}
        step_ms = [a.elapsed_time(b) for a, b in events]
        host_ms = [1e3 * s for epoch in host_s for s in epoch]
        per_step = {tuple(c.tolist()) for c in steps}
        per_val = {tuple(c.tolist()) for c in val_batches}
        reval_err = max(abs(again[k] - last_val[k]) for k in FIT_METRICS)

        # the trained step's stages, on one batch of the loader
        step = trainer.step
        batch = trainer._to_device(next(iter(trainer.loader)))
        times = {"forward_loss": 0.0, "backward": 0.0, "update_ema": 0.0}
        for it in range(TRAIN_WARMUP + TRAIN_TIMED):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            total, _ = step.forward_loss(batch)
            ev[1].record()
            step.backward(total)
            ev[2].record()
            step.apply_update(float(rows[-1]["lr"]))
            ev[3].record()
            torch.cuda.synchronize()
            if it >= TRAIN_WARMUP:
                for k, (a, b) in zip(times, zip(ev[:3], ev[1:])):
                    times[k] += a.elapsed_time(b) / TRAIN_TIMED

        fit_ok = (len(rows) == FIT_EPOCHS and list(rows[0]) == FIT_CSV
                  and (run / "best.pt").exists() and (run / "last.pt").exists()
                  and all(np.isfinite(float(r["train/loss"])) for r in rows)
                  and reval_err <= 1e-6 and len(results) == FIT_IMAGES[1] and inside
                  and n_boxes > 0 and frames == {FIT_WH[::-1]}
                  and len(steps) == FIT_EPOCHS * (FIT_IMAGES[0] // BATCH)
                  # one validation batch (16 images) an epoch; the reload's own
                  # validator runs without these callbacks
                  and per_step == {(0, n, 0, n)} and len(val_batches) == FIT_EPOCHS
                  and per_val == {(n, 0, 0, 0)} and trainer.step.update.accumulate == 64 // BATCH)

        # (b) a validation that is not degenerate, with the kernels and plain
        shutil.copytree(Path(data).parent / "images" / "val", f"{tmp}/own/images/val")
        (Path(tmp) / "own" / "labels" / "val").mkdir(parents=True)
        own = {"path": f"{tmp}/own", "val": "images/val", "names": {0: "a", 1: "b", 2: "c"}}
        shaped = shaped_detector("cuda")
        n_labels = write_own_labels(shaped, own)
        maps = {}
        for kind in ("kernels", "plain"):
            with plain_vil_kernels() if kind == "plain" else nullcontext():
                maps[kind] = Validator(shaped, imgsz=IMGSZ, batch=BATCH, max_labels=320)(own)
        map_err = max(abs(maps["kernels"][k] - maps["plain"][k]) for k in ("mAP50", "mAP50-95"))
        own_ok = map_err <= 1e-3 and 0.2 <= maps["kernels"]["mAP50-95"] <= 0.95
    ok = fit_ok and own_ok
    emit({"phase": "fit_path", "model": "vil_yolon.yaml", "card": smi_line,
          "dataset": {"train": FIT_IMAGES[0], "val": FIT_IMAGES[1], "wh": list(FIT_WH),
                      "format": "png", "write_s": write_s},
          "epochs": FIT_EPOCHS, "batch": BATCH, "imgsz": IMGSZ, "close_mosaic": 1,
          "optimizer": trainer.step.update.name, "accumulate": trainer.step.update.accumulate,
          "amp": trainer.step.amp, "csv": rows, "train_s": train_s,
          "epoch_img_s": [float(r["img_s"]) for r in rows],
          "val_img_s": [float(r["metrics/img_s"]) for r in rows],
          "step_ms": {"mean": float(np.mean(step_ms)), "median": float(np.median(step_ms)),
                      "n": len(step_ms)},
          "host_batch_ms": {"mean": float(np.mean(host_ms)), "median": float(np.median(host_ms)),
                            "n": len(host_ms)},
          "stage_ms": times, "stage_total_ms": sum(times.values()),
          "launches": fit_launches, "launches_per_step": sorted(per_step),
          "launches_per_val_batch": sorted(per_val), "val_batches": len(val_batches),
          "reval": again, "reval_max_err": reval_err, "predict": {
              "images": len(results), "boxes": n_boxes, "inside": inside,
              "frames": sorted(frames)},
          "own_labels": {"labels": n_labels, "kernels": maps["kernels"], "plain": maps["plain"],
                         "map_max_err": map_err, "ok": own_ok},
          "phase_s": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError("fit path check failed")
    return {k: v for k, v in fit_launches.items() if v}


@contextmanager
def recording_vil_layers(calls):
    """Each ViL layer function call of the model, with its arguments and
    (in the backward) its output gradient, appended to ``calls``."""
    import torch

    import xlstm_yolo_torch.nn.vil as vil_mod

    real = vil_mod.vil_layer_fwd

    def recording(*args, **kw):
        out = real(*args, **kw)
        rec = {"args": [a.detach().clone() if torch.is_tensor(a) else a for a in args], "kw": kw}
        out.register_hook(lambda g: rec.__setitem__("gout", g.detach().clone()))
        calls.append(rec)
        return out

    with mock.patch.object(vil_mod, "vil_layer_fwd", recording):
        yield


def bf16_layer_grads(args, kw, gout):
    """One recorded bf16 ViL layer call again, through the kernels (K3 and
    K2 in bf16 under the hand backward) and through the plain versions at
    the kernel's chunk: every gradient within TOL_BF16_GRAD (relative L2,
    those of x and conv_act bf16, both rounded) and its largest error beyond
    the bf16 rounding within 1e-2 of the max, or within twice the plain
    version's own distance to itself on fp32 weights one ulp apart where
    that is larger (the gate biases' gradients are sums over B x S tokens
    that cancel)."""
    import torch

    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS
    from xlstm_yolo_torch.kernels.vil_cell import Cfg
    from xlstm_yolo_torch.kernels.vil_layer import _layer_plain, vil_layer_bwd_ref, vil_layer_fwd

    tensors, nh = args[:20], args[20]
    leaves = [t.clone().requires_grad_() for t in tensors]
    vil_layer_fwd(*leaves, nh, **kw).backward(gout)
    cfg = Cfg(nh, KERNEL_CS, kw.get("igate_act", "exp"), kw.get("eps", 1e-6),
              kw.get("norm_eps", 1e-3), kw.get("rms_eps", 1e-6))
    plain = lambda a: vil_layer_bwd_ref(a, _layer_plain(a, cfg)[1], gout, nh, chunk_size=KERNEL_CS,
                                        igate_act=cfg.igate_act, eps=cfg.eps,
                                        norm_eps=cfg.norm_eps, rms_eps=cfg.rms_eps)
    want = plain(tensors)
    nudged = [torch.nextafter(t, torch.full_like(t, float("inf"))) if t.dtype == torch.float32
              else t for t in tensors]
    floor = plain(nudged)
    worst_l2, worst_max, ok = 0.0, 0.0, True
    for leaf, w, wf in zip(leaves, want, floor):
        scale = w.abs().max().item()
        excess, l2, _ = compare_bf16(leaf.grad, w)
        f_excess, f_l2, _ = compare_bf16(wf.to(leaf.grad.dtype), w)
        excess, f_max = excess / scale, f_excess / scale
        ok = ok and l2 <= max(TOL_BF16_GRAD, 2 * f_l2) and excess <= max(1e-2, 2 * f_max)
        worst_l2, worst_max = max(worst_l2, l2), max(worst_max, excess)
    return {"shape": list(tensors[1].shape), "grad_rel_l2": worst_l2,
            "grad_max_beyond_rounding": worst_max, "ok": ok}


def phase_kth_path():
    """The kth-value entry on the candidate metric the assigner really sees:
    one train-mode forward and loss of ViL-YOLO-n on the train batch, with
    the assigner's ``topk_positive_mask`` watched for its argument (B x
    N_LABELS x 8400). ``rowwise_kth_value`` on those rows must equal the
    assigner's own chain exactly, and its threshold must give the
    assigner's membership."""
    import torch

    import xlstm_yolo_torch.utils.tal as tal_mod
    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.kernels.topk import rowwise_kth_value, rowwise_kth_value_plain

    step = TrainStep(build_main_model("cuda", train=True), amp=False)
    seen = []
    chain = tal_mod.topk_positive_mask

    def watched(metric, k):
        seen.append((metric, k, chain(metric, k)))
        return seen[-1][2]

    with mock.patch.object(tal_mod, "topk_positive_mask", watched), torch.no_grad():
        step.forward_loss(train_batch("cuda"))
    metric, k, members = seen[0]
    rows = metric.reshape(-1, metric.shape[-1])
    rowwise_kth_value.launches = 0
    kth = rowwise_kth_value(rows, k)
    torch.cuda.synchronize()
    launches = rowwise_kth_value.launches
    exact = bool(torch.equal(kth, rowwise_kth_value_plain(rows, k)))
    mine = ((rows >= kth.clamp(min=0.0)) & (rows > 0.0)).reshape(metric.shape)
    same_members = bool(torch.equal(mine, members > 0))
    n_members = int(mine.sum())
    positive_rows = int((rows > 0).any(dim=1).sum())
    ms = cuda_time_ms(lambda: rowwise_kth_value(rows, k), iters=20)
    chain_ms = cuda_time_ms(lambda: rowwise_kth_value_plain(rows, k), iters=5)
    ok = (len(seen) == 1 and tuple(rows.shape) == (BATCH * N_LABELS, 8400) and k == TAL_K
          and launches == 1 and exact and same_members and n_members > 0)
    emit({"phase": "kth_path", "model": "vil_yolon.yaml", "batch": BATCH, "rows": list(rows.shape),
          "k": k, "launches_rowwise_kth_value": launches, "expected_launches": 1, "exact": exact,
          "same_members_as_assigner": same_members, "members": n_members,
          "rows_with_candidates": positive_rows, "ms": ms, "chain_ms": chain_ms, "ok": ok})
    if not ok:
        raise PhaseError("kth-value path check failed")
    return launches


def phase_conv_path():
    """The conv-fused entry on the full ViL-YOLO-n's real activations. A
    forward hook takes every ViL layer's input, token grid and output in one
    inference forward at batch BATCH; ``forward_conv_fused`` with the layer's
    own weights must reproduce the output within TOL_REL, in the model's
    direction and with the layer turned to the other direction (against the
    layer's own path there). Once per stage also under grad: the input's and
    every weight's gradient against the layer's own path."""
    import torch

    from xlstm_yolo_torch.engine.predictor import Predictor
    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_conv import vil_layer_conv_fwd
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd
    from xlstm_yolo_torch.nn.vil import ViLLayer

    counters = (vil_layer_conv_fwd, vil_layer_fwd, mlstm_chunkwise_bwd)

    def reset():
        for c in counters:
            c.launches = 0

    count = lambda: tuple(c.launches for c in counters)
    model = build_main_model("cuda")
    pred = Predictor(model, imgsz=IMGSZ)
    frames = np.random.default_rng(0).integers(0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)
    layers = [(n, m) for n, m in model.named_modules() if isinstance(m, ViLLayer)]
    taken = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=n: taken.__setitem__(name, (args[0], args[1], out)))
        for n, m in layers]
    with torch.inference_mode():
        x, _ = pred.preprocess(torch.from_numpy(frames).cuda())
        model.predictions(x)
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()

    per_layer, total_launches, ok = [], [0, 0, 0], len(taken) == len(layers) == len(STAGES)
    for name, layer in layers:
        x_in, seqlens, want = (t.clone() if torch.is_tensor(t) else t for t in taken[name])
        rels, launches = {}, {}
        model_direction = layer.direction
        for direction in (model_direction, "backward" if model_direction == "forward"
                          else "forward"):
            layer.direction = direction
            with torch.no_grad():
                ref = want if direction == model_direction else layer(x_in, seqlens)
                reset()
                got = layer.forward_conv_fused(x_in, seqlens)
                torch.cuda.synchronize()
                launches[direction] = count()
            rels[direction] = compare(got, ref)[1]
            ok = ok and launches[direction] == (1, 0, 0) and rels[direction] <= TOL_REL \
                and bool(torch.isfinite(got).all())
            total_launches = [a + b for a, b in zip(total_launches, launches[direction])]
        layer.direction = model_direction

        grads = {}
        for which in ("conv_fused", "layer"):
            xg = x_in.clone().requires_grad_()
            layer.zero_grad(set_to_none=True)
            reset()
            with torch.enable_grad():
                out = layer.forward_conv_fused(xg, seqlens) if which == "conv_fused" \
                    else layer(xg, seqlens)
                out.square().mean().backward()
            torch.cuda.synchronize()
            launches["grad_" + which] = count()
            grads[which] = {"x": xg.grad, **{n: p.grad for n, p in layer.named_parameters()}}
        layer.zero_grad(set_to_none=True)
        worst_rel, worst_name, vanishing, _ = grad_errors(grads["conv_fused"], grads["layer"])
        ok = ok and launches["grad_conv_fused"] == (1, 0, 1) \
            and launches["grad_layer"] == (0, 1, 1) and worst_rel <= TOL_REL
        total_launches = [a + b for a, b in zip(total_launches, launches["grad_conv_fused"])]
        per_layer.append({"layer": name, "grid": list(seqlens), "shape": list(x_in.shape),
                          "maxrelerr_by_direction": rels, "grad_maxrelerr": worst_rel,
                          "grad_worst": worst_name, "grads_vanishing": vanishing,
                          "launches": {k: list(v) for k, v in launches.items()}})
    names = ("vil_layer_conv_fwd", "vil_layer_fwd", "mlstm_chunkwise_bwd")
    emit({"phase": "conv_path", "model": "vil_yolon.yaml", "batch": BATCH, "imgsz": IMGSZ,
          "layers": per_layer, "launch_order": list(names), "tol": TOL_REL,
          "launches": dict(zip(names, total_launches)),
          "expected_launches": {"vil_layer_conv_fwd": 3 * len(STAGES), "vil_layer_fwd": 0,
                                "mlstm_chunkwise_bwd": len(STAGES)}, "ok": ok})
    if not ok or total_launches != [3 * len(STAGES), 0, len(STAGES)]:
        raise PhaseError("conv-fused path check failed")
    return dict(zip(names, total_launches))


def build_lm_model(cfg, device):
    """The xLSTM language model on ``device``: seeded init with the JAX
    scheme, then seeded cell gate kernels and sLSTM recurrent kernels (zero
    at init), so that the gates vary along the sequence and the recurrent
    product matters."""
    import torch

    from xlstm_yolo_torch.nn.xlstm import xLSTMLMModel

    model = xLSTMLMModel(**cfg, device=device, seed=0)
    g = torch.Generator(device="cpu").manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("mlstm_cell.igate.weight", "mlstm_cell.fgate.weight")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
            elif name.endswith("recurrent_kernel"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5 * p.shape[1] ** -0.5)
    return model


def lm_inputs():
    """What ``lm_path`` drives, on the card: the README model and its
    context-length tokens, the wide model and its tokens."""
    import torch

    rng = np.random.default_rng(3)
    vocab = LM_README["vocab_size"]
    tokens = torch.from_numpy(rng.integers(0, vocab, (BATCH, LM_CONTEXT))).cuda()
    wide_tokens = torch.from_numpy(rng.integers(0, vocab, (BATCH, LM_WIDE_S))).cuda()
    return build_lm_model(LM_README, "cuda"), tokens, build_lm_model(LM_WIDE, "cuda"), wide_tokens


@contextmanager
def plain_lm_kernels():
    """The language model's two kernels replaced by their plain versions."""
    import xlstm_yolo_torch.nn.vil as vil_mod
    import xlstm_yolo_torch.nn.xlstm as lm_mod
    from xlstm_yolo_torch.kernels.mlstm_fwd import mlstm_chunkwise_fwd_plain
    from xlstm_yolo_torch.kernels.slstm import slstm_scan

    with mock.patch.object(vil_mod, "mlstm_chunkwise_fwd", mlstm_chunkwise_fwd_plain), \
            mock.patch.object(lm_mod, "slstm_scan_fwd", slstm_scan):
        yield


def phase_lm_path():
    """The xLSTM language model's serving path at batch BATCH. With the
    launch counts at 0: one forward of the README model at its context, a
    greedy ``generate`` of LM_NEW tokens from an LM_PROMPT-token prompt, and
    one forward of the wide model at LM_WIDE_S. The same three with the
    plain versions forced in give the references (logits within TOL_REL of
    their max, identical tokens). Then the three are timed."""
    import torch

    from xlstm_yolo_torch.kernels.mlstm_fwd import mlstm_chunkwise_fwd
    from xlstm_yolo_torch.kernels.slstm import slstm_scan_fwd
    from xlstm_yolo_torch.nn.xlstm import generate

    vocab = LM_README["vocab_size"]
    model, tokens, wide, wide_tokens = lm_inputs()
    prompt = tokens[:, :LM_PROMPT]

    def drive():
        with torch.no_grad():
            out = model(tokens), generate(model, prompt, max_new_tokens=LM_NEW), wide(wide_tokens)
        torch.cuda.synchronize()
        return out

    mlstm_chunkwise_fwd.launches = slstm_scan_fwd.launches = 0
    logits, gen, wide_logits = drive()
    launches = (mlstm_chunkwise_fwd.launches, slstm_scan_fwd.launches)
    with plain_lm_kernels():
        ref_logits, ref_gen, ref_wide = drive()
    plain_launches = (mlstm_chunkwise_fwd.launches - launches[0],
                      slstm_scan_fwd.launches - launches[1])

    n_m = [cfg["num_blocks"] - len(cfg["slstm_at"]) for cfg in (LM_README, LM_WIDE)]
    n_s = [len(cfg["slstm_at"]) for cfg in (LM_README, LM_WIDE)]
    per_forward = (n_m[0], n_s[0])
    expect = (n_m[0] * (1 + LM_NEW) + n_m[1], n_s[0] * (1 + LM_NEW) + n_s[1])
    shapes_ok = (tuple(logits.shape) == (BATCH, LM_CONTEXT, vocab)
                 and tuple(wide_logits.shape) == (BATCH, LM_WIDE_S, vocab)
                 and tuple(gen.shape) == (BATCH, LM_PROMPT + LM_NEW)
                 and bool((gen[:, :LM_PROMPT] == prompt).all()))
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(wide_logits).all())
    rel = compare(logits, ref_logits)[1]
    wide_rel = compare(wide_logits, ref_wide)[1]
    same_tokens = bool((gen == ref_gen).all())
    del logits, ref_logits, wide_logits, ref_wide

    def stage_ms(m, toks, iters):
        """Forward of ``m`` split into embedding + block stack, and the head."""
        x = m.stack(m.embedding(toks))
        return {"stack": cuda_time_ms(lambda: m.stack(m.embedding(toks)), iters=iters),
                "lm_head": cuda_time_ms(lambda: m.lm_head(x), iters=iters)}

    with torch.no_grad():
        forward_ms = cuda_time_ms(lambda: model(tokens), iters=10)
        wide_ms = cuda_time_ms(lambda: wide(wide_tokens), iters=5)
        stages, wide_stages = stage_ms(model, tokens, 10), stage_ms(wide, wide_tokens, 5)
        generate(model, prompt, max_new_tokens=2)  # warm-up at the prompt's length
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, prompt, max_new_tokens=LM_NEW)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3
    ok = (shapes_ok and finite and launches == expect and plain_launches == (0, 0)
          and rel <= TOL_REL and wide_rel <= TOL_REL and same_tokens)
    emit({"phase": "lm_path", "model": LM_README, "params": model.num_params(),
          "wide_model": LM_WIDE, "wide_params": wide.num_params(), "batch": BATCH,
          "context": LM_CONTEXT, "prompt": LM_PROMPT, "new_tokens": LM_NEW, "wide_S": LM_WIDE_S,
          "launches_mlstm_chunkwise_fwd": launches[0], "launches_slstm_scan_fwd": launches[1],
          "expected_launches": expect, "launches_per_forward": per_forward,
          "shapes_ok": shapes_ok, "finite": finite, "logits_maxrelerr": rel,
          "wide_logits_maxrelerr": wide_rel, "same_tokens": same_tokens, "tol": TOL_REL,
          "forward_ms": forward_ms, "forward_stage_ms": stages,
          "wide_forward_stage_ms": wide_stages, "forward_tokens_per_s": BATCH * LM_CONTEXT / forward_ms * 1e3,
          "generate_ms": gen_ms, "ms_per_generated_token": gen_ms / LM_NEW,
          "generated_tokens_per_s": BATCH * LM_NEW / gen_ms * 1e3,
          "wide_forward_ms": wide_ms,
          "wide_forward_tokens_per_s": BATCH * LM_WIDE_S / wide_ms * 1e3, "ok": ok})
    if not ok:
        raise PhaseError("language-model path check failed")
    return launches


def lm_train_inputs(vocab: int = LM_TRAIN["vocab_size"], S: int = LM_CONTEXT):
    """Seeded token ids on the card as (inputs, next-token targets), each
    (BATCH, S)."""
    import torch

    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, vocab, (BATCH, S + 1))).cuda()
    return tokens[:, :-1], tokens[:, 1:]


def phase_lm_train_path():
    """One train step of each of LM_TRAIN_MODELS (the mLSTM-only model at
    the README widths, the README model with its sLSTM block, the wide
    model) at batch BATCH: forward -> ``lm_loss`` -> backward ->
    ``StepUpdate``, with the kernels against the same step with the plain
    versions forced in (loss, and every parameter gradient within TOL_REL of
    that tensor's max), then TRAIN_TIMED steps after TRAIN_WARMUP timed by
    stage with CUDA events. Launches per step: K1 and K2 once per mLSTM
    block, K5 and the sLSTM backward once per sLSTM block."""
    import torch

    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.mlstm_fwd import mlstm_chunkwise_fwd
    from xlstm_yolo_torch.kernels.slstm import slstm_scan_bwd, slstm_scan_fwd
    from xlstm_yolo_torch.utils.loss import lm_loss
    from xlstm_yolo_torch.utils.train_utils import StepUpdate

    counters = (mlstm_chunkwise_fwd, mlstm_chunkwise_bwd, slstm_scan_fwd, slstm_scan_bwd)
    names = tuple(c.__name__ for c in counters)
    count = lambda: tuple(c.launches for c in counters)

    def reset():
        for c in counters:
            c.launches = 0

    total_launches, per_model, ok = [0] * len(counters), {}, True
    for label, cfg, S in LM_TRAIN_MODELS:
        inputs, targets = lm_train_inputs(cfg["vocab_size"], S)
        steps = {}
        for kind in ("kernels", "plain"):
            model = build_lm_model(cfg, "cuda").train()
            update = StepUpdate(model)
            with plain_lm_kernels() if kind == "plain" else nullcontext():
                reset()
                loss = lm_loss(model(inputs), targets)
                loss.backward()
                torch.cuda.synchronize()
                launches = count()
            steps[kind] = (model, update, float(loss.detach()),
                           {n: p.grad for n, p in model.named_parameters()}, launches)
            del loss
        model, update, loss_k, grads_k, launches = steps["kernels"]
        _, _, loss_p, grads_p, plain_launches = steps["plain"]
        del steps
        worst_rel, worst_name, vanishing, gmax = grad_errors(grads_k, grads_p)
        grads_finite = all(bool(torch.isfinite(g).all()) for g in grads_k.values())
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        del grads_p, grads_k
        update(1)

        times = {"forward_loss": 0.0, "backward": 0.0, "update_ema": 0.0}
        losses = [loss_k]
        reset()
        torch.cuda.reset_peak_memory_stats()
        for it in range(TRAIN_WARMUP + TRAIN_TIMED):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            model.zero_grad(set_to_none=True)
            loss = lm_loss(model(inputs), targets)
            ev[1].record()
            loss.backward()
            ev[2].record()
            update(it + 2)
            ev[3].record()
            torch.cuda.synchronize()
            losses.append(float(loss.detach()))
            if it >= TRAIN_WARMUP:
                for k, (a, b) in zip(times, zip(ev[:3], ev[1:])):
                    times[k] += a.elapsed_time(b) / TRAIN_TIMED
        n_steps = TRAIN_WARMUP + TRAIN_TIMED
        per_step = tuple(c / n_steps for c in count())
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        total_ms = sum(times.values())
        n_s = len(cfg["slstm_at"])
        n_m = cfg["num_blocks"] - n_s
        expect = (n_m, n_m, n_s, n_s)
        good = (all(np.isfinite(losses)) and grads_finite and launches == expect
                and per_step == expect and plain_launches == (0, 0, 0, 0)
                and worst_rel <= TOL_REL and loss_rel <= TOL_REL and losses[-1] < losses[0])
        ok = ok and good
        total_launches = [a + b for a, b in zip(total_launches, launches)]
        per_model[label] = {
            "model": {**cfg, "slstm_at": list(cfg["slstm_at"])}, "params": model.num_params(),
            "context": S, "launches": dict(zip(names, launches)),
            "launches_per_timed_step": per_step, "expected_launches": expect, "loss": loss_k,
            "loss_plain": loss_p, "loss_relerr": loss_rel, "grad_maxrelerr": worst_rel,
            "grad_worst": worst_name, "grads_vanishing": vanishing, "grad_max": gmax,
            "losses": losses, "ms": times, "total_ms": total_ms,
            "tokens_per_s": BATCH * S / total_ms * 1e3, "peak_memory_gib": peak_gib, "ok": good}
        del model, update
    carried = carried_slstm_state_case()
    ok = ok and carried["ok"]
    for name in ("slstm_scan_fwd", "slstm_scan_bwd"):
        total_launches[names.index(name)] += carried["launches"][name]
    emit({"phase": "lm_train_path", "batch": BATCH, "tol": TOL_REL, "models": per_model,
          "carried_state": carried, "launches": dict(zip(names, total_launches)), "ok": ok})
    if not ok:
        raise PhaseError("language-model train path check failed")
    return dict(zip(names, total_launches))


def carried_slstm_state_case():
    """The sLSTM state carried across calls, both ways, at the README model's
    sLSTM shape (batch BATCH, S LM_CONTEXT, 4 heads of 32): the second half
    of a sequence from the state the first half returned, that state
    requiring grad, the returned last state in the loss (a seeded cotangent
    on each of y, c, n, m). One K5 launch and one reverse-time launch; the
    gradients of wx, r, b and of the carried-in state against the plain
    reverse recurrence (``slstm_scan_bwd_plain`` on the plain scan's
    states), each within TOL_REL of its max."""
    import torch

    from xlstm_yolo_torch.kernels.slstm import (slstm_scan, slstm_scan_bwd, slstm_scan_bwd_plain,
                                                slstm_scan_fwd, slstm_scan_states)

    NH, DH, S = LM_README["num_heads"], LM_README["embedding_dim"] // LM_README["num_heads"], \
        LM_CONTEXT
    rng = np.random.default_rng(12)
    mk = lambda *s_: torch.from_numpy(rng.normal(size=s_).astype(np.float32)).cuda()
    wx, r, b = mk(BATCH, 2 * S, NH, 4, DH), mk(NH, DH, 4, DH) * DH ** -0.5, mk(NH, 4, DH)
    state = slstm_scan(wx[:, :S], r, b, return_last_state=True)[1]
    wx = wx[:, S:].contiguous()
    dy, dlast = mk(BATCH, S, NH, DH), mk(4, BATCH, NH, DH)
    leaves = [t.clone().requires_grad_() for t in (wx, r, b, *state)]
    slstm_scan_fwd.launches = slstm_scan_bwd.launches = 0
    y, last = slstm_scan_fwd(*leaves[:3], initial_state=tuple(leaves[3:]), return_last_state=True)
    ((y * dy).sum() + sum((s_ * d).sum() for s_, d in zip(last, dlast))).backward()
    torch.cuda.synchronize()
    launches = {"slstm_scan_fwd": slstm_scan_fwd.launches, "slstm_scan_bwd": slstm_scan_bwd.launches}
    ys, states = slstm_scan_states(wx, r, b, initial_state=state)
    want = slstm_scan_bwd_plain(wx, r, b, ys, states, dy, initial_state=state,
                                dlast=tuple(dlast), with_state=True)
    rels = {n: compare(leaf.grad, w)[1] for n, leaf, w in
            zip(("wx", "r", "b", "y0", "c0", "n0", "m0"), leaves, (*want[:3], *want[3]))}
    ok = launches == {"slstm_scan_fwd": 1, "slstm_scan_bwd": 1} and max(rels.values()) <= TOL_REL
    return {"shape": [BATCH, S, NH, DH], "launches": launches, "maxrelerr": rels, "ok": ok}


def build_cls_model(train: bool):
    """The ViL classifier on the card: seeded init with the JAX scheme, then
    seeded gate kernels (zero at init), so the mLSTM gates vary along the
    sequence."""
    import torch

    from xlstm_yolo_torch.nn.vil import MatrixLSTMCell
    from xlstm_yolo_torch.nn.vil_extra import VisionLSTM2

    model = VisionLSTM2(**CLS, resolution=(CLS_HW, CLS_HW), device="cuda", seed=0)
    g = torch.Generator(device="cpu").manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MatrixLSTMCell):
                for lin in (m.igate, m.fgate):
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    return model.train(train)


def cls_inputs():
    """What ``cls_path`` drives, on the card: seeded noise images (NHWC) and
    seeded labels."""
    import torch

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(CLS_BATCH, CLS_HW, CLS_HW, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, CLS["output_shape"][0], CLS_BATCH))
    return x.cuda(), labels.cuda()


def phase_cls_path():
    """The ViL classifier at batch CLS_BATCH. (a) One eval forward against
    the plain-forced model, then timed. (b) One stochastic-depth train step
    (forward with a seeded generator, cross-entropy, backward) against the
    plain-forced step under the same masks, then TRAIN_TIMED steps after
    TRAIN_WARMUP timed by stage. (c) The block-fused entry on the first
    block's activations against that block's layer-fused output."""
    import torch
    import torch.nn.functional as F

    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_block import vil_block_fwd
    from xlstm_yolo_torch.kernels.vil_cell import vil_cell_fwd
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd
    from xlstm_yolo_torch.utils.loss import classification_loss
    from xlstm_yolo_torch.utils.train_utils import StepUpdate

    counters = (vil_layer_fwd, vil_cell_fwd, mlstm_chunkwise_bwd, vil_block_fwd)

    def reset():
        for c in counters:
            c.launches = 0

    count = lambda: tuple(c.launches for c in counters)
    x, labels = cls_inputs()
    depth = CLS["depth"]

    # (a) eval forward
    model = build_cls_model(train=False)
    reset()
    with torch.no_grad():
        logits = model(x)
        torch.cuda.synchronize()
        eval_launches = count()
        with plain_vil_kernels():
            ref = model(x)
        eval_ms = cuda_time_ms(lambda: model(x), iters=5)
    eval_rel = compare(logits, ref)[1]
    eval_ok = (tuple(logits.shape) == (CLS_BATCH, CLS["output_shape"][0])
               and bool(torch.isfinite(logits).all()) and eval_rel <= TOL_REL
               and eval_launches == (depth, 0, 0, 0))

    # (c) the block-fused entry, on block 0's own activations
    with torch.no_grad():
        layer = model.block0.fwd.layer
        tokens = model.pos_embed(model.patch_embed(x)).flatten(1, 2)
        x_mlstm, z = layer.proj_up(layer.norm(tokens)).split(layer.inner, dim=-1)
        conv_act = F.silu(layer.conv(x_mlstm, layer.seqlens))
        reset()
        by_block = layer.mlstm_cell.forward_block(conv_act, x_mlstm, z, tokens, layer.q_proj,
                                                  layer.k_proj, layer.v_proj,
                                                  layer.learnable_skip, layer.proj_down)
        torch.cuda.synchronize()
        block_launches = vil_block_fwd.launches
        block_rel = compare(by_block, layer(tokens))[1]
    block_ok = block_launches == 1 and block_rel <= TOL_REL
    del model, logits, ref, by_block

    # (b) one train step, kernels against plain-forced under the same masks
    steps = {}
    for kind in ("kernels", "plain"):
        model = build_cls_model(train=True)
        update = StepUpdate(model)
        gen = torch.Generator(device="cuda").manual_seed(5)
        with plain_vil_kernels() if kind == "plain" else nullcontext():
            reset()
            loss = classification_loss(model(x, generator=gen), labels)
            loss.backward()
            torch.cuda.synchronize()
            launches = count()
        steps[kind] = (model, update, float(loss.detach()),
                       {n: p.grad for n, p in model.named_parameters()}, launches)
    model, update, loss_k, grads_k, launches = steps["kernels"]
    _, _, loss_p, grads_p, plain_launches = steps["plain"]
    del steps
    worst_rel, worst_name, vanishing, gmax = grad_errors(grads_k, grads_p)
    grads_finite = all(bool(torch.isfinite(g).all()) for g in grads_k.values())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    del grads_p
    update(1)

    times = {"forward_loss": 0.0, "backward": 0.0, "update_ema": 0.0}
    losses = [loss_k]
    gen = torch.Generator(device="cuda").manual_seed(6)
    reset()
    torch.cuda.reset_peak_memory_stats()
    for it in range(TRAIN_WARMUP + TRAIN_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        model.zero_grad(set_to_none=True)
        loss = classification_loss(model(x, generator=gen), labels)
        ev[1].record()
        loss.backward()
        ev[2].record()
        update(it + 2)
        ev[3].record()
        torch.cuda.synchronize()
        losses.append(float(loss.detach()))
        if it >= TRAIN_WARMUP:
            for k, (a, b) in zip(times, zip(ev[:3], ev[1:])):
                times[k] += a.elapsed_time(b) / TRAIN_TIMED
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    per_step = tuple(c / n_steps for c in count())
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    total_ms = sum(times.values())
    expect = (1, depth - 1, depth, 0)  # block 0 has rate 0 under the decayed schedule
    train_ok = (all(np.isfinite(losses)) and grads_finite and launches == expect
                and per_step == expect and plain_launches == (0, 0, 0, 0)
                and worst_rel <= TOL_REL and loss_rel <= TOL_REL)
    ok = eval_ok and block_ok and train_ok
    emit({"phase": "cls_path", "model": {**CLS, "resolution": CLS_HW}, "params": model.num_params(),
          "batch": CLS_BATCH, "tol": TOL_REL,
          "eval": {"launches_vil_layer_fwd": eval_launches[0], "expected_launches": depth,
                   "logits_maxrelerr": eval_rel, "ms": eval_ms,
                   "img_per_s": CLS_BATCH / eval_ms * 1e3, "ok": eval_ok},
          "block_entry": {"launches_vil_block_fwd": block_launches, "maxrelerr_vs_layer": block_rel,
                          "ok": block_ok},
          "train": {"launches": dict(zip(("vil_layer_fwd", "vil_cell_fwd", "mlstm_chunkwise_bwd",
                                          "vil_block_fwd"), launches)),
                    "launches_per_timed_step": per_step, "expected_launches": expect,
                    "loss": loss_k, "loss_plain": loss_p, "loss_relerr": loss_rel,
                    "grad_maxrelerr": worst_rel, "grad_worst": worst_name,
                    "grads_vanishing": vanishing, "grad_max": gmax, "losses": losses,
                    "ms": times, "total_ms": total_ms, "img_per_s": CLS_BATCH / total_ms * 1e3,
                    "peak_memory_gib": peak_gib, "ok": train_ok},
          "ok": ok})
    if not ok:
        raise PhaseError("classifier path check failed")
    names = ("vil_layer_fwd", "vil_cell_fwd", "mlstm_chunkwise_bwd", "vil_block_fwd")
    return {"cls_eval": dict(zip(names, eval_launches)), "cls_train": dict(zip(names, launches)),
            "cls_block_entry": {"vil_block_fwd": block_launches}}


def phase_scales_path():
    """ViL-YOLO above scale n. (a) For each of SCALES one
    inference forward (``predictions``) at batch SCALES_BATCH of seeded 640
    px images, against the same model with the plain versions forced in:
    box coordinates within TOL_REL of their max, scores within TOL_REL, one
    K3 launch per ViL layer; then timed. (b) One train step of the widest,
    vil_yolox (forward, loss, backward) at batch SCALES_BATCH against the
    plain-forced step: loss and every gradient within TOL_REL; one K3 and
    one K2 launch per ViL layer."""
    import torch

    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd

    x = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (SCALES_BATCH, IMGSZ, IMGSZ, 3)).astype(np.float32)).cuda()
    forwards, ok, launches_by_scale = {}, True, {}
    for cfg, n_layers in SCALES:
        model = build_main_model("cuda", cfg=cfg)
        vil_layer_fwd.launches = 0
        with torch.inference_mode():
            got = model.predictions(x)
            torch.cuda.synchronize()
            launches = vil_layer_fwd.launches
            with plain_vil_kernels():
                ref = model.predictions(x)
            ms = cuda_time_ms(lambda: model.predictions(x), iters=3, warmup=1)
        box_rel = ((got[..., :4] - ref[..., :4]).abs().max() / ref[..., :4].abs().max()).item()
        score_abs = (got[..., 4:] - ref[..., 4:]).abs().max().item()
        good = (launches == n_layers and bool(torch.isfinite(got).all())
                and box_rel <= TOL_REL and score_abs <= TOL_REL)
        forwards[cfg] = {"params_after_fuse": model.num_params(), "launches_vil_layer_fwd": launches,
                         "expected_launches": n_layers, "box_maxrelerr": box_rel,
                         "score_max_abs_err": score_abs, "forward_ms": ms, "ok": good}
        launches_by_scale[cfg] = launches
        ok = ok and good
        del model, got, ref

    cfg, n_layers = SCALES[-1]
    batch = train_batch("cuda", SCALES_BATCH)
    steps = {}
    for kind in ("kernels", "plain"):
        model = build_main_model("cuda", train=True, cfg=cfg)
        step = TrainStep(model, amp=False)
        with plain_vil_kernels() if kind == "plain" else nullcontext():
            vil_layer_fwd.launches = mlstm_chunkwise_bwd.launches = 0
            total, _ = step.forward_loss(batch)
            step.backward(total)
            torch.cuda.synchronize()
            launches = (vil_layer_fwd.launches, mlstm_chunkwise_bwd.launches)
        steps[kind] = (float(total.detach()), {n: p.grad for n, p in model.named_parameters()},
                       launches)
        del step, model
    loss_k, grads_k, train_launches = steps["kernels"]
    loss_p, grads_p, plain_launches = steps["plain"]
    del steps
    worst_rel, worst_name, vanishing, gmax = grad_errors(grads_k, grads_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    train_ok = (np.isfinite(loss_k) and all(bool(torch.isfinite(g).all()) for g in grads_k.values())
                and train_launches == (n_layers, n_layers) and plain_launches == (0, 0)
                and worst_rel <= TOL_REL and loss_rel <= TOL_REL)
    del grads_k, grads_p
    ok = ok and train_ok
    emit({"phase": "scales_path", "batch": SCALES_BATCH, "imgsz": IMGSZ, "tol": TOL_REL,
          "forward": forwards,
          "train": {"model": cfg, "launches_vil_layer_fwd": train_launches[0],
                    "launches_mlstm_chunkwise_bwd": train_launches[1],
                    "expected_launches": [n_layers, n_layers], "loss": loss_k,
                    "loss_plain": loss_p, "loss_relerr": loss_rel, "grad_maxrelerr": worst_rel,
                    "grad_worst": worst_name, "grads_vanishing": vanishing, "grad_max": gmax,
                    "ok": train_ok},
          "ok": ok})
    if not ok:
        raise PhaseError("scales path check failed")
    return {"vil_layer_fwd": sum(launches_by_scale.values()) + train_launches[0],
            "mlstm_chunkwise_bwd": train_launches[1]}


def main() -> int:
    phase = "device"
    try:
        smi_line, name = phase_device()
        phase = "build"
        phase_build()
        phase = "kernel_parity"
        k3, k2, k1, k5, k5b, k4, k7, k6, k8, k3b, k2b = phase_kernel_parity()
        phase = "main_path"
        launches = phase_main_path()
        phase = "main_path_bf16"
        bf16_launches = phase_main_path_bf16()
        phase = "train_path"
        train_launches = phase_train_path()
        phase = "train_loop_amp"
        amp_launches = phase_train_loop_amp()
        phase = "fit_path"
        fit_launches = phase_fit_path(smi_line)
        phase = "lm_path"
        lm_launches = phase_lm_path()
        phase = "cls_path"
        by_path = phase_cls_path()
        phase = "kth_path"
        kth_launches = phase_kth_path()
        phase = "conv_path"
        conv_launches = phase_conv_path()
        phase = "lm_train_path"
        lm_train_launches = phase_lm_train_path()
        phase = "scales_path"
        scales_launches = phase_scales_path()
    except Exception as e:  # report the failed phase, print no result
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    import torch

    # every path's counts, read just after it ran from counters set to 0 just before
    by_path = {"main_path": {"vil_layer_fwd": launches},
               "main_path_bf16": {"vil_layer_fwd_bf16": bf16_launches},
               "train_path": dict(zip(("vil_layer_fwd", "mlstm_chunkwise_bwd"), train_launches)),
               "train_loop_amp": amp_launches,
               "fit_path": fit_launches,
               "lm_path": dict(zip(("mlstm_chunkwise_fwd", "slstm_scan_fwd"), lm_launches)),
               **by_path,
               "kth_path": {"rowwise_kth_value": kth_launches},
               "conv_path": conv_launches,
               "lm_train_path": lm_train_launches,
               "scales_path": scales_launches}

    def entry(name, source, replaces, path, k, library_ms=None, fp32=None):
        """``launches`` is the count on ``path``, the first path that ran
        this kernel; ``launches_by_path`` has every path that launched it."""
        on_paths = {p: counts[name] for p, counts in by_path.items() if counts.get(name)}
        return {"name": name, "route": "cuda", "source": f"xlstm_yolo_torch/csrc/{source}",
                "replaces": f"xlstm_yolo_tpu/kernels/{replaces}", "launches": on_paths[path],
                "launches_by_path": on_paths,
                "max_abs_err": k["max_abs_err"], "maxrelerr": k["maxrelerr"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "bound_tc_ms": k["bound_tc_ms"], "bound_tc_by": k["bound_tc_by"],
                "library_ms": library_ms, **({"ms_by_case": k["ms_by_case"]}
                                             if "ms_by_case" in k else {}),
                **({"bf16_speedup_by_case": {c: fp32["ms_by_case"][c] / ms
                                             for c, ms in k["ms_by_case"].items()}}
                   if fp32 else {})}

    emit({"kernels": [
        entry("vil_layer_fwd", "vil_layer.cu", "mlstm_pallas.py:1142 (_kernel_vil_layer)",
              "main_path", k3),
        entry("mlstm_chunkwise_bwd", "mlstm_bwd.cu", "mlstm_pallas_bwd.py:255 (_kernel)",
              "train_path", k2),
        entry("mlstm_chunkwise_fwd", "mlstm_fwd.cu", "mlstm_pallas.py:198 (_kernel)",
              "lm_path", k1),
        entry("slstm_scan_fwd", "slstm.cu", "slstm_pallas.py:41 (_kernel)", "lm_path", k5),
        entry("slstm_scan_bwd", "slstm.cu", "slstm_pallas.py:153 (_bwd, jax.vjp of slstm_scan)",
              "lm_train_path", k5b),
        entry("vil_cell_fwd", "vil_layer.cu", "mlstm_pallas.py:532 (_kernel_vil_fused)",
              "cls_train", k4),
        entry("vil_block_fwd", "vil_layer.cu", "mlstm_pallas.py:799 (_kernel_vil_block)",
              "cls_block_entry", k7),
        entry("vil_layer_conv_fwd", "vil_layer.cu", "mlstm_pallas.py:1659 (_kernel_vil_conv)",
              "conv_path", k6),
        entry("rowwise_kth_value", "topk.cu", "topk_pallas.py:26 (_kth_kernel)", "kth_path", k8,
              library_ms=k8["library_ms"]),
        entry("vil_layer_fwd_bf16", "vil_layer.cu",
              "mlstm_pallas.py:1142 (_kernel_vil_layer, mxu_dtype=bfloat16)", "main_path_bf16",
              k3b, fp32=k3),
        entry("mlstm_chunkwise_bwd_bf16", "mlstm_bwd.cu",
              "mlstm_pallas_bwd.py:255 (_kernel, mxu_dtype=bfloat16)", "train_loop_amp", k2b,
              fp32=k2)]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
