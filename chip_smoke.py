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
  px, 1000 classes; head dim 64 here, stochastic depth 0.05 decayed over
  the depth), batch 64 of seeded images: one eval forward, and one train step
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
``fit_path_devaug`` trains the same way with ``device_augment=True`` (the
host only decodes and letterboxes; mosaic, affine, HSV and flip run on the
card, checked against the CPU on the same draws), then one epoch with
``multi_scale=True`` as well (each batch rescaled to one of 320-960 px).

ViL-YOLO above scale n (``vil_yolo{s,m,l,x}``, ViL widths up to DIM 640,
INNER 1280, 20 heads): one inference forward of each at batch 2 and 640
px, and one train step of ``vil_yolox``, each against the same model with
the plain versions forced in.

ViL models at the JAX package's own default head dims
(``vil_headdim_path``), the ViL kernels instantiated at head dims 4 to 32:
ViL-YOLO-n with ``qkv_block_size`` left out of its YAML rows (head dim 16:
fp32 inference, bf16 serving, an AMP step and an fp32 step),
``VisionLSTM2`` at its class default (head dim 4, 96 heads: eval, a
stochastic-depth step, the block-fused entry) and a YAML graph of the
fork's blocks from a ``VisionLSTM`` row; each against its plain-forced
twin. ``kernel_parity`` holds every kernel of the family at head dim 4 at
the classifier's shape and at 16 at P3 and P5, with bounds that count the
decay matrix.

The rest of the ViL family (``vil_family_path``): ViL-YOLO-n with its
three ViL rows as ``FusionViLLayerBlock [c, c, {mlp_type: swiglu}]`` (K3
at head dim 16 under a SwiGLU fusion MLP: fp32 inference, bf16 serving,
an fp32 step, each against its plain-forced twin) and as
``VilLayerUpdated [c, c, {num_heads: 4, chunk_size: 80}]`` (the
xLSTM-7B-style block, plain torch on the card as in JAX: inference against
the same model on the CPU, a train step, no kernel launch);
``HierarchicalVisionLSTM`` and ``VisionTransformer`` at their defaults,
batch 64 at 224 px (eval, and the hierarchical model's read-out backward,
each against its plain-forced twin or the CPU; the ViT's img/s beside
``VisionLSTM2``'s); and the layer (fp32, bf16), conv-fused and block-fused
kernels with the outnorm off against their plain versions, with a
``ViLBlockPair(use_outnorm=False, proj_bias=False)`` forward and backward.

The rest of the detect task (``detect_keys_path``): on wide, tall and
square PNGs, ``YOLO("vil_yolon.yaml").train`` one epoch with ``plots``,
``profile`` and ``mosaic_n=9`` (the trace's three step spans launch the
bf16 kernels only; the device's busy and idle ms read from it), rect
validation with ``save_json`` against the plain-forced run and beside
square validation's img/s, ``predict(classes=, agnostic_nms=)`` and the
same after ``fuse()``; K3 and K3 bf16 at the grids of its rect buckets and
at 28 x 40 and 14 x 20 against their plain versions.

xLSTM-7B (``xlstm7b_path``, ``xlstm_yolo_torch.nn.xlstm_large``) at the
published NX-AI widths (vocab 50304, embedding 4096, 32 blocks, 8 heads,
6.9 B parameters, fp32) on seeded weights drawn on the card: a forward at 8
x 512 tokens, a 512-token prefill and one carried-state step against a
from-scratch 513-token forward (the recurrent form), ``generate_scan``'s
CUDA-graph decode against eager ``generate`` over 64 greedy tokens; prefill
tokens/s and ms per decode token beside the bytes bound. Then YOLO11n
(``yolo11_path``): inference and a train step at batch 8, 640 px, and the
card against the CPU on the same weights. Neither launches a hand-written
kernel (the JAX package runs plain XLA there).

The rest of the detect zoo (``detect_zoo_path``, last): each of the 23
other detection YAMLs (YOLOv3 to YOLO12, ``ZOO``) at full width, built by
``TaskModel`` on the card with the JAX package's parameter count and
strides; fused ``Predictor`` inference and fp32 train steps at batch 8, 640
px, timed by stage, with forward TFLOP/s and peak memory; one model of each
block family against the CPU (candidates, and gradients on the discrete
choices of an fp64 step on the card; ``card_vs_cpu``);
``YOLO("yolov10n.yaml")`` predicting,
validating and embedding PNGs the phase writes. No hand-written kernel
runs (plain XLA in JAX).

The classify task (``classify_path``, last): K3 and K2 (fp32, bf16) at the
ViL classifier's grids at 224 px (S 784, 196, 49) against their plain
versions; yolo11n-cls at ImageNet-1k's configuration (1000 classes, 224 px,
batch 64: the JAX parameter count, fused ``Predictor`` inference on uint8
375 x 500 frames, fp32 and AMP steps); the other five ``-cls`` YAMLs at 1000
classes (one inference, one fp32 step); the ViL classifier
(``vil_yolo.yaml`` rows 0-9 at scale n under ``Classify``: fp32 inference,
bf16 serving, fp32 and AMP steps, each against its plain-forced twin; K3
and K2 three times a pass); three models against the CPU; and
``YOLO("yolo11n-cls.yaml")`` training, validating and predicting on PNG
class folders it writes, its first batch held to the hash the CPU tests
pin. Only the ViL classifier launches hand kernels (plain XLA for the six
YAMLs in JAX).

RT-DETR (``rtdetr_path``, last): rtdetr-l at COCO's configuration (80
classes, 640 px, batch 8) with the JAX parameter count: fused ``Predictor``
inference in fp32 (img/s, forward ms, device-busy ms) and bf16, the fp32
and AMP train steps with denoising queries, and the card against the CPU
at 320 px on one fp64 step's discrete choices (the query selection, the
deformable sampling's grid cells, the six Hungarian matches, HGStem's
max-pool argmax, the ReLUs' signs; the denoising draws made once for
both); rtdetr-x, the two ResNet RT-DETRs and yolov8-rtdetr at n (built,
one inference, timed fp32 steps); ``YOLO("rtdetr-l.yaml")`` training
an epoch without validation on PNGs it writes, predicting, saved and
reloaded to the same predictions, its ``val`` refused. No hand kernel runs
(plain XLA in JAX).

SAM and SAM2 (``sam_path``, last): SAM ViT-B at Segment Anything's
``build_sam_vit_b`` widths, 1024 px, on a uint8 540 x 810 frame with seeded
perturbed weights: ``SAMPredictor.set_image`` and ``predict`` (a point, a
box) split into host and device ms, the encoder alone at batch 8 (img/s,
TFLOP/s, device-busy ms), ``SAMAutoMaskGenerator.generate`` at its defaults
and at stride 8 with the thresholds off; vit_l, vit_h and mobile_sam built
with the JAX counts, one ``set_image`` and ``predict`` each; SAM2.1-tiny
through ``SAM2Predictor`` and ``SAM2VideoPredictor`` over 10 frames (the
ring buffer full from frame 7), TinyViT once; both families against the
CPU at 256 px, the video's ring state included. No hand kernel runs (plain
XLA in JAX).

Export and serving (``export_path``, last): ViL-YOLO-n as
``build_main_model`` builds it, batch 8, 640 px, through
``Exporter(format="pt2")`` (``torch.export`` with the ViL kernels as the
registered ops ``xlstm_yolo::vil_layer_fwd``): the fp32 program's 3 K3
nodes and 3 fp32 launches a call reloaded through ``AutoBackend``, against
the plain-forced model, timed beside eager ``predictions``; ``half=True``
(3 bf16 launches, against native bf16 serving by ``compare_bf16``);
``nms=True`` against ``non_max_suppression`` of the eager candidates;
yolo11n through the ``torch`` format and ``YOLO(pt)``; ``serve_model`` of
the fp32 program on localhost against ``RemoteModel``, ms a request;
``Model.benchmark``, ``profile_model``, ``profile_layers`` against
``FlopCounterMode``; ``autobatch_fit`` of the fp32 step (the fit's batch
and bytes, the measured peak of the batch it keeps within 0.6 of the
card's memory); two ``Model.tune`` iterations of one fp32 epoch.

The parallel stack (``parallel_path``, last; ``xlstm_yolo_torch/parallel``):
two data-parallel ranks share the card in a gloo world (gloo moves CUDA
tensors for all-reduce and broadcast, which dp needs; NCCL refuses two
ranks on one device), ViL-YOLO-n at 640 px, batch 2 a rank, one fp32 step
through ``TrainStep(mesh=...)`` (BatchNorm statistics and loss normalizers
over the global batch, gradients summed over dp) against one process on
the global batch of 4, the one process's TAL and max-pool choices replayed
in the ranks, which report through files; ViL-YOLO-l (2 pairs a ViL row)
switched by ``enable_pipeline`` to the stacked layout with pp 2 and no mesh
against the unstacked model on the same weights (candidates, and a step
with cuDNN held to its deterministic algorithms, gated at 1e-5 plus three
times the unstacked step's spread against itself: the CUDA backward of
max-pool and nearest upsampling adds with atomics); the
sequence-parallel mLSTM's three plain functions over 2 and 5 segments at
ViL-YOLO-n's P3 against the unsplit run; the MoEFFN graph of the JAX ep
trainer test at 640 px on the card against the CPU; ``Trainer.train`` in a
child process that torchrun's variables put in a one-rank NCCL world,
started once the dp ranks' timed steps are done (its own seconds are timed
inside it). K3 and K2 launch in every rank.

Multi-object tracking (``track_path``, last; ``xlstm_yolo_torch/trackers``):
24 PNG frames of 480 x 640 the phase writes (a seeded texture panned 3 px a
frame, four bright squares on straight paths) through
``YOLO("vil_yolo.yaml", scale="n").track`` at 640 px, fp32, with
``bytetrack.yaml`` and then ``botsort.yaml`` (camera motion by the numpy
``sparseOptFlow``), the detector shaped so that a few hundred scores an
image clear conf 0.1 (``track_detector``): K3 3 times a frame; each frame's
detections against the plain-forced ``Predictor`` (rows within TOL_REL of
conf set aside where the counts differ); both trackers again on the CPU on
the card's detections and frames, tracks identical; the squares' true
boxes with seeded noise through ``BOTSORT``, one id a square across the
pan and GMC's pan within 1.5 px of 3; the native val batches (a non-rect
loader at 640 and batch 16 against its Python collate, within one level,
host ms a batch of each) and ``Validator`` on them. ms a frame of the
predictor, the tracker and GMC.

Every phase prints one JSON line; then come the run's seconds, the
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
GATE_OPS = 4  # operations an entry of the chunkwise decay matrix (gate_matrix_ops)
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
# widths) at head dim 64 and stochastic depth on (cls_path); the same at the
# class's own default head dim, 4: 96 heads (vil_headdim_path)
CLS = dict(dim=192, depth=12, patch_size=16, output_shape=(1000,), mode="classifier",
           pooling="bilateral_flatten", qkv_block_size=64, chunk_size=64, bidirectional=False,
           drop_path_rate=0.05, drop_path_decay=True)
CLS_DEFAULT_DH = {**CLS, "qkv_block_size": 4}
CLS_BATCH, CLS_HW = 64, 224
# vil_headdim_path's YAML graph from the fork's blocks at the classifier's
# widths: the ViL backbone as one row (head dim 16, its block default), the
# partial after block 5 picked from its outputs, merged 2 x 2 in token space,
# back to a map, normed
GRAPH_YAML = {"nc": 1000, "backbone": [
    [-1, 1, "VisionLSTM", [3, 192, {"depth": 12, "resolution": [224, 224], "patch_size": 16,
                                    "output_indices": [5]}]],  # 0: [(B,192,14,14)] * 2
    [-1, 1, "FeatureSplitIndex", [0]],                             # 1: (B, 192, 14, 14)
    [-1, 1, "ImageToSequence", []],                                # 2: (B, 196, 192)
    [-1, 1, "PatchMerging", []],                                   # 3: (B, 49, 384)
    [-1, 1, "SequenceToImage", [[7, 7]]],                          # 4: (B, 384, 7, 7)
    [-1, 1, "ViLLayerNormBlock", [384]],                           # 5
]}
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
# and the sequence lengths multi_scale adds at its extremes: P3 at 960 px, P5 at 320 px
BF16_MS_CASES = [("P3_960px", 14400, 64, 128, 2, BATCH),
                 ("P5_320px", 100, 256, 512, 8, BATCH)]
BF16_BIG_BATCH = 128  # the JAX bf16 train bench's batch (bench_train.py): the bf16 entries' second time
# the ViL kernels at the JAX blocks' default head dims (vil_headdim_path): 4
# at the classifier's shape (96 heads), 16 at ViL-YOLO-n's P3 and P5
SMALL_DH_CASES = [("cls_DH4_S196", 196, 192, 384, 96, CLS_BATCH),
                  ("P3_DH16_S6400", 6400, 64, 128, 8, BATCH),
                  ("P5_DH16_S400", 400, 256, 512, 32, BATCH)]
FAMILY_CASES = [CLS_CASE, ("P3_S6400", 6400, 64, 128, 2, BATCH), X_P5_CASE]
# vil_family_path: ViL-YOLO-n's three ViL rows (scale n's widths written out: these
# blocks take their dim as written) as the fork's other ViL YAML blocks
FAMILY_ROWS = {"fusion": ("FusionViLLayerBlock", {"mlp_type": "swiglu"}),
               "large": ("VilLayerUpdated", {"num_heads": 4, "chunk_size": 80})}
YOLO_N_WIDTHS = (64, 128, 256)
HIER = dict(dims=(96, 192, 384), depths=(2, 2, 4), patch_size=4, qkv_block_size=16,
            chunk_size=64)  # HierarchicalVisionLSTM's class defaults
VIT = dict(dim=192, depth=12, num_heads=3, patch_size=16, num_classes=1000)  # its defaults
# the layer kernels with the outnorm off: ViL-YOLO-n's P3 at head dim 64 and its P5
# at 16 (K3 fp32 and bf16); K6 at the first, K7 at the second
NO_OUTNORM_CASES = [("P3_S6400", 6400, 64, 128, 2, BATCH),
                    ("P5_DH16_S400", 400, 256, 512, 32, BATCH)]
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


class Variant(NamedTuple):
    """A model YAML changed in memory: its dict, scale and printed label."""
    yaml: dict
    scale: str
    label: str


def model_label(cfg) -> str:
    return cfg.label if isinstance(cfg, Variant) else cfg


def yolo_default_headdim() -> Variant:
    """ViL-YOLO-n with ``qkv_block_size`` left out of its three ViL rows, as
    a user's YAML that does not set it: they take ViLBlockPairBlock's
    default head dim, 16 (P3 8 heads, P4 16, P5 32)."""
    import copy

    from xlstm_yolo_torch.cfg import load_model_yaml

    cfg, scale = load_model_yaml("vil_yolon.yaml")
    cfg = copy.deepcopy(cfg)
    for row in cfg["backbone"] + cfg.get("head", []):
        if row[2] == "ViLBlockPairBlock":
            for a in row[3]:
                if isinstance(a, dict):
                    a.pop("qkv_block_size", None)
    return Variant(cfg, scale, "vil_yolon.yaml without qkv_block_size (head dim 16)")


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
    (parameter list dropped), from torch.profiler: each kernel's largest
    reading over three sessions, since a session now and then loses events
    and reads low."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
            if us:
                name = e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
                per[name] = per.get(name, 0.0) + us / iters / 1e3
        for name, t in per.items():
            out[name] = max(out.get(name, 0.0), t)
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


def gate_matrix_ops(B, S, NH, passes: int = 1) -> float:
    """Operations of the per-head decay matrix of the chunkwise mLSTM: the
    causal half of a KERNEL_CS x KERNEL_CS matrix per chunk and head,
    GATE_OPS an entry (the log-decay sum, its exp, the product with q k^T
    and the mask), ``passes`` times (the backward builds it twice: E and
    dqk). Elementwise, so it counts at the fp32 CUDA-core rate in both
    bounds. At head dim 64 it is a few percent of the products and the
    bounds of the head-dim-64 cases leave it out; at 4 and 8 it is as much
    as the products, and the cases at those head dims count it
    (``gate_matrix``)."""
    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS

    return passes * B * S * NH * (KERNEL_CS + 1) / 2 * GATE_OPS


def vil_bound(kind, B, S, DIM, INNER, NH, n_weight_floats, gate_matrix: bool = False):
    """Least time for one call of the ViL family's ``kind`` ("cell", "block"
    or "layer"): the larger of its FLOPs over the fp32 peak and the bytes of
    its inputs, output and weights over the HBM rate. FLOPs count the work
    the CUDA function does per token. The cell: headwise q/k/v, the two gate
    dots, per head the causal half of the intra-chunk q k^T and E v products
    over the kernel's chunk length plus the inter-chunk q C and
    chunk-summary k v^T products; it reads conv_act and x_mlstm and writes
    h. The block adds proj_down and reads z and the residual too, writing
    (B, S, DIM). The layer adds proj_up (both halves) and reads only x and
    conv_act. Elementwise work (norms, exp, gating) is left out, but for
    the decay matrix with ``gate_matrix`` (``gate_matrix_ops``)."""
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
    return roofline(2 * B * S * macs, 4 * (B * S * floats + n_weight_floats),
                    elem_flops=gate_matrix_ops(B, S, NH) if gate_matrix else 0.0)


def conv_bound(B, S, DIM, INNER, NH, n_weight_floats, gate_matrix: bool = False):
    """Least time for one conv-fused layer call: the layer's operations
    (``vil_bound``) plus the nine multiply-adds per token and channel of the
    depthwise conv, against the bytes of x, out and the weights only."""
    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS

    dh = INNER // NH
    macs = (3 * INNER * dh + 6 * INNER * NH + NH * ((KERNEL_CS + 1) * dh + 2 * dh * dh)
            + 3 * INNER * DIM + 9 * INNER)
    return roofline(2 * B * S * macs, 4 * (2 * B * S * DIM + n_weight_floats),
                    elem_flops=gate_matrix_ops(B, S, NH) if gate_matrix else 0.0)


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
    # the port decodes PNG and BMP itself; JPEG needs cv2 or PIL; RT-DETR's
    # Hungarian match needs scipy
    found = {m: importable(m) for m in ("cv2", "PIL", "scipy")}
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


def nudged_weights(args):
    """Layer arguments with the weights (every one after x and conv_act)
    one fp32 ulp up: the plain version on them against itself is the bf16
    pipeline's own noise."""
    import torch

    return list(args[:2]) + [torch.nextafter(t, torch.full_like(t, float("inf")))
                             for t in args[2:]]


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


def grad_spread(grads_k, grads_p) -> dict:
    """Two measures of the gradients ``grads_k`` against ``grads_p`` that a
    few ill-conditioned entries do not rule: the largest error of any entry
    over the model's largest gradient (``abs_over_grad_max``), and the worst
    tensor's relative L2 error, ||k - p|| / ||p|| (``rel_l2``, its name
    ``rel_l2_worst``; a tensor that is zero up to rounding, below 1e-6 of the
    model's largest gradient, is left to the first measure)."""
    gmax = max(g.abs().max().item() for g in grads_p.values())
    absmax, rel_l2, worst = 0.0, 0.0, None
    for n, gp in grads_p.items():
        d = (grads_k[n] - gp).double()
        absmax = max(absmax, d.abs().max().item())
        if gp.abs().max().item() >= 1e-6 * gmax:
            r = (d.norm() / gp.double().norm()).item()
            if r > rel_l2:
                rel_l2, worst = r, n
    return {"abs_over_grad_max": absmax / gmax, "rel_l2": rel_l2, "rel_l2_worst": worst}


def bwd_bound(B, S, INNER, NH, gate_matrix: bool = False):
    """Least time for one chunkwise-backward call. FLOPs count the
    multiply-adds the CUDA function does per chunk and head of the
    (padded) sequence: six products over the causal half of the chunk
    (q k^T, E v, E^T dA, dA v^T, dqk k, dqk^T q: 3 CS (CS+1) DH) and five
    DH x DH products per token (q C, dA C^T, the dC_attn sum, and the
    carry's dv and dk terms: 5 CS DH^2), times 2 FLOPs; bytes count q, k,
    v, dh, the gates and the carry states read once and dq, dk, dv, di, df
    written once. Elementwise work (exp, norms, scans) is left out, but for
    the decay matrix, built twice, with ``gate_matrix``."""
    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS as CS

    dh = INNER // NH
    ns = -(-S // CS)
    macs = B * NH * ns * (3 * CS * (CS + 1) * dh + 5 * CS * dh * dh)
    return roofline(2 * macs, 4 * (7 * B * S * INNER + 4 * B * NH * S
                                   + B * NH * ns * (dh * dh + dh + 3)),
                    elem_flops=gate_matrix_ops(B, ns * CS, NH, 2) if gate_matrix else 0.0)


def bf16_vil_bound(B, S, DIM, INNER, NH, n_weight_floats, gate_matrix: bool = False):
    """Least time for one call of the bf16 layer kernel: its multiply-adds
    (``vil_bound``'s count for the layer) over the 989 TFLOP/s bf16
    tensor-core peak, against the bytes of x, conv_act and out at 2 bytes
    an activation and of the fp32 weights; ``tc_ms`` is the operations'
    time alone."""
    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS

    dh = INNER // NH
    macs = (3 * INNER * dh + 6 * INNER * NH + NH * ((KERNEL_CS + 1) * dh + 2 * dh * dh)
            + 3 * INNER * DIM)
    return bf16_bound(2 * B * S * macs, 2 * B * S * (2 * DIM + INNER) + 4 * n_weight_floats,
                      gate_matrix_ops(B, S, NH) if gate_matrix else 0.0)


def bf16_bwd_bound(B, S, INNER, NH, gate_matrix: bool = False):
    """Least time for one call of the bf16 chunkwise backward: ``bwd_bound``'s
    multiply-adds over the bf16 tensor-core peak, against its bytes with
    q, k, v, dq, dk, dv at 2 bytes and dh, the gates and the states at 4."""
    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS as CS

    dh = INNER // NH
    ns = -(-S // CS)
    macs = B * NH * ns * (3 * CS * (CS + 1) * dh + 5 * CS * dh * dh)
    return bf16_bound(2 * macs, 2 * 6 * B * S * INNER + 4 * (B * S * INNER + 4 * B * NH * S
                                                           + B * NH * ns * (dh * dh + dh + 3)),
                      gate_matrix_ops(B, ns * CS, NH, 2) if gate_matrix else 0.0)


def bf16_bound(flops, nbytes, elem_flops: float = 0.0):
    """The ``Bound`` of bf16 tensor-core work: ``ms`` the larger of the
    operations at PEAK_BF16_FLOPS (``elem_flops``, elementwise, at
    PEAK_FP32_FLOPS) and the bytes at PEAK_BYTES_PER_S, ``tc_ms`` the
    operations alone."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_BF16_FLOPS + elem_flops / PEAK_FP32_FLOPS) * 1e3
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


def roofline(flops, nbytes, products: bool = True, elem_flops: float = 0.0) -> Bound:
    """The ``Bound`` of ``flops`` operations (multiply-adds count two;
    ``products``: they are matrix products the tensor cores can take),
    ``elem_flops`` elementwise ones (the fp32 CUDA cores' in both bounds)
    and ``nbytes`` bytes moved."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_elem = elem_flops / PEAK_FP32_FLOPS * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3 + t_elem
    t_tc = (flops * TF32_PASSES / PEAK_TF32_FLOPS * 1e3 + t_elem) if products else t_ops
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
                  metric="max relative error", emit_line=None):
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
    names it in the printed lines. ``emit_line`` (default ``emit``) takes
    each case's line, so that a caller can add to it before it is printed."""
    cmp = compare if cmp is None else cmp
    emit_line = emit if emit_line is None else emit_line
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
        line = {"phase": "kernel_parity", "kernel": kernel, "case": case[0], **cross_ms,
                "shape": [batch_of(case), *case[1:5]],
                "maxrelerr_by_batch": {str(b): e[1] for b, e in errs.items()},
                "max_abs_err": abs_err, "maxrelerr": rel, "relerr_metric": metric, "tol": tol,
                "ok": ok,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd.ms, "bound_by": bnd.by,
                "bound_tc_ms": bnd.tc_ms, "bound_tc_by": bnd.tc_by,
                **(extra(case, ms) if extra else {})}
        if not ok:
            emit(line)
            raise PhaseError(f"{kernel} disagrees with its plain version at {case[0]}: "
                             f"maxrelerr {rel}")
        emit_line(line)
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
    lines = []
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
        lines.append({"phase": "kernel_parity", "kernel": "rowwise_kth_value", "case": name,
                      "shape": [R, N], "k": k, "exact": exact, "max_abs_err": abs_err,
                      "rows_below_k_distinct": below_k, "tol": 0.0, "ok": ok, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound.ms,
                      "bound_by": bound.by, "gb_per_s": 4 * R * N / ms / 1e6})
        if not ok:
            emit(lines[-1])
            raise PhaseError(f"rowwise_kth_value differs from its plain version at {name}: "
                             f"max abs err {abs_err}")
        worst_abs = max(worst_abs, abs_err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound.ms),
                         ("bound_tc_ms", bound.tc_ms), ("library_ms", library_ms)):
            totals[key] += val
    # the kernel's own device time, by the profiler, after every event time above
    # (a profiler session slows the host's launches after it)
    for line, (name, R, N, k, ties) in zip(lines, K8_CASES):
        x = kth_rows(R, N, ties, seed=R + N, device=device)
        dev_ms = sum(t for n, t in stage_device_ms(lambda: rowwise_kth_value(x, k)).items()
                     if "kth_value" in n)
        emit({**line, "device_ms": dev_ms,
              "bound_share": line["bound_ms"] / dev_ms if dev_ms else None})
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
    slstm_scan_bwd_plain) on K5's workspace at K5's shapes, with its reverse
    kernel's device time (profiler; it and K8's are taken after the event
    times of the host-paced cases, since a profiler session slows the host's
    launches after it);
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
    device time of each stage at both batches (``bf16_extra``); the same at
    BF16_MS_CASES, the sequence lengths of ``multi_scale``'s extremes
    (their lines only: the kernels line sums the P3-P5 cases)."""
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

    # the sLSTM backward's and K8's device times come from torch.profiler, after
    # which the host launches more slowly: their lines are printed once every
    # host-paced case of this phase is timed (K8's by kth_parity)
    k5b_lines = []
    k5b = kernel_parity(
        "slstm_scan_bwd", K5_CASES, scan_bwd_case,
        lambda args, case: slstm_scan_bwd(args[1], args[3], args[4], args[5]),
        lambda args, case: slstm_scan_bwd_plain(*args[:4], args[4][:, :, :, 4:SAVED].unbind(3),
                                                args[5]),
        lambda args, case: slstm_bwd_bound(BATCH, *case[1:]),
        extra=lambda case, ms: {"us_per_step": ms * 1e3 / case[2]}, emit_line=k5b_lines.append)
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
    for line, case in zip(k5b_lines, K5_CASES):  # the reverse kernel's own device time
        args = scan_bwd_case(BATCH, case)
        stages = stage_device_ms(lambda: slstm_scan_bwd(args[1], args[3], args[4], args[5]))
        dev_ms = sum(t for n, t in stages.items() if "slstm_bwd" in n)
        emit({**line, "device_ms": dev_ms, "device_us_per_step": dev_ms * 1e3 / case[2],
              "stage_device_ms": stages})


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
            fp32_ms = k["ms_by_case"].get(case[0])  # None at a case the fp32 kernel is not timed at
            out = {"fp32_ms": fp32_ms, "bf16_speedup": fp32_ms / ms if fp32_ms else None,
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
    plain_k3b = lambda args, case: (vil_layer_ref(*args, case[4], chunk_size=KERNEL_CS,
                                                  keep_fp32=True),)
    k3b, _ = (kernel_parity(
        "vil_layer_fwd_bf16", cases, bf16_layer_case, run_k3b, plain_k3b, bound_k3b,
        batch_of=timed_batch, cmp=compare_bf16,
        extra=bf16_extra(k3, bf16_layer_case, run_k3b, bound_k3b), metric=BF16_METRIC)
        for cases in (BF16_CASES, BF16_MS_CASES))

    def bf16_bwd_case(B, case):
        _, S, DIM, INNER, NH, _ = case
        a = bf16_layer_case(B, case)
        _, (_, q, k, v, ig, fg), carry = _launch(a, Cfg(NH), True)
        dh = torch.from_numpy(np.random.default_rng(S + B + 21).normal(
            size=(B, S, INNER)).astype(np.float32)).to(dev)
        return (q, k, v, ig, fg, dh), carry

    run_k2b = lambda args, case: mlstm_chunkwise_bwd(*args[0], case[4], carry=args[1])
    bound_k2b = lambda args, case: bf16_bwd_bound(case[5], case[1], case[3], case[4])
    plain_k2b = lambda args, case: mlstm_chunkwise_bwd_plain(*args[0], case[4], keep_fp32=True)
    k2b, _ = (kernel_parity(
        "mlstm_chunkwise_bwd_bf16", cases, bf16_bwd_case, run_k2b, plain_k2b, bound_k2b,
        batch_of=timed_batch, cmp=compare_bf16, tol=TOL_BF16_GRAD,
        extra=bf16_extra(k2, bf16_bwd_case, run_k2b, bound_k2b), metric=BF16_METRIC)
        for cases in (BF16_CASES, BF16_MS_CASES))

    # the JAX blocks' default head dims (SMALL_DH_CASES): each kernel of the
    # family, fp32 and bf16, against its plain version, with bounds that count
    # the decay matrix; their lines only (the kernels line sums the cases
    # above and lists these times by case)
    def dh_extra(make_case, run):
        """Beside each case: its head dim, and the device time of every
        kernel the call launches at the timed batch (torch.profiler)."""
        def extra(case, ms):
            args = make_case(case[5], case)
            stages = stage_device_ms(lambda: run(args, case))
            return {"head_dim": case[3] // case[4], "bound_counts_gate_matrix": True,
                    "device_ms": sum(stages.values()), "stage_device_ms": stages}
        return extra

    nw = lambda args, first: sum(a.numel() for a in args[first:])
    small_layer_case = lambda B, case: layer_args(B, *case[1:5], seed=case[1] + B + 30, device=dev)
    run_k3 = lambda args, case: (vil_layer_fwd(*args, case[4], chunk_size=CHUNK),)
    run_k2 = lambda args, case: mlstm_chunkwise_bwd(*args[0], case[4], carry=args[1])
    small_cell_case = lambda B, case: cell_of(block_case(B, case))
    run_k4 = lambda args, case: (vil_cell_fwd(*args, case[4], chunk_size=CHUNK),)
    run_k7 = lambda args, case: (vil_block_fwd(*args, case[4], chunk_size=CHUNK),)
    run_k6 = lambda args, case: (vil_layer_conv_fwd(*args, case[4], grid(case), chunk_size=CHUNK),)
    small = {
        "vil_layer_fwd": kernel_parity(
            "vil_layer_fwd", SMALL_DH_CASES, small_layer_case, run_k3,
            lambda args, case: (vil_layer_ref(*args, case[4], chunk_size=CHUNK),),
            lambda args, case: vil_bound("layer", case[5], *case[1:5], nw(args, 2),
                                         gate_matrix=True),
            batch_of=timed_batch, extra=dh_extra(small_layer_case, run_k3)),
        "mlstm_chunkwise_bwd": kernel_parity(
            "mlstm_chunkwise_bwd", SMALL_DH_CASES, bwd_case, run_k2,
            lambda args, case: mlstm_chunkwise_bwd_plain(*args[0], case[4]),
            lambda args, case: bwd_bound(case[5], case[1], case[3], case[4], gate_matrix=True),
            batch_of=timed_batch, extra=dh_extra(bwd_case, run_k2)),
        "vil_cell_fwd": kernel_parity(
            "vil_cell_fwd", SMALL_DH_CASES, small_cell_case, run_k4,
            lambda args, case: (vil_cell_plain(*args, case[4], chunk_size=CHUNK),),
            lambda args, case: vil_bound("cell", case[5], *case[1:5], nw(args, 2),
                                         gate_matrix=True),
            batch_of=timed_batch, extra=dh_extra(small_cell_case, run_k4)),
        "vil_block_fwd": kernel_parity(
            "vil_block_fwd", SMALL_DH_CASES, block_case, run_k7,
            lambda args, case: (vil_block_plain(*args, case[4], chunk_size=CHUNK),),
            lambda args, case: vil_bound("block", case[5], *case[1:5], nw(args, 4),
                                         gate_matrix=True),
            batch_of=timed_batch, extra=dh_extra(block_case, run_k7)),
        "vil_layer_conv_fwd": kernel_parity(
            "vil_layer_conv_fwd", SMALL_DH_CASES, conv_case, run_k6,
            lambda args, case: (vil_layer_conv_plain(*args, case[4], grid(case),
                                                     chunk_size=CHUNK),),
            lambda args, case: conv_bound(case[5], *case[1:5], nw(args, 1), gate_matrix=True),
            batch_of=timed_batch,
            extra=lambda case, ms: {**dh_extra(conv_case, run_k6)(case, ms),
                                    "grid": list(grid(case))}),
        "vil_layer_fwd_bf16": kernel_parity(
            "vil_layer_fwd_bf16", SMALL_DH_CASES, bf16_layer_case, run_k3b, plain_k3b,
            lambda args, case: bf16_vil_bound(case[5], *case[1:5], nw(args, 2), gate_matrix=True),
            batch_of=timed_batch, cmp=compare_bf16, extra=dh_extra(bf16_layer_case, run_k3b),
            metric=BF16_METRIC),
        "mlstm_chunkwise_bwd_bf16": kernel_parity(
            "mlstm_chunkwise_bwd_bf16", SMALL_DH_CASES, bf16_bwd_case, run_k2b, plain_k2b,
            lambda args, case: bf16_bwd_bound(case[5], case[1], case[3], case[4],
                                              gate_matrix=True),
            batch_of=timed_batch, cmp=compare_bf16, tol=TOL_BF16_GRAD,
            extra=dh_extra(bf16_bwd_case, run_k2b), metric=BF16_METRIC)}
    return k3, k2, k1, k5, k5b, k4, k7, k6, k8, k3b, k2b, small


def zero_class_biases(model):
    """The class convs' biases of the model's head set to 0 (``cv3_{i}_2``,
    both branches of an end-to-end head): detections clear the confidence
    threshold. Returns the model."""
    import torch

    det = getattr(model, f"l{model.parsed.head_index}")
    det = getattr(det, "detect", det)  # a segment, pose or OBB head's Detect
    with torch.no_grad():
        for name, m in det.named_children():
            if isinstance(m, torch.nn.Conv2d) and "cv3_" in name and name.endswith("_2"):
                m.bias.zero_()
    return model


def build_main_model(device, train: bool = False, cfg="vil_yolon.yaml"):
    """ViL-YOLO (scale n unless ``cfg`` names another, or a ``Variant`` of
    it) on ``device``: seeded
    init with the JAX scheme, then seeded gate kernels (zero at init;
    ``gate_std``), so the mLSTM gates vary along the sequence. For
    inference, zero class biases (detections clear the confidence
    threshold) and conv+BN folded; for training (``train``), the init class
    biases and separate BatchNorms, as a run starts."""
    import torch

    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn
    from xlstm_yolo_torch.nn.tasks import TaskModel
    from xlstm_yolo_torch.nn.vil import MatrixLSTMCell

    model = (TaskModel(cfg.yaml, scale=cfg.scale, device=device, seed=0)
             if isinstance(cfg, Variant) else TaskModel(cfg, device=device, seed=0))
    g = torch.Generator(device="cpu").manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MatrixLSTMCell):
                for lin in (m.igate, m.fgate):
                    std = gate_std(lin.weight.shape[1] // 3)
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * std)
    return model if train else fuse_conv_bn(zero_class_biases(model))


def timed_step(step, batch, losses=None):
    """Stage ms of TRAIN_TIMED train steps after TRAIN_WARMUP (CUDA events);
    each step's loss appended to ``losses`` when given."""
    import torch

    times = {"forward_loss": 0.0, "backward": 0.0, "update_ema": 0.0}
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
        if losses is not None:
            losses.append(float(total.detach()))
        if it >= TRAIN_WARMUP:
            for k, (a, b) in zip(times, zip(ev[:3], ev[1:])):
                times[k] += a.elapsed_time(b) / TRAIN_TIMED
    return times


def timed_inference(model, pred, raw, iters: int, warmup: int) -> dict:
    """Stage ms (letterbox, forward, decode and NMS) of ``pred``'s inference
    of the frames ``raw`` through ``model``, the mean of ``iters`` runs
    after ``warmup`` (CUDA events)."""
    import torch

    from xlstm_yolo_torch.nn.heads import decode_detections, det_maps

    times = {"letterbox": 0.0, "forward": 0.0, "decode_nms": 0.0}
    with torch.inference_mode():
        for it in range(warmup + iters):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            x, _ = pred.preprocess(raw)
            ev[1].record()
            maps = det_maps(model(x.permute(0, 3, 1, 2)))
            ev[2].record()
            pred.postprocess(decode_detections(maps, model.strides, model.nc, model.reg_max))
            ev[3].record()
            torch.cuda.synchronize()
            if it >= warmup:
                for k, (a, b) in zip(times, zip(ev[:3], ev[1:])):
                    times[k] += a.elapsed_time(b) / iters
    return times


def phase_main_path(cfg="vil_yolon.yaml", name: str = "main_path",
                    expected_launches: int = len(STAGES)):
    """``Predictor`` inference against the plain-forced model (``cfg`` as
    ``build_main_model`` takes it; ``name`` heads the printed line;
    ``expected_launches`` of the ViL layer kernel, one per ViL stage)."""
    import torch

    import xlstm_yolo_torch.nn.vil as vil_mod
    from xlstm_yolo_torch.engine.predictor import Predictor
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd, vil_layer_ref

    model = build_main_model("cuda", cfg=cfg)
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

    times = timed_inference(model, pred, raw, iters=10, warmup=2)
    total_ms = sum(times.values())
    ok = shapes_ok and finite and launches == expected_launches and box_rel <= TOL_REL \
        and score_abs <= TOL_REL and n_valid > 0
    emit({"phase": name, "model": model_label(cfg), "params_after_fuse": model.num_params(),
          "batch": BATCH, "src_hw": list(SRC_HW), "imgsz": IMGSZ, "launches": launches,
          "expected_launches": expected_launches, "shapes_ok": shapes_ok, "finite": finite,
          "cands_box_maxrelerr": box_rel, "cands_score_max_abs_err": score_abs,
          "valid_dets": n_valid, "ms": times, "total_ms": total_ms,
          "img_per_s": BATCH / total_ms * 1e3, "ok": ok})
    if not ok:
        raise PhaseError(f"{name} check failed")
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


def phase_train_path(cfg="vil_yolon.yaml", name: str = "train_path",
                     expected_launches: int = len(STAGES)):
    """One TrainStep with the kernels against the same step with the plain
    versions forced in (loss, and every parameter gradient within TOL_REL of
    that tensor's max), then TRAIN_TIMED steps after TRAIN_WARMUP timed by
    stage with CUDA events; ``expected_launches`` of the ViL layer kernel
    and of the chunkwise backward each, per step."""
    import torch

    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd

    batch = train_batch("cuda")
    steps = {}
    for kind in ("kernels", "plain"):
        model = build_main_model("cuda", train=True, cfg=cfg)
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

    losses = [loss_k]
    vil_layer_fwd.launches = mlstm_chunkwise_bwd.launches = 0
    times = timed_step(step, batch, losses)
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    per_step = (vil_layer_fwd.launches / n_steps, mlstm_chunkwise_bwd.launches / n_steps)
    total_ms = sum(times.values())
    finite = all(np.isfinite(losses)) and grads_finite
    expect = (expected_launches, expected_launches)
    ok = (finite and launches == expect and per_step == expect and plain_launches == (0, 0)
          and worst_rel <= TOL_REL and loss_rel <= TOL_REL)
    emit({"phase": name, "model": model_label(cfg), "batch": BATCH, "imgsz": IMGSZ,
          "labels": N_LABELS, "launches_vil_layer_fwd": launches[0],
          "launches_mlstm_chunkwise_bwd": launches[1], "launches_per_timed_step": per_step,
          "expected_launches": expect, "loss": loss_k, "loss_plain": loss_p,
          "loss_relerr": loss_rel, "loss_terms": aux, "grad_maxrelerr": worst_rel,
          "grad_worst": worst_name, "grads_vanishing": vanishing, "grad_max": gmax,
          "losses": losses, "finite": finite, "ms": times, "total_ms": total_ms,
          "img_per_s": BATCH / total_ms * 1e3, "ok": ok})
    if not ok:
        raise PhaseError(f"{name} check failed")
    return launches


def phase_main_path_bf16(cfg="vil_yolon.yaml", name: str = "main_path_bf16"):
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

    model = build_main_model("cuda", cfg=cfg)
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

    times = timed_inference(model, pred, raw, iters=10, warmup=2)
    total_ms = sum(times.values())
    ok = (shapes_ok and finite and bf16_params and launches == (0, len(STAGES)) and n_valid > 0
          and box_rel <= TOL_REL and score_abs <= TOL_REL)
    emit({"phase": name, "model": model_label(cfg), "batch": BATCH,
          "src_hw": list(SRC_HW), "imgsz": IMGSZ, "params_dtype": "bfloat16",
          "launches_vil_layer_fwd": launches[0], "launches_vil_layer_fwd_bf16": launches[1],
          "expected_launches": [0, len(STAGES)], "shapes_ok": shapes_ok, "finite": finite,
          "cands_box_maxrelerr": box_rel, "cands_box_fp32_gap": box_gap,
          "cands_score_max_abs_err": score_abs, "cands_score_fp32_gap": score_gap,
          "valid_dets": n_valid, "ms": times, "total_ms": total_ms,
          "img_per_s": BATCH / total_ms * 1e3, "ok": ok})
    if not ok:
        raise PhaseError(f"{name} check failed")
    return launches[1]


def phase_train_loop_amp(cfg="vil_yolon.yaml", name: str = "train_loop_amp",
                         loop: bool = True):
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
    n_updates exactly. ``loop=False``: (a) alone (``cfg`` and ``name`` as
    ``phase_main_path`` takes them)."""
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
        model = build_main_model("cuda", train=True, cfg=cfg)
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
    first_step = {"launches": dict(zip(("vil_layer_fwd", "vil_layer_fwd_bf16",
                                        "mlstm_chunkwise_bwd", "mlstm_chunkwise_bwd_bf16"),
                                       launches)),
                  "loss": loss_k, "loss_plain": loss_p, "loss_plain_fp32": loss_32,
                  "loss_relerr": loss_rel, "loss_terms": aux, "grad_dist": dist,
                  "grad_dist_fp32_gap": gap, "grad_worst_tensor_relerr": worst_rel,
                  "grad_worst": worst_name, "grads_vanishing": vanishing,
                  "grads_fp32": grads_fp32, "vil_layers": layers, "ok": first_ok}
    if not loop:
        emit({"phase": name, "model": model_label(cfg), "batch": BATCH, "imgsz": IMGSZ,
              "first_step": first_step, "ok": first_ok})
        if not first_ok:
            raise PhaseError(f"{name} check failed")
        return {"vil_layer_fwd_bf16": launches[1], "mlstm_chunkwise_bwd_bf16": launches[3]}

    model = build_main_model("cuda", train=True, cfg=cfg)
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
    emit({"phase": name, "model": model_label(cfg), "batch": BATCH, "imgsz": IMGSZ,
          "optimizer": step.update.name, "accumulate": 2, "first_step": first_step,
          "fit_steps": {"steps": log, "launches": list(loop_launches), "peak_memory_gib":
                        loop_peak_gib, "ok": loop_ok},
          "ms": times, "total_ms": total_ms, "img_per_s": BATCH / total_ms * 1e3,
          "checkpoint": {"same_weights": same_weights, "same_optimizer_state": same_state,
                         "ok": ckpt_ok}, "ok": ok})
    if not ok:
        raise PhaseError(f"{name} check failed")
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


def write_own_labels(model, data, imgsz: int = IMGSZ, seed: int = 3, rect: bool = False) -> int:
    """The model's own detections on ``data``'s val images (multi-label,
    conf 0.05, up to 300 an image, as many as validation keeps; with
    ``rect`` at the rect buckets), jittered so that their IoU with the
    detections varies, written as the val labels; returns the count."""
    import torch

    from xlstm_yolo_torch.data.dataset import build_dataloader
    from xlstm_yolo_torch.ops.nms import non_max_suppression

    loader, _ = build_dataloader(data, "val", batch=BATCH, imgsz=imgsz, augment=False, rect=rect)
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
            # the loader's long-side resize, not scaled up by the letterbox, which pads
            in_h, in_w = batch["img"].shape[1:3]
            r = min(imgsz / max(h0, w0), in_h / h0, in_w / w0)
            pad = ((in_w - w0 * r) / 2, (in_h - h0 * r) / 2)
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
                mark[kind] = kernel_counters()
                if kind == "train":
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[0].record()
                    events.append(ev)
            return fn

        def end(kind, out):
            def fn(obj):
                out.append(kernel_counters() - mark[kind])
                if kind == "train":
                    events[-1][1].record()
            return fn

        model.add_callback("on_train_batch_start", start("train"))
        model.add_callback("on_train_batch_end", end("train", steps))
        model.add_callback("on_val_batch_start", start("val"))
        model.add_callback("on_val_batch_end", end("val", val_batches))
        model.add_callback("on_train_epoch_end",
                           lambda tr: host_s.append(list(tr.loader.batch_seconds)))
        zero_kernel_counters()
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
        fit_launches = dict(zip(COUNTED, kernel_counters().tolist()))

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
    summary = {"epoch_img_s": [float(r["img_s"]) for r in rows],
               "host_batch_ms_mean": float(np.mean(host_ms)),
               "step_ms_mean": float(np.mean(step_ms)), "stage_ms": times}
    return {k: v for k, v in fit_launches.items() if v}, summary


COUNTED = ("vil_layer_fwd", "vil_layer_fwd_bf16", "mlstm_chunkwise_bwd",
           "mlstm_chunkwise_bwd_bf16")


def kernel_counters():
    """The launch counts of ``COUNTED``: the ViL layer kernel and the
    chunkwise backward, fp32 and bf16."""
    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd

    return np.array([vil_layer_fwd.launches, vil_layer_fwd.launches_bf16,
                     mlstm_chunkwise_bwd.launches, mlstm_chunkwise_bwd.launches_bf16])


def zero_kernel_counters():
    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd

    vil_layer_fwd.launches = vil_layer_fwd.launches_bf16 = 0
    mlstm_chunkwise_bwd.launches = mlstm_chunkwise_bwd.launches_bf16 = 0


@contextmanager
def uncounted():
    """Launches of ``COUNTED`` inside compare a kernel with its plain version
    in the middle of a path: the counts are put back as they were."""
    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd

    saved = [int(v) for v in kernel_counters()]
    try:
        yield
    finally:
        (vil_layer_fwd.launches, vil_layer_fwd.launches_bf16, mlstm_chunkwise_bwd.launches,
         mlstm_chunkwise_bwd.launches_bf16) = saved


@contextmanager
def recording_steps(record):
    """Each ``TrainStep`` call of the run: its image size, its kernel
    launches, CUDA events around the call and its loss (a tensor on the card,
    read after the run)."""
    import torch

    from xlstm_yolo_torch.engine.trainer import TrainStep

    call = TrainStep.__call__

    def recorded(self, batch, lr=None):
        before = kernel_counters()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = call(self, batch, lr)
        ev[1].record()
        record.append((int(batch["img"].shape[1]), kernel_counters() - before, ev, out[0]))
        return out

    with mock.patch.object(TrainStep, "__call__", recorded):
        yield


def phase_fit_path_devaug(smi_line, fit):
    """``fit_path`` with the augmentation on the card (``device_augment``)
    on the same PNG set, and ``multi_scale`` with it. (a)
    ``YOLO("vil_yolon.yaml").train(data, epochs=2, batch=8, imgsz=640,
    close_mosaic=1, device_augment=True)`` at ``fit_path``'s defaults: the
    host only decodes and letterboxes (in file order, the last partial
    batch kept), each step mosaics, warps, jitters and flips its batch on
    the card. Gates: the CSV's rows with finite losses; per step 3 launches
    each of the bf16 layer and backward kernels and none of the fp32 ones
    (counted around each step call);
    one step's augmented batch on the card equal to ``device_augment.apply``
    on the CPU given the same draws (images within 0.1 of 255, boxes within
    1e-3 px where the mask is set, masks equal: the CPU test's tolerances).
    Printed beside ``fit``, ``fit_path``'s numbers from this call: the
    epochs' img/s, the host's ms a batch (the loader's own clock), the
    step's ms on the card (CUDA events at its callbacks), the trained step's
    stages, and the augmentation's own device ms a step (CUDA events) and
    its kernel launches a step (torch.profiler, taken last). (b) One epoch
    with ``multi_scale=True`` as well (no validation): at least two sizes
    used, each a multiple of 32, finite losses, 3 + 3 bf16 launches a step
    at every size; each size's step ms (CUDA events around the step call)."""
    import csv
    import tempfile

    import torch

    from xlstm_yolo_torch import YOLO
    from xlstm_yolo_torch.data import device_augment as DA
    from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset

    n = len(STAGES)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_dataset(f"{tmp}/ds", n_train=FIT_IMAGES[0], n_val=FIT_IMAGES[1],
                                      width=FIT_WH[0], height=FIT_WH[1], seed=0)
        # (a) two epochs, the mosaic closed for the second
        model, steps, host_s, events = YOLO("vil_yolon.yaml"), [], [], []

        def start(_):
            events.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
            events[-1][0].record()

        model.add_callback("on_train_batch_start", start)
        model.add_callback("on_train_batch_end", lambda _: events[-1][1].record())
        model.add_callback("on_train_epoch_end",
                           lambda tr: host_s.append(list(tr.loader.batch_seconds)))
        zero_kernel_counters()
        t0 = time.perf_counter()
        with recording_steps(steps):
            model.train(data=data, epochs=FIT_EPOCHS, batch=BATCH, imgsz=IMGSZ, seed=0,
                        close_mosaic=1, device_augment=True, project=f"{tmp}/runs", name="devaug")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches_a = kernel_counters()
        trainer = model.trainer
        with open(Path(trainer.save_dir) / "results.csv") as f:
            rows = list(csv.DictReader(f))
        step_ms = [a.elapsed_time(b) for a, b in events]
        host_ms = [1e3 * t for epoch in host_s for t in epoch]
        per_step = {tuple(c.tolist()) for _, c, _, _ in steps}

        # the trained step's stages on one batch of the loader, the augmentation apart
        step = trainer.step
        batch = trainer._to_device(next(iter(trainer.loader)))
        normed = {**batch, "img": batch["img"].float() / 255.0}
        names = ("augment", "forward_loss", "backward", "update_ema")
        times = dict.fromkeys(names, 0.0)
        for it in range(TRAIN_WARMUP + TRAIN_TIMED):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            step.augment_batch(normed)
            ev[1].record()
            total, _ = step.forward_loss(batch)  # the augmentation again, inside
            ev[2].record()
            step.backward(total)
            ev[3].record()
            step.apply_update(float(rows[-1]["lr"]))
            ev[4].record()
            torch.cuda.synchronize()
            if it >= TRAIN_WARMUP:
                for k, (a, b) in zip(names, zip(ev[:4], ev[1:])):
                    times[k] += a.elapsed_time(b) / TRAIN_TIMED

        # one step's augmented batch on the card against the CPU, the same draws
        B, S = normed["img"].shape[:2]
        d = step.augment_draws(B, S, normed["img"].device)
        args = (normed["img"] * 255.0, normed["cls_boxes"], normed["mask"])
        card = DA.apply(*args, d, step.augment)
        cpu = DA.apply(*(t.cpu() for t in args), d.to("cpu"), step.augment)
        card = [t.cpu() for t in card]
        img_err = float((card[0] - cpu[0]).abs().max())
        mask_eq = bool(torch.equal(card[2], cpu[2]))
        box_err = float((card[1] - cpu[1])[cpu[2]].abs().max()) if cpu[2].any() else 0.0
        aug_ok = img_err <= 0.1 and box_err <= 1e-3 and mask_eq
        fit_ok = (len(rows) == FIT_EPOCHS and all(np.isfinite(float(r["train/loss"])) for r in rows)
                  and len(steps) == FIT_EPOCHS * -(-FIT_IMAGES[0] // BATCH)
                  and per_step == {(0, n, 0, n)}
                  and all(np.isfinite(float(loss)) for *_, loss in steps))

        # (b) one epoch at a size drawn a batch
        ms_steps = []
        zero_kernel_counters()
        with recording_steps(ms_steps):
            YOLO("vil_yolon.yaml").train(data=data, epochs=1, batch=BATCH, imgsz=IMGSZ, seed=0,
                                         multi_scale=True, device_augment=True, val=False,
                                         project=f"{tmp}/runs", name="ms")
        torch.cuda.synchronize()
        launches_b = kernel_counters()
        by_size = {}
        for size, c, (a, b), loss in ms_steps:
            by_size.setdefault(size, []).append((a.elapsed_time(b), tuple(c.tolist()),
                                                 float(loss)))
        ms_ok = (len(by_size) >= 2 and all(sz % 32 == 0 for sz in by_size)
                 and all(np.isfinite(loss) and c == (0, n, 0, n)
                         for v in by_size.values() for _, c, loss in v))

        # the augmentation's kernels a step, by the profiler (last: a profiler
        # session slows the host's launches after it)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            step.augment_batch(normed)
            torch.cuda.synchronize()
        aug_kernels = sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.key.startswith(("Memcpy", "Memset")))
    ok = fit_ok and aug_ok and ms_ok
    launches = dict(zip(COUNTED, (launches_a + launches_b).tolist()))
    emit({"phase": "fit_path_devaug", "model": "vil_yolon.yaml", "card": smi_line,
          "epochs": FIT_EPOCHS, "batch": BATCH, "imgsz": IMGSZ, "close_mosaic": 1,
          "device_augment": True, "csv": rows, "train_s": train_s,
          "epoch_img_s": [float(r["img_s"]) for r in rows],
          "val_img_s": [float(r["metrics/img_s"]) for r in rows],
          "step_ms": {"mean": float(np.mean(step_ms)), "median": float(np.median(step_ms)),
                      "n": len(step_ms)},
          "host_batch_ms": {"mean": float(np.mean(host_ms)), "median": float(np.median(host_ms)),
                            "n": len(host_ms)},
          "stage_ms": times, "stage_total_ms": sum(times.values()) - times["augment"],
          "augment_ms": times["augment"], "augment_kernels_per_step": aug_kernels,
          "launches_per_step": sorted(per_step),
          "augment_card_vs_cpu": {"img_max_abs": img_err, "box_max_abs": box_err,
                                  "masks_equal": mask_eq, "ok": aug_ok},
          "multi_scale": {"sizes": sorted(by_size), "ok": ms_ok, "by_size": {
              str(sz): {"steps": len(v), "step_ms_mean": float(np.mean([t for t, _, _ in v])),
                        "launches_per_step": sorted({c for _, c, _ in v}),
                        "losses": [loss for _, _, loss in v]}
              for sz, v in sorted(by_size.items())}},
          "fit_path_same_call": fit, "launches": launches,
          "phase_s": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError("fit path with device augmentation check failed")
    return {k: v for k, v in launches.items() if v}


# detect_keys_path: wide, tall and square PNGs (w, h, train, val), 8 train images each:
# 3 steps an epoch at batch 8; 8 + 6 + 8 val images: rect buckets of 8, 8 and a partial 6
KEYS_SETS = [("wide", (640, 360), 8, 8), ("square", (480, 480), 8, 6), ("tall", (360, 640), 8, 8)]
# K3 at the rect grids of bucket (448, 640), beside those of the phase's own buckets
# (rect_cases): P4 28 x 40, P5 14 x 20 (name, S, DIM, INNER, NH)
RECT_GRIDS_448 = [("P4_28x40", 28 * 40, 128, 256, 4), ("P5_14x20", 14 * 20, 256, 512, 8)]


def shapes_dataset(root: str) -> dict:
    """``make_synthetic_dataset`` once for each of KEYS_SETS under ``root``,
    joined in one dataset dict (its splits lists of directories)."""
    from xlstm_yolo_torch.data.synthetic import CLASSES, make_synthetic_dataset

    for i, (name, (w, h), n_train, n_val) in enumerate(KEYS_SETS):
        make_synthetic_dataset(f"{root}/{name}", n_train=n_train, n_val=n_val, width=w, height=h,
                               seed=i)
    return {"path": root, "names": dict(enumerate(CLASSES)),
            "train": [f"{n}/images/train" for n, *_ in KEYS_SETS],
            "val": [f"{n}/images/val" for n, *_ in KEYS_SETS]}


def rect_cases(loader) -> list:
    """K3's calls at a rect loader's batches: for each batch (its size B,
    its bucket (h, w)) and each of STAGES at stride 8, 16, 32, the grid (h /
    s, w / s); the kernel sees only (B, S = h * w / s^2), so grids of one
    (level, B, S), a bucket and its portrait twin, are one case. [(name, B,
    S, DIM, INNER, NH, grids)], then RECT_GRIDS_448 at BATCH."""
    cases = {}
    for idx, (h, w) in loader.rect_batches():
        for i, (level, _, DIM, INNER, NH) in enumerate(STAGES):
            gh, gw = h // (8 << i), w // (8 << i)
            key = (level, len(idx), gh * gw)
            cases.setdefault(key, (DIM, INNER, NH, []))[3].append(f"{gh}x{gw}")
    out = [(f"{level}_{grids[0]}_b{B}", B, S, DIM, INNER, NH, sorted(set(grids)))
           for (level, B, S), (DIM, INNER, NH, grids) in cases.items()]
    return out + [(name, BATCH, S, DIM, INNER, NH, [name.split("_")[1]])
                  for name, S, DIM, INNER, NH in RECT_GRIDS_448]


def match_err(xs, ys) -> list:
    """[px, score]: the largest gap from each box of ``xs`` (per image, (n,
    6) arrays: xyxy, conf, cls) to its nearest box of ``ys`` in the same
    image; inf when an image's counts differ."""
    err = [0.0, 0.0]
    for a, b in zip(xs, ys, strict=True):
        if len(a) != len(b):
            return [float("inf")] * 2
        if len(a):
            d = np.abs(a[:, None, :4] - b[None, :, :4]).max(-1)
            j = d.argmin(1)
            err = [max(err[0], float(d.min(1).max())),
                   max(err[1], float(np.abs(a[:, 4] - b[j, 4]).max()))]
    return err


def phase_detect_keys_path(smi_line):
    """The rest of the detect task, on wide, tall and square PNGs
    (KEYS_SETS). (a) ``YOLO("vil_yolon.yaml").train(data, epochs=1, batch=8,
    imgsz=640, plots=True, profile=True, mosaic_n=9)``: the trace holds
    three ``train_step`` spans, each launching the bf16 layer kernel's and
    the bf16 backward's stages and none of the fp32 ones (by kernel name);
    the device's busy and idle ms over those steps, read from the trace;
    whether the last validation's PNGs were written (the warning when
    not). (b) ``Validator(rect=True, save_json=True)`` of
    ``shaped_detector`` on the val images labelled with its own jittered
    detections at the rect buckets, with the kernels and with the plain
    versions forced in: 3 fp32 layer launches a batch and none plain, mAP50
    and mAP50-95 within 1e-3, mAP50-95 in [0.2, 0.95], the same number of
    JSON records; the bucket shapes; rect and square validation's img/s on
    the same images, in turns (square, rect, rect, square). (c)
    ``YOLO(w.pt).predict(val, agnostic_nms=True)``: at least one box in
    every image, each inside its image; ``classes=[c]`` for the class the
    head predicts most there: exactly those predictions' class-c boxes,
    at least one an image on average (the filter acts after NMS); ``fuse()``
    then the unfiltered predictions again, within 1e-3 px and 1e-4 in score.
    First, apart, K3 and K3 bf16 at the grids the rect validation gives
    them (``rect_cases`` of its loader) and at RECT_GRIDS_448, against their
    plain versions (``rect_ms_by_case``); the path's launches are counted
    over (a)-(c) from counters set to 0 just before."""
    import contextlib
    import io
    import tempfile

    import torch

    import xlstm_yolo_torch.kernels.mlstm_bwd as K2
    import xlstm_yolo_torch.kernels.vil_layer as K3
    from xlstm_yolo_torch import YOLO
    from xlstm_yolo_torch.data.dataset import build_dataloader
    from xlstm_yolo_torch.engine.trainer import read_step_trace
    from xlstm_yolo_torch.engine.validator import Validator
    from xlstm_yolo_torch.utils.checkpoint import save_checkpoint
    from xlstm_yolo_torch.utils.plotting import have_matplotlib

    n = len(STAGES)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = shapes_dataset(f"{tmp}/ds")
        # the rect validation's batches: the buckets, and K3's grids and batch sizes there
        rect_loader = build_dataloader(data, "val", batch=BATCH, imgsz=IMGSZ, rect=True)[0]
        buckets = [[len(idx), *hw] for idx, hw in rect_loader.rect_batches()]
        # K3 and K3 bf16 at those grids against their plain versions, not counted; timed
        # before the path runs, as kernel_parity times the kernels before the other phases
        rect = {}
        for case, B, S, DIM, INNER, NH, grids in rect_cases(rect_loader):
            a = layer_args(B, S, DIM, INNER, NH, seed=S + 31, device="cuda")
            b16 = [a[0].bfloat16(), a[1].bfloat16(), *a[2:]]
            nw = sum(t.numel() for t in a[2:])
            for kind, args, plain, cmp, bound in (
                    ("vil_layer_fwd", a, lambda: K3.vil_layer_ref(*a, NH, chunk_size=CHUNK),
                     compare, vil_bound("layer", B, S, DIM, INNER, NH, nw)),
                    ("vil_layer_fwd_bf16", b16,
                     lambda: K3.vil_layer_ref(*b16, NH, chunk_size=K2.KERNEL_CS, keep_fp32=True),
                     compare_bf16, bf16_vil_bound(B, S, DIM, INNER, NH, nw))):
                with torch.inference_mode():
                    got_k, want_k = K3.vil_layer_fwd(*args, NH), plain()
                    err, floor = cmp(got_k, want_k), None
                    ok = err[1] <= TOL_REL and err[2]
                    if cmp is compare_bf16:
                        # the largest error beyond rounding within BF16_MAX_EXCESS of the max
                        # or twice the plain version's own on weights one ulp apart, as the
                        # card test holds the bf16 gradients (tools/bf16_fwd_spread.py)
                        floor = compare_bf16(K3.vil_layer_ref(
                            *nudged_weights(args), NH, chunk_size=K2.KERNEL_CS,
                            keep_fp32=True).bfloat16(), want_k)[0]
                        ok = (err[1] <= TOL_REL and bool(torch.isfinite(got_k).all())
                              and err[0] <= max(BF16_MAX_EXCESS * want_k.abs().max().item(),
                                                2 * floor))
                    rect.setdefault(kind, {})[case] = {
                        "B": B, "S": S, "grids": grids, "max_abs_err": err[0],
                        "floor_abs_err": floor, "rel_err": err[1], "ok": bool(ok),
                        "ms": cuda_time_ms(lambda: K3.vil_layer_fwd(*args, NH), iters=20),
                        "plain_ms": cuda_time_ms(plain, iters=3, warmup=1),
                        "bound_ms": bound.ms, "bound_by": bound.by}
            del a, b16, got_k, want_k
        zero_kernel_counters()
        # (a) one epoch: 24 images at batch 8, mosaics of nine, the first 3 steps traced
        model, steps = YOLO("vil_yolon.yaml"), []
        out = io.StringIO()
        t0 = time.perf_counter()
        with recording_steps(steps), contextlib.redirect_stdout(out):
            model.train(data=data, epochs=1, batch=BATCH, imgsz=IMGSZ, seed=0, close_mosaic=0,
                        plots=True, profile=True, mosaic_n=9, project=f"{tmp}/runs", name="keys")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        log = out.getvalue()
        print(log, end="")
        trainer = model.trainer
        tr = read_step_trace(trainer.trace.path)
        trace_mb = trainer.trace.path.stat().st_size / 2**20
        names = [[k["name"] for k in ks] for ks in tr["steps"]]
        has = lambda ks, keys: any(any(key in k for key in keys) for k in ks)
        span_ok = tr["spans"] == 3 and all(
            has(ks, (K3.STAGES_BF16,)) and has(ks, (K2.STAGES_BF16,))
            and not has(ks, K3.STAGES + K2.STAGES)
            for ks in names)
        pngs = sorted(p.name for p in Path(trainer.save_dir).glob("*.png"))
        warning = next((ln for ln in log.splitlines() if ln.startswith("WARNING: plots")), None)
        plots_ok = (len(pngs) == 6) if have_matplotlib() else (warning is not None and not pngs)
        per_step = {tuple(c.tolist()) for _, c, _, _ in steps}
        train_ok = (span_ok and plots_ok and per_step == {(0, n, 0, n)} and len(steps) == 3
                    and all(np.isfinite(float(loss)) for *_, loss in steps))

        # (b) rect validation of a detector that is not degenerate, kernels and plain
        shaped = shaped_detector("cuda")
        n_labels = write_own_labels(shaped, data, rect=True)
        val, counts = {}, {}
        for kind in ("kernels", "plain"):
            before = kernel_counters()
            with plain_vil_kernels() if kind == "plain" else nullcontext():
                val[kind] = Validator(shaped, imgsz=IMGSZ, batch=BATCH, max_labels=320, rect=True,
                                      save_json=True, save_dir=f"{tmp}/val_{kind}")(data)
            counts[kind] = (kernel_counters() - before).tolist()
        img_s = {"square": [], "rect": []}  # in turns: square, rect, rect, square
        for kind in ("square", "rect", "rect", "square"):
            img_s[kind].append(Validator(shaped, imgsz=IMGSZ, batch=BATCH, max_labels=320,
                                         rect=kind == "rect")(data)["img_s"])
        torch.cuda.synchronize()
        recs = {k: len(json.loads(Path(val[k]["save_json_path"]).read_text()))
                for k in ("kernels", "plain")}
        map_err = max(abs(val["kernels"][k] - val["plain"][k]) for k in ("mAP50", "mAP50-95"))
        val_ok = (counts["kernels"] == [n * len(buckets), 0, 0, 0]
                  and counts["plain"] == [0, 0, 0, 0] and map_err <= 1e-3
                  and recs["kernels"] == recs["plain"] > 0
                  and 0.2 <= val["kernels"]["mAP50-95"] <= 0.95
                  and val["kernels"]["images"] == sum(v for *_, v in KEYS_SETS))

        # (c) predict with class-agnostic NMS; then only the class the head predicts most,
        # which must be exactly that class's boxes of the first; then fused
        w = YOLO(save_checkpoint(f"{tmp}/w.pt", shaped))
        files = sorted(Path(f"{tmp}/ds").glob("*/images/val/*.png"))
        kw = dict(imgsz=IMGSZ, conf=0.001, agnostic_nms=True, verbose=False)
        before = kernel_counters()
        res = w.predict(files, **kw)
        every, shapes = [r.boxes.data for r in res], [r.orig_shape for r in res]
        pred_counts = (kernel_counters() - before).tolist()
        by_cls = np.bincount(np.concatenate(every)[:, 5].astype(int), minlength=shaped.nc)
        top = int(by_cls.argmax())
        got = w.predict(files, classes=[top], **kw)
        fused = [r.boxes.data for r in w.fuse().predict(files, **kw)]
        torch.cuda.synchronize()
        launches = dict(zip(COUNTED, kernel_counters().tolist()))
        inside = all(((d[:, :4] >= 0).all() and (d[:, [0, 2]] <= hw[1]).all()
                      and (d[:, [1, 3]] <= hw[0]).all()) for d, hw in zip(every, shapes))
        n_top = sum(len(r) for r in got)
        class_err = match_err([r.boxes.data for r in got], [d[d[:, 5] == top] for d in every])
        fuse_err = match_err(fused, every)
        predict_ok = (min(map(len, every)) >= 1 and inside and n_top >= len(files)
                      and all((r.boxes.cls == top).all() for r in got)
                      and class_err[0] <= 1e-3 and class_err[1] <= 1e-4
                      and pred_counts == [n * len(files), 0, 0, 0]
                      and fuse_err[0] <= 1e-3 and fuse_err[1] <= 1e-4)

    rect_ok = all(c["ok"] for by_case in rect.values() for c in by_case.values())
    ok = train_ok and val_ok and predict_ok and rect_ok
    emit({"phase": "detect_keys_path", "model": "vil_yolon.yaml", "card": smi_line,
          "dataset": {name: {"wh": list(wh), "train": tr_n, "val": va_n}
                      for name, wh, tr_n, va_n in KEYS_SETS},
          "train": {"epochs": 1, "batch": BATCH, "imgsz": IMGSZ, "mosaic_n": 9, "train_s": train_s,
                    "launches_per_step": sorted(per_step),
                    "step_ms": [a.elapsed_time(b) for _, _, (a, b), _ in steps],
                    "trace": {"spans": tr["spans"], "mb": trace_mb,
                              "kernels_per_step": [len(ks) for ks in names],
                              "bf16_layer_stages_per_step": [sum("vil16_" in k for k in ks)
                                                             for ks in names],
                              "bf16_bwd_stages_per_step": [sum("bwd16_" in k for k in ks)
                                                           for ks in names],
                              "device_busy_ms_by_step": tr["busy_ms"],
                              "device_idle_ms_by_step": tr["idle_ms"],
                              "device_idle_share": sum(tr["idle_ms"]) / max(
                                  sum(tr["idle_ms"]) + sum(tr["busy_ms"]), 1e-9),
                              "device_idle_share_after_first": sum(tr["idle_ms"][1:]) / max(
                                  sum(tr["idle_ms"][1:]) + sum(tr["busy_ms"][1:]), 1e-9),
                              "ok": span_ok},
                    "plots_written": bool(pngs), "pngs": pngs, "plots_warning": warning,
                    "ok": train_ok},
          "rect_val": {"buckets": buckets, "own_labels": n_labels, "launches": counts,
                       "kernels": val["kernels"], "plain": val["plain"],
                       "rect_img_s": img_s["rect"], "square_img_s": img_s["square"],
                       "json_records": recs, "map_max_err": map_err, "ok": val_ok},
          "predict": {"images": len(files), "boxes": sum(map(len, every)),
                      "min_boxes_per_image": min(map(len, every)),
                      "boxes_by_class": by_cls.tolist(), "inside": inside, "class": top,
                      "class_boxes": n_top, "class_max_px_err": class_err[0],
                      "class_max_score_err": class_err[1], "launches": pred_counts,
                      "fuse_max_px_err": fuse_err[0], "fuse_max_score_err": fuse_err[1],
                      "ok": predict_ok},
          "rect_ms_by_case": rect, "launches": launches,
          "phase_s": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError("detect keys path check failed")
    return {k: v for k, v in launches.items() if v}, rect


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
              kw.get("norm_eps", 1e-3), kw.get("rms_eps", 1e-6),
              outnorm=kw.get("use_outnorm", True))
    plain = lambda a: vil_layer_bwd_ref(a, _layer_plain(a, cfg)[1], gout, nh, chunk_size=KERNEL_CS,
                                        igate_act=cfg.igate_act, eps=cfg.eps,
                                        norm_eps=cfg.norm_eps, rms_eps=cfg.rms_eps,
                                        use_outnorm=cfg.outnorm)
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


def build_cls_model(train: bool, cfg: dict = CLS):
    """The ViL classifier (``cfg``'s widths) on the card: seeded init with
    the JAX scheme, then seeded gate kernels (zero at init), so the mLSTM
    gates vary along the sequence."""
    import torch

    from xlstm_yolo_torch.nn.vil import MatrixLSTMCell
    from xlstm_yolo_torch.nn.vil_extra import VisionLSTM2

    model = VisionLSTM2(**cfg, resolution=(CLS_HW, CLS_HW), device="cuda", seed=0)
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


def phase_cls_path(cfg: dict = CLS, name: str = "cls_path"):
    """The ViL classifier (``cfg``) at batch CLS_BATCH. (a) One eval forward against
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
    depth = cfg["depth"]

    # (a) eval forward
    model = build_cls_model(train=False, cfg=cfg)
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
        model = build_cls_model(train=True, cfg=cfg)
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
    emit({"phase": name, "model": {**cfg, "resolution": CLS_HW}, "params": model.num_params(),
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
        raise PhaseError(f"{name} check failed")
    names = ("vil_layer_fwd", "vil_cell_fwd", "mlstm_chunkwise_bwd", "vil_block_fwd")
    key = "cls" if name == "cls_path" else name
    return {f"{key}_eval": dict(zip(names, eval_launches)),
            f"{key}_train": dict(zip(names, launches)),
            f"{key}_block_entry": {"vil_block_fwd": block_launches}}, CLS_BATCH / eval_ms * 1e3


def phase_yaml_graph(name: str):
    """GRAPH_YAML compiled by the port's graph compiler, seeded (gate kernels
    too, as ``build_cls_model``), one eval forward at batch CLS_BATCH of the
    classifier's images against the plain-forced graph: within TOL_REL of
    its max, one K3 launch per ViL layer of the backbone; then timed."""
    import torch

    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd
    from xlstm_yolo_torch.nn.graph import GraphModel, parse_model
    from xlstm_yolo_torch.nn.modules import init_tree
    from xlstm_yolo_torch.nn.vil import MatrixLSTMCell

    model = GraphModel(parse_model(GRAPH_YAML, ch=3))
    init_tree(model, 0)
    g = torch.Generator(device="cpu").manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MatrixLSTMCell):
                for lin in (m.igate, m.fgate):
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    model = model.eval().cuda()
    x = cls_inputs()[0].permute(0, 3, 1, 2).contiguous()
    depth = GRAPH_YAML["backbone"][0][3][2]["depth"]
    heads = model.l0.backbone.block0.fwd.layer.num_heads
    with torch.no_grad():
        vil_layer_fwd.launches = 0
        out = model(x)
        torch.cuda.synchronize()
        launches = vil_layer_fwd.launches
        with plain_vil_kernels():
            ref = model(x)
        ms = cuda_time_ms(lambda: model(x), iters=5)
    rel = compare(out, ref)[1]
    ok = (tuple(out.shape) == (CLS_BATCH, 384, 7, 7) and bool(torch.isfinite(out).all())
          and rel <= TOL_REL and launches == depth)
    emit({"phase": name, "graph": [row[2] for row in GRAPH_YAML["backbone"]],
          "batch": CLS_BATCH, "head_dim": 384 // heads, "heads": heads, "out_shape": list(out.shape),
          "launches_vil_layer_fwd": launches, "expected_launches": depth, "maxrelerr": rel,
          "tol": TOL_REL, "ms": ms, "img_per_s": CLS_BATCH / ms * 1e3, "ok": ok})
    if not ok:
        raise PhaseError(f"{name} check failed")
    return launches


def phase_vil_headdim_path():
    """ViL models at the JAX blocks' own default head dims. ViL-YOLO-n at
    head dim 16 (``yolo_default_headdim``): fp32 inference through
    ``Predictor`` (``main_path``'s checks), bf16 serving
    (``main_path_bf16``'s), one AMP step (``train_loop_amp``'s first step)
    and one fp32 step (``train_path``'s): K3 fp32 and bf16, K2 fp32 and
    bf16 at head dim 16. ``VisionLSTM2`` at its class default, head dim 4
    (96 heads), at ``cls_path``'s widths: eval, a stochastic-depth step (K4
    and K2 at head dim 4) and the block-fused entry (K7). GRAPH_YAML, the
    fork's blocks from the ``VisionLSTM`` row (``phase_yaml_graph``). Each
    against its plain-forced twin and timed, as the phase it reuses does.
    Returns each sub-path's launch counts and the classifier's eval img/s."""
    yolo = yolo_default_headdim()
    pre = "vil_headdim_path"
    counts = {f"{pre}.yolo_fp32": {"vil_layer_fwd": phase_main_path(yolo, f"{pre}.yolo_fp32")},
              f"{pre}.yolo_bf16": {"vil_layer_fwd_bf16": phase_main_path_bf16(
                  yolo, f"{pre}.yolo_bf16")},
              f"{pre}.yolo_amp_step": phase_train_loop_amp(yolo, f"{pre}.yolo_amp_step",
                                                           loop=False),
              f"{pre}.yolo_fp32_step": dict(zip(("vil_layer_fwd", "mlstm_chunkwise_bwd"),
                                                phase_train_path(yolo, f"{pre}.yolo_fp32_step")))}
    cls_counts, cls_img_s = phase_cls_path(CLS_DEFAULT_DH, f"{pre}.cls_dh4")
    counts.update(cls_counts)
    counts[f"{pre}.yaml_graph"] = {"vil_layer_fwd": phase_yaml_graph(f"{pre}.yaml_graph")}
    return counts, cls_img_s


def yolo_with_rows(kind: str) -> Variant:
    """ViL-YOLO-n with its three ViLBlockPairBlock rows replaced by
    ``FAMILY_ROWS[kind]``: ``[c, c, config]`` at c = 64, 128, 256."""
    import copy

    from xlstm_yolo_torch.cfg import load_model_yaml

    cfg, scale = load_model_yaml("vil_yolon.yaml")
    cfg = copy.deepcopy(cfg)
    name, config = FAMILY_ROWS[kind]
    widths = iter(YOLO_N_WIDTHS)
    for row in cfg["backbone"]:
        if row[2] == "ViLBlockPairBlock":
            c = next(widths)
            row[2], row[3] = name, [c, c, dict(config)]
    return Variant(cfg, scale, f"vil_yolon.yaml with {name} [c, c, {config}] rows")


def seed_gates(model, std=None):
    """Seeded gate kernels (zero at init) for every mLSTM cell of ``model``,
    at ``gate_std`` of the cell's width unless ``std`` is given."""
    import torch

    from xlstm_yolo_torch.nn.vil import MatrixLSTMCell

    g = torch.Generator(device="cpu").manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MatrixLSTMCell):
                for lin in (m.igate, m.fgate):
                    sd = gate_std(lin.weight.shape[1] // 3) if std is None else std
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * sd)
    return model


def family_counters():
    """K1, K3 (fp32, bf16) and K2 (fp32, bf16) launch counts."""
    from xlstm_yolo_torch.kernels.mlstm_fwd import mlstm_chunkwise_fwd

    return {"mlstm_chunkwise_fwd": mlstm_chunkwise_fwd.launches,
            **dict(zip(COUNTED, kernel_counters().tolist()))}


def zero_family_counters():
    from xlstm_yolo_torch.kernels.mlstm_fwd import mlstm_chunkwise_fwd

    mlstm_chunkwise_fwd.launches = 0
    zero_kernel_counters()


def phase_large_yolo(name: str):
    """ViL-YOLO-n with ``VilLayerUpdated`` rows (the xLSTM-7B-style vision
    block; chunk 80 divides 6400, 1600 and 400), plain torch on the card as
    in JAX: (a) fp32 inference (``predictions``) at batch BATCH, its first
    image against the same model on the CPU (boxes within TOL_REL of their
    max, scores within TOL_REL), then timed; (b) one fp32 train step, finite
    loss and gradients, then timed by stage. No launch of K1, K3 or K2."""
    import copy

    import torch

    from xlstm_yolo_torch.engine.trainer import TrainStep

    cfg = yolo_with_rows("large")
    model = build_main_model("cuda", cfg=cfg)
    cpu = copy.deepcopy(model).cpu()
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 1, (BATCH, IMGSZ, IMGSZ, 3)).astype(np.float32)).cuda()
    zero_family_counters()
    with torch.inference_mode():
        got = model.predictions(x)
        torch.cuda.synchronize()
        launches = family_counters()
        want = cpu.predictions(x[:1].cpu())
        ms = cuda_time_ms(lambda: model.predictions(x), iters=3, warmup=1)
    del cpu
    params = model.num_params()
    g1 = got[:1].cpu()
    box_rel = ((g1[..., :4] - want[..., :4]).abs().max() / want[..., :4].abs().max()).item()
    score_abs = (g1[..., 4:] - want[..., 4:]).abs().max().item()
    fwd_ok = (bool(torch.isfinite(got).all()) and box_rel <= TOL_REL and score_abs <= TOL_REL)

    model = build_main_model("cuda", train=True, cfg=cfg)
    step = TrainStep(model, amp=False)
    batch = train_batch("cuda")
    zero_family_counters()
    total, _ = step.forward_loss(batch)
    step.backward(total)
    torch.cuda.synchronize()
    train_launches = family_counters()
    loss = float(total.detach())
    grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
                       if p.grad is not None)
    step.apply_update()
    times = timed_step(step, batch)
    total_ms = sum(times.values())
    none = not any(launches.values()) and not any(train_launches.values())
    ok = fwd_ok and np.isfinite(loss) and grads_finite and none
    emit({"phase": name, "model": cfg.label, "batch": BATCH, "imgsz": IMGSZ,
          "params_after_fuse": params,
          "launches": launches, "train_launches": train_launches, "expected_launches": 0,
          "vs_cpu_batch1": {"box_maxrelerr": box_rel, "score_max_abs_err": score_abs},
          "forward_ms": ms, "img_per_s": BATCH / ms * 1e3, "loss": loss,
          "step_ms": times, "step_total_ms": total_ms,
          "step_img_per_s": BATCH / total_ms * 1e3, "tol": TOL_REL, "ok": ok})
    if not ok:
        raise PhaseError(f"{name} check failed")
    return {k: v for k, v in {**launches, **train_launches}.items() if v}


def phase_hier(name: str):
    """``HierarchicalVisionLSTM`` at its class defaults (dims 96 / 192 / 384,
    depths 2 / 2 / 4, patch 4, head dim 16) at CLS_HW px, batch CLS_BATCH
    of the classifier's images: (a) eval against the plain-forced model,
    every stage map within TOL_REL of its max, one K3 launch per ViL layer
    (8), timed; (b) the backward of a seeded linear read-out of the three
    maps against the plain-forced backward: the read-out and every gradient
    within TOL_REL, one K3 and one K2 launch per ViL layer."""
    import torch

    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd
    from xlstm_yolo_torch.nn.vil_extra import HierarchicalVisionLSTM

    model = seed_gates(HierarchicalVisionLSTM(**HIER, resolution=(CLS_HW, CLS_HW), device="cuda"),
                       std=0.05)
    n_layers = sum(HIER["depths"])
    x = cls_inputs()[0]
    with torch.no_grad():
        vil_layer_fwd.launches = 0
        outs = model(x)
        torch.cuda.synchronize()
        eval_launches = vil_layer_fwd.launches
        with plain_vil_kernels():
            refs = model(x)
        eval_ms = cuda_time_ms(lambda: model(x), iters=5)
    map_rel = [compare(o, r)[1] for o, r in zip(outs, refs)]
    shapes = [list(o.shape) for o in outs]
    del outs, refs
    g = torch.Generator(device="cuda").manual_seed(8)
    readout = [torch.randn(s, device="cuda", generator=g) for s in shapes]
    runs = {}
    for kind in ("kernels", "plain"):
        model.zero_grad(set_to_none=True)
        with plain_vil_kernels() if kind == "plain" else nullcontext():
            vil_layer_fwd.launches = mlstm_chunkwise_bwd.launches = 0
            loss = sum((o * r).sum() for o, r in zip(model(x), readout))
            loss.backward()
            torch.cuda.synchronize()
            launches = (vil_layer_fwd.launches, mlstm_chunkwise_bwd.launches)
        runs[kind] = (float(loss.detach()), {n: p.grad for n, p in model.named_parameters()},
                      launches)
    (loss_k, grads_k, launches), (loss_p, grads_p, plain_launches) = runs["kernels"], runs["plain"]
    del runs
    worst_rel, worst_name, vanishing, gmax = grad_errors(grads_k, grads_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        sum((o * r).sum() for o, r in zip(model(x), readout)).backward()

    step_ms = cuda_time_ms(fwd_bwd, iters=3, warmup=1)
    ok = (shapes == [[CLS_BATCH, CLS_HW // 4 // 2 ** i, CLS_HW // 4 // 2 ** i, d]
                     for i, d in enumerate(HIER["dims"])]
          and max(map_rel) <= TOL_REL and eval_launches == n_layers
          and launches == (n_layers, n_layers) and plain_launches == (0, 0)
          and worst_rel <= TOL_REL and loss_rel <= TOL_REL
          and all(bool(torch.isfinite(g_).all()) for g_ in grads_k.values()))
    emit({"phase": name, "model": {**HIER, "resolution": CLS_HW}, "params": model.num_params(),
          "batch": CLS_BATCH, "tol": TOL_REL, "maps": shapes, "map_maxrelerr": map_rel,
          "eval": {"launches_vil_layer_fwd": eval_launches, "expected_launches": n_layers,
                   "ms": eval_ms, "img_per_s": CLS_BATCH / eval_ms * 1e3},
          "readout_backward": {"launches": dict(zip(("vil_layer_fwd", "mlstm_chunkwise_bwd"),
                                                    launches)),
                               "loss_relerr": loss_rel, "grad_maxrelerr": worst_rel,
                               "grad_worst": worst_name, "grads_vanishing": vanishing,
                               "grad_max": gmax, "ms": step_ms,
                               "img_per_s": CLS_BATCH / step_ms * 1e3},
          "ok": ok})
    if not ok:
        raise PhaseError(f"{name} check failed")
    return {f"{name}_eval": {"vil_layer_fwd": eval_launches},
            f"{name}_backward": dict(zip(("vil_layer_fwd", "mlstm_chunkwise_bwd"), launches))}


def phase_vit(name: str, vil2_img_s: dict):
    """``VisionTransformer`` at its defaults (dim 192, depth 12, 3 heads,
    patch 16) at CLS_HW px: eval at batch CLS_BATCH on the card, its first
    two rows against the same model on the CPU at batch 2 (within TOL_REL
    of the max), then timed; its img/s beside the ViL classifier's at the
    same widths (``vil2_img_s``: ``cls_path`` at head dim 64,
    ``vil_headdim_path.cls_dh4`` at 4, measured earlier in this run). No
    ViL kernel runs here."""
    import copy

    import torch

    from xlstm_yolo_torch.nn.vil_extra import VisionTransformer

    model = VisionTransformer(**VIT, resolution=(CLS_HW, CLS_HW), device="cuda")
    cpu = copy.deepcopy(model).cpu()
    x = cls_inputs()[0]
    with torch.no_grad():
        got = model(x)
        want = cpu(x[:2].cpu())
        ms = cuda_time_ms(lambda: model(x), iters=5)
    rel = compare(got[:2].cpu(), want)[1]
    ok = (tuple(got.shape) == (CLS_BATCH, VIT["num_classes"]) and bool(torch.isfinite(got).all())
          and rel <= TOL_REL)
    emit({"phase": name, "model": {**VIT, "resolution": CLS_HW}, "params": model.num_params(),
          "batch": CLS_BATCH, "vs_cpu_batch2_maxrelerr": rel, "tol": TOL_REL, "ms": ms,
          "img_per_s": CLS_BATCH / ms * 1e3,
          "vision_lstm2_img_per_s": vil2_img_s, "ok": ok})
    if not ok:
        raise PhaseError(f"{name} check failed")


def no_outnorm_args(kind: str, B: int, case, device):
    """Seeded arguments of ``kind`` ("layer", "layer_bf16", "conv",
    "block") at ``case``, the outnorm's affine None."""
    import torch

    _, S, DIM, INNER, NH, _ = case
    a = layer_args(B, S, DIM, INNER, NH, seed=S + B + 40, device=device)
    rng = np.random.default_rng(S + B + 41)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    if kind == "layer_bf16":
        a = [a[0].bfloat16(), a[1].bfloat16(), *a[2:]]
    if kind == "conv":
        a = [a[0], *a[2:5], mk(INNER, 1, 3, 3) * 0.3, mk(INNER) * 0.1, *a[5:]]
    if kind == "block":
        a = [a[1], mk(B, S, INNER), mk(B, S, INNER), a[0], *a[5:]]
    at = {"layer": 15, "layer_bf16": 15, "conv": 16, "block": 14}[kind]
    a[at] = a[at + 1] = None
    return a


def no_outnorm_parity():
    """K3 (fp32 and bf16) at NO_OUTNORM_CASES, K6 at the first and K7 at the
    second, each with ``use_outnorm=False`` against its plain version
    (``kernel_parity``: the existing tolerances; bf16 by ``compare_bf16``).
    Bounds count the decay matrix below head dim 64. Returns the totals by
    kernel name."""
    import torch

    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS
    from xlstm_yolo_torch.kernels.vil_block import vil_block_fwd, vil_block_plain
    from xlstm_yolo_torch.kernels.vil_conv import vil_layer_conv_fwd, vil_layer_conv_plain
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd, vil_layer_ref

    dev = torch.device("cuda")
    off = dict(use_outnorm=False)
    nw = lambda args, first: sum(a.numel() for a in args[first:] if a is not None)
    small = lambda case: case[3] // case[4] < 64
    grid = lambda case: (int(round(case[1] ** 0.5)),) * 2
    extra = lambda case, ms: {"use_outnorm": False, "head_dim": case[3] // case[4]}
    make = lambda kind: (lambda B, case: no_outnorm_args(kind, B, case, dev))
    timed = lambda case: case[5]
    out = {"vil_layer_fwd": kernel_parity(
        "vil_layer_fwd", NO_OUTNORM_CASES, make("layer"),
        lambda args, case: (vil_layer_fwd(*args, case[4], chunk_size=CHUNK, **off),),
        lambda args, case: (vil_layer_ref(*args, case[4], chunk_size=CHUNK, **off),),
        lambda args, case: vil_bound("layer", case[5], *case[1:5], nw(args, 2),
                                     gate_matrix=small(case)),
        batch_of=timed, extra=extra)}
    out["vil_layer_fwd_bf16"] = kernel_parity(
        "vil_layer_fwd_bf16", NO_OUTNORM_CASES, make("layer_bf16"),
        lambda args, case: (vil_layer_fwd(*args, case[4], **off),),
        lambda args, case: (vil_layer_ref(*args, case[4], chunk_size=KERNEL_CS, keep_fp32=True,
                                          **off),),
        lambda args, case: bf16_vil_bound(case[5], *case[1:5], nw(args, 2),
                                          gate_matrix=small(case)),
        batch_of=timed, cmp=compare_bf16, extra=extra, metric=BF16_METRIC)
    out["vil_layer_conv_fwd"] = kernel_parity(
        "vil_layer_conv_fwd", NO_OUTNORM_CASES[:1], make("conv"),
        lambda args, case: (vil_layer_conv_fwd(*args, case[4], grid(case), chunk_size=CHUNK,
                                               **off),),
        lambda args, case: (vil_layer_conv_plain(*args, case[4], grid(case), chunk_size=CHUNK,
                                                 **off),),
        lambda args, case: conv_bound(case[5], *case[1:5], nw(args, 1), gate_matrix=small(case)),
        batch_of=timed, extra=lambda case, ms: {**extra(case, ms), "grid": list(grid(case))})
    out["vil_block_fwd"] = kernel_parity(
        "vil_block_fwd", NO_OUTNORM_CASES[1:], make("block"),
        lambda args, case: (vil_block_fwd(*args, case[4], chunk_size=CHUNK, **off),),
        lambda args, case: (vil_block_plain(*args, case[4], chunk_size=CHUNK, **off),),
        lambda args, case: vil_bound("block", case[5], *case[1:5], nw(args, 4),
                                     gate_matrix=small(case)),
        batch_of=timed, extra=extra)
    return out


def phase_no_outnorm_pair(name: str):
    """``ViLBlockPair(use_outnorm=False, proj_bias=False)`` at ViL-YOLO-n's
    P3 width (dim 64, head dim 64, the 80 x 80 grid), batch BATCH: forward
    and backward (a seeded output gradient) against its plain-forced twin:
    the output, the input gradient and every parameter gradient within
    TOL_REL; one K3 and one K2 launch."""
    import torch

    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd
    from xlstm_yolo_torch.nn.modules import init_tree
    from xlstm_yolo_torch.nn.vil import ViLBlockPair

    _, S, DIM, INNER, NH = STAGES[0]
    pair = ViLBlockPair(DIM, qkv_block_size=INNER // NH, seqlens=(80, 80), chunk_size=CHUNK,
                        use_outnorm=False, proj_bias=False)
    init_tree(pair, 0)
    pair = seed_gates(pair).cuda()
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(BATCH, S, DIM, device="cuda", generator=g)
    gout = torch.randn(BATCH, S, DIM, device="cuda", generator=g)
    runs = {}
    for kind in ("kernels", "plain"):
        pair.zero_grad(set_to_none=True)
        xt = x.clone().requires_grad_()
        with plain_vil_kernels() if kind == "plain" else nullcontext():
            vil_layer_fwd.launches = mlstm_chunkwise_bwd.launches = 0
            out = pair(xt)
            (out * gout).sum().backward()
            torch.cuda.synchronize()
            launches = (vil_layer_fwd.launches, mlstm_chunkwise_bwd.launches)
        runs[kind] = (out.detach(), {"x": xt.grad, **{n: p.grad for n, p in
                                                      pair.named_parameters()}}, launches)
    (out_k, grads_k, launches), (out_p, grads_p, plain_launches) = runs["kernels"], runs["plain"]
    out_rel = compare(out_k, out_p)[1]
    worst_rel, worst_name, vanishing, gmax = grad_errors(grads_k, grads_p)
    no_keys = not any(n.endswith("bias") and "proj" in n or "outnorm" in n
                      for n, _ in pair.named_parameters())
    ok = (no_keys and launches == (1, 1) and plain_launches == (0, 0) and out_rel <= TOL_REL
          and worst_rel <= TOL_REL)
    emit({"phase": name, "shape": [BATCH, S, DIM, INNER, NH], "use_outnorm": False,
          "proj_bias": False, "params": sorted(n for n, _ in pair.named_parameters()),
          "launches": dict(zip(("vil_layer_fwd", "mlstm_chunkwise_bwd"), launches)),
          "out_maxrelerr": out_rel, "grad_maxrelerr": worst_rel, "grad_worst": worst_name,
          "grads_vanishing": vanishing, "tol": TOL_REL, "ok": ok})
    if not ok:
        raise PhaseError(f"{name} check failed")
    return dict(zip(("vil_layer_fwd", "mlstm_chunkwise_bwd"), launches))


def phase_vil_family_path(vil2_img_s: dict):
    """The rest of the ViL family. ``fusion_yolo``: ViL-YOLO-n with
    ``FusionViLLayerBlock [c, c, {mlp_type: swiglu}]`` rows (K3 at head dim
    16): fp32 inference (``main_path``'s checks, 3 K3 launches), bf16
    serving (``main_path_bf16``'s), one fp32 train step (``train_path``'s).
    ``large_yolo``: the same with ``VilLayerUpdated`` rows
    (``phase_large_yolo``, no kernel). ``hier``, ``vit``: the hierarchical
    model and the ViT baseline at their defaults (the ViT's img/s beside
    ``vil2_img_s``, the classifier's). ``no_outnorm``: the
    kernel cases without the outnorm (``no_outnorm_parity``) and a
    ViLBlockPair without outnorm or biases (``phase_no_outnorm_pair``).
    Returns each sub-path's launch counts and the no-outnorm kernel totals."""
    t0 = time.perf_counter()
    pre = "vil_family_path"
    fusion = yolo_with_rows("fusion")
    counts = {
        f"{pre}.fusion_yolo_fp32": {"vil_layer_fwd": phase_main_path(
            fusion, f"{pre}.fusion_yolo_fp32")},
        f"{pre}.fusion_yolo_bf16": {"vil_layer_fwd_bf16": phase_main_path_bf16(
            fusion, f"{pre}.fusion_yolo_bf16")},
        f"{pre}.fusion_yolo_step": dict(zip(("vil_layer_fwd", "mlstm_chunkwise_bwd"),
                                            phase_train_path(fusion, f"{pre}.fusion_yolo_step"))),
        f"{pre}.large_yolo": phase_large_yolo(f"{pre}.large_yolo")}
    counts.update(phase_hier(f"{pre}.hier"))
    phase_vit(f"{pre}.vit", vil2_img_s)
    counts[f"{pre}.no_outnorm_pair"] = phase_no_outnorm_pair(f"{pre}.no_outnorm_pair")
    no_outnorm = no_outnorm_parity()
    emit({"phase": pre, "seconds": time.perf_counter() - t0, "ok": True})
    return counts, no_outnorm


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


# The NX-AI xLSTM-7B release's config.json (NX-AI/xLSTM-7b on Hugging Face):
# vocab 50304, embedding 4096, 32 blocks, 8 heads (DQK 256, DV 512), FFN 10944
XLSTM_7B = dict(vocab_size=50304, embedding_dim=4096, num_blocks=32, num_heads=8,
                qk_dim_factor=0.5, v_dim_factor=1.0, ffn_proj_factor=2.667, ffn_round_up_to=64,
                gate_soft_cap=15.0, output_logit_soft_cap=30.0, chunk_size=64, use_bias=False,
                norm_eps=1e-6)
XL_BATCH, XL_PROMPT, XL_NEW = 8, 512, 64  # prefill batch x tokens; new tokens of the decode
YOLO11 = "yolo11n.yaml"
YOLO11_CPU_BATCH = 2  # the card against the CPU: a forward and a train step at this batch


def all_kernel_counts() -> dict:
    """The launch count of every hand-written kernel's wrapper."""
    from xlstm_yolo_torch.kernels.mlstm_fwd import mlstm_chunkwise_fwd
    from xlstm_yolo_torch.kernels.slstm import slstm_scan_bwd, slstm_scan_fwd
    from xlstm_yolo_torch.kernels.topk import rowwise_kth_value
    from xlstm_yolo_torch.kernels.vil_block import vil_block_fwd
    from xlstm_yolo_torch.kernels.vil_cell import vil_cell_fwd
    from xlstm_yolo_torch.kernels.vil_conv import vil_layer_conv_fwd

    return {**family_counters(), "slstm_scan_fwd": slstm_scan_fwd.launches,
            "slstm_scan_bwd": slstm_scan_bwd.launches, "vil_cell_fwd": vil_cell_fwd.launches,
            "vil_block_fwd": vil_block_fwd.launches,
            "vil_layer_conv_fwd": vil_layer_conv_fwd.launches,
            "rowwise_kth_value": rowwise_kth_value.launches}


def zero_all_kernel_counts() -> None:
    from xlstm_yolo_torch.kernels.slstm import slstm_scan_bwd, slstm_scan_fwd
    from xlstm_yolo_torch.kernels.topk import rowwise_kth_value
    from xlstm_yolo_torch.kernels.vil_block import vil_block_fwd
    from xlstm_yolo_torch.kernels.vil_cell import vil_cell_fwd
    from xlstm_yolo_torch.kernels.vil_conv import vil_layer_conv_fwd

    zero_family_counters()
    for fn in (slstm_scan_fwd, slstm_scan_bwd, vil_cell_fwd, vil_block_fwd, vil_layer_conv_fwd,
               rowwise_kth_value):
        fn.launches = 0


def decode_bytes_bound_ms(model, batch: int) -> float:
    """The least time of one decode token at ``batch``: every weight read
    once but the embedding table (``batch`` rows of it), each block's state
    read once and written once, the logits written once, over the HBM
    rate."""
    D, NH = model.embedding_dim, model.num_heads
    weights = model.num_params() - model.embedding.weight.numel() + batch * D
    state = model.num_blocks * batch * NH * (model.qk_head_dim * model.v_head_dim
                                             + model.qk_head_dim + 1)
    return 4 * (weights + 2 * state + batch * model.vocab_size) / PEAK_BYTES_PER_S * 1e3


def phase_xlstm7b_path():
    """xLSTM-7B at the published widths on seeded weights drawn on the
    card: (a) a forward at XL_BATCH x XL_PROMPT tokens (shapes, finite,
    |logits| <= 30); (b) at batch 1 the prefill of XL_PROMPT tokens and one
    ``state=`` step against the last position of a from-scratch forward
    over XL_PROMPT + 1 tokens (the recurrent form; rtol and atol 2e-3, the
    JAX test's); (c) ``generate_scan`` (CUDA-graph replays) against eager
    ``generate``, XL_NEW greedy tokens, exactly. Then prefill ms and
    tokens/s, ms per token of eager ``generate``, of the eager step and of
    the graph step on static buffers beside the bytes bound, and the peak
    memory. No hand-written kernel runs here (JAX runs plain XLA)."""
    import gc

    import torch

    from xlstm_yolo_torch.nn import xlstm_large as XL

    gc.collect()
    torch.cuda.empty_cache()
    zero_all_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    model = XL.xLSTMLarge(**XLSTM_7B, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    V = model.vocab_size
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, V, (XL_BATCH, XL_PROMPT))).cuda()
    nxt = torch.from_numpy(rng.integers(0, V, (1, 1))).cuda()

    def ev_ms(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), out

    with torch.no_grad():
        _, logits = ev_ms(lambda: model(toks))  # (a), and the warm-up
        shapes_ok = tuple(logits.shape) == (XL_BATCH, XL_PROMPT, V)
        finite = bool(torch.isfinite(logits).all())
        logit_max = logits.abs().max().item()
        del logits
        prefill_ms = [ev_ms(lambda: model(toks))[0] for _ in range(2)]

        one = toks[:1]
        last, state = XL.prefill(model, one)  # (b)
        step_logits, _ = model(nxt, state=state, return_last_states=True)
        t1 = time.perf_counter()
        full = model(torch.cat([one, nxt], dim=1))[:, -1]
        torch.cuda.synchronize()
        recurrent_s = time.perf_counter() - t1
        step_err = (step_logits[:, 0] - full).abs().max().item()
        step_ok = bool(torch.allclose(step_logits[:, 0], full, rtol=2e-3, atol=2e-3))
        del step_logits, full, state

        gen_ms, eager = ev_ms(lambda: XL.generate(model, one, XL_NEW))  # (c)
        prefill1_ms, (last, state) = ev_ms(lambda: XL.prefill(model, one))
        graph_tokens = XL.generate_scan(model, one, XL_NEW)
        tokens_equal = bool(torch.equal(graph_tokens, eager))
        per_token = {}
        for kind in ("eager_step", "graph_step"):
            dec = XL.DecodeGraph(model, 1, XL_NEW, graph=kind == "graph_step")
            dec.reset(last, state)
            ms, out = ev_ms(dec.run)
            per_token[kind] = ms / XL_NEW
            tokens_equal &= bool(torch.equal(out, eager[:, XL_PROMPT:]))
            del dec
        per_token["generate"] = (gen_ms - prefill1_ms) / XL_NEW
    counts = all_kernel_counts()
    bound_ms = decode_bytes_bound_ms(model, 1)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_params = model.num_params()
    del model, last, state, eager, graph_tokens
    gc.collect()
    torch.cuda.empty_cache()
    prefill = float(np.median(prefill_ms))
    cap_ok = logit_max <= XLSTM_7B["output_logit_soft_cap"] + 1e-4
    ok = (shapes_ok and finite and cap_ok and step_ok and tokens_equal
          and not any(counts.values()))
    emit({"phase": "xlstm7b_path", "config": XLSTM_7B, "params": n_params,
          "weights_gib": n_params * 4 / 2**30, "build_s": build_s, "shapes_ok": shapes_ok,
          "finite": finite, "logits_abs_max": logit_max, "softcap_ok": cap_ok,
          "prefill_step_vs_full_max_abs_err": step_err, "prefill_step_ok": step_ok,
          "recurrent_forward_s": recurrent_s, "tokens_equal": tokens_equal,
          "prefill_batch": XL_BATCH, "prefill_tokens": XL_PROMPT, "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": XL_BATCH * XL_PROMPT / prefill * 1e3,
          "decode_batch": 1, "new_tokens": XL_NEW, "ms_per_token": per_token,
          "decode_bytes_bound_ms": bound_ms,
          "graph_over_bound": per_token["graph_step"] / bound_ms, "peak_gib": peak_gib,
          "launches": counts, "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError("xlstm7b_path check failed")
    return {k: v for k, v in counts.items() if v}


def phase_yolo11_path():
    """YOLO11n (``cfg/models/yolo11.yaml`` at scale n, 80 classes, full
    depth and width): ``main_path`` and ``train_path`` with no ViL kernel
    expected, then the card against the same port model on the CPU
    (``card_vs_cpu``, every gradient within TOL_REL)."""
    t_phase = time.perf_counter()
    zero_all_kernel_counts()
    phase_main_path(cfg=YOLO11, name="yolo11_path.inference", expected_launches=0)
    phase_train_path(cfg=YOLO11, name="yolo11_path.train", expected_launches=0)
    cpu_ok, vs_cpu = card_vs_cpu(build_main_model("cuda", train=True, cfg=YOLO11))
    counts = all_kernel_counts()
    ok = cpu_ok and not any(counts.values())
    emit({"phase": "yolo11_path", "model": YOLO11, "cpu_batch": YOLO11_CPU_BATCH, "imgsz": IMGSZ,
          **vs_cpu, "launches": counts, "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError("yolo11_path check failed")
    return {k: v for k, v in counts.items() if v}


# detect_zoo_path: every detection YAML of the zoo at its first scale (or its own
# file) at full width: (label, YAML, scale, the JAX TaskModel's strides and
# parameters). "yolov8n-ghost-p2.yaml" does not resolve in either package (the
# scale letter is read as the "t" of "ghost"), so the ghost P2 / P6 files are
# named with their scale
ZOO = [("yolov3", "yolov3.yaml", None, (8, 16, 32), 103_754_128),
       ("yolov3-spp", "yolov3-spp.yaml", None, (8, 16, 32), 104_803_728),
       ("yolov3-tiny", "yolov3-tiny.yaml", None, (16, 32), 12_173_232),
       ("yolov5n", "yolov5n.yaml", None, (8, 16, 32), 2_654_800),
       ("yolov5n-p6", "yolov5n-p6.yaml", None, (8, 16, 32, 64), 4_334_880),
       ("yolov6n", "yolov6n.yaml", None, (8, 16, 32), 4_500_160),
       ("yolov8n-ghost", "yolov8n-ghost.yaml", None, (8, 16, 32), 1_865_300),
       ("yolov8n-ghost-p2", "yolov8-ghost-p2.yaml", "n", (4, 8, 16, 32), 2_033_928),
       ("yolov8n-ghost-p6", "yolov8-ghost-p6.yaml", "n", (8, 16, 32, 64), 2_901_084),
       ("yolov8n-p2", "yolov8n-p2.yaml", None, (4, 8, 16, 32), 3_354_128),
       ("yolov8n-p6", "yolov8n-p6.yaml", None, (8, 16, 32, 64), 4_984_336),
       ("yolov9t", "yolov9t.yaml", None, (8, 16, 32), 2_128_704),
       ("yolov9s", "yolov9s.yaml", None, (8, 16, 32), 7_318_352),
       ("yolov9m", "yolov9m.yaml", None, (8, 16, 32), 20_216_144),
       ("yolov9c", "yolov9.yaml", None, (8, 16, 32), 25_590_896),
       ("yolov9e", "yolov9e.yaml", None, (8, 16, 32), 58_206_576),
       ("yolov10n", "yolov10n.yaml", None, (8, 16, 32), 2_775_504),
       ("yolov10s", "yolov10s.yaml", None, (8, 16, 32), 8_128_256),
       ("yolov10m", "yolov10m.yaml", None, (8, 16, 32), 16_576_752),
       ("yolov10b", "yolov10b.yaml", None, (8, 16, 32), 20_574_368),
       ("yolov10l", "yolov10l.yaml", None, (8, 16, 32), 25_888_672),
       ("yolov10x", "yolov10x.yaml", None, (8, 16, 32), 31_808_944),
       ("yolo12n", "yolo12n.yaml", None, (8, 16, 32), 2_602_272)]
# one model of each block family, held against the same model on the CPU
ZOO_VS_CPU = ("yolov3-tiny", "yolov6n", "yolov8n-ghost-p2", "yolov9t", "yolov9e", "yolov10n",
              "yolo12n")
# their fp32 gradients on the card against the CPU's and an fp64 step's, the
# step's discrete choices shared (``card_vs_cpu``): TOL_REL, but for the two
# models whose exact gradient is ill-conditioned. Set from the readings of
# ``tools/zoo_grad_probe.py`` on an H100: with the choices shared, the card
# against the CPU 2.0e-3 (v9t) and 2.4e-2 (v9e), the other five 1.2e-4 to
# 3.4e-4; fp64 on weights moved by 2^-24 moves v9t's 8.3e-4 and v9e's 3.4e-3,
# the other five's 2e-6 to 4e-5
ZOO_GRAD_TOL = {"yolov9t": 5e-3, "yolov9e": 5e-2}
ZOO_INFER_TIMED = 3  # timed inference iterations after one warm-up
ZOO_FACADE_IMAGES = 8  # val PNGs the facade check writes (and predicts)


def forward_gflop(model) -> float:
    """GFLOP of one forward of ``model``'s graph on one IMGSZ image (2 per
    multiply-add; ``torch.utils.flop_counter``), counted on the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from xlstm_yolo_torch.nn.graph import GraphModel

    with torch.device("meta"):
        graph = GraphModel(model.parsed).eval()
        with FlopCounterMode(display=False) as counter:
            graph(torch.zeros(1, 3, IMGSZ, IMGSZ))
    return counter.get_total_flops() / 1e9


def zoo_inference(model, frames):
    """Predictor inference of a fused copy of ``model`` on uint8 ``frames``
    (on the card): the outputs' checks, ``timed_inference`` and the peak
    memory."""
    import copy

    import torch

    from xlstm_yolo_torch.engine.predictor import Predictor
    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn

    fused = fuse_conv_bn(zero_class_biases(copy.deepcopy(model).eval()))
    pred = Predictor(fused, imgsz=IMGSZ)
    torch.cuda.reset_peak_memory_stats()
    dets, valid, cands, _ = pred(frames)
    n_cand = sum((IMGSZ // s) ** 2 for s in fused.strides)
    shapes_ok = (tuple(cands.shape) == (BATCH, n_cand, 4 + fused.nc)
                 and tuple(dets.shape) == (BATCH, 300, 6) and tuple(valid.shape) == (BATCH, 300))
    finite = bool(torch.isfinite(cands).all() and torch.isfinite(dets).all())
    n_valid = int(valid.sum())
    times = timed_inference(fused, pred, frames, iters=ZOO_INFER_TIMED, warmup=1)
    total_ms = sum(times.values())
    ok = shapes_ok and finite and n_valid > 0
    return ok, {"shapes_ok": shapes_ok, "finite": finite, "valid_dets": n_valid, "ms": times,
                "total_ms": total_ms, "img_per_s": BATCH / total_ms * 1e3,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def zoo_train(model, batch):
    """fp32 TrainSteps of a copy of ``model`` (``timed_step``); the losses
    and the last step's gradients finite; the peak memory."""
    import copy

    import torch

    from xlstm_yolo_torch.engine.trainer import TrainStep

    step = TrainStep(copy.deepcopy(model), amp=False)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    times = timed_step(step, batch, losses)
    grads_finite = all(bool(torch.isfinite(p.grad).all())
                       for p in step.model.parameters() if p.grad is not None)
    total_ms = sum(times.values())
    ok = bool(np.isfinite(losses).all()) and grads_finite
    return ok, {"losses": losses, "grads_finite": grads_finite, "ms": times,
                "total_ms": total_ms, "img_per_s": BATCH / total_ms * 1e3,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


class SharedChoices:
    """A train step's discrete choices: each TAL assignment
    (``utils.tal.assign``; an end-to-end model assigns twice; the rotated
    ``assign_rotated`` of an OBB model), the segmentation loss's top-32 mask
    anchors (``utils.loss.select_mask_anchors``), each max pool's argmax
    (``F.max_pool2d``), RT-DETR's query and postprocess selections
    (``nn.rtdetr.ranked``), the grid cells of its deformable sampling
    (``nn.rtdetr.cell``) and its Hungarian matches (``nn.rtdetr.hungarian``),
    YOLO-World's maxima (``nn.world.tied_max``: which texts win each
    pixel's max, which entries of each pooled bin are maximal; replayed as
    the mean over the recorded maxima, which splits the gradient as the max
    does), recorded in call order, or, given ``replay`` (another step's
    ``SharedChoices``), taken from it: the recorded outputs cast to this
    step's dtype, each pool the gather of its input at the recorded indices
    (the same function and gradient, on the other step's routing). The
    sampler's bilinear fraction is left unclipped inside the map, where the
    recorded cell is one that rounding may put a hair off the coordinate
    (``nn.rtdetr._corner`` clips it as JAX does, which would cut the
    gradient there). Two steps that share them compute one function;
    without, an fp32 step and an fp64 one can differ by a pool argmax that
    a near-tie flips (``tools/zoo_grad_probe.py``)."""

    def __init__(self, replay=None):
        self.replay, self.assigned, self.pooled, self.mask_anchors = replay, [], [], []
        self.ranked, self.cells, self.matched, self.maxima = [], [], [], []

    def _recorded(self, real, log: list, replayed: list | None, single: bool = False):
        """``real`` recorded into ``log``, or replayed from ``replayed``;
        ``single``: it returns one tensor, not a tuple."""
        from xlstm_yolo_torch.utils import at_least_fp32

        def fn(*args, **kw):
            if replayed is None:
                out = real(*args, **kw)
                out = (out,) if single else out
            else:
                dev, dt = args[0].device, at_least_fp32(args[0]).dtype
                out = tuple(t.to(dev, dt) if t.is_floating_point() else t.to(dev)
                            for t in replayed[len(log)])
            log.append(tuple(t.detach().cpu() for t in out))
            return out[0] if single else out

        return fn

    @contextmanager
    def active(self):
        import torch
        import torch.nn.functional as F

        import xlstm_yolo_torch.nn.rtdetr as rtdetr
        import xlstm_yolo_torch.nn.world as world
        import xlstm_yolo_torch.utils.loss as loss_mod
        import xlstm_yolo_torch.utils.tal as tal

        real_pool = F.max_pool2d
        rp = self.replay

        def tied_max(x, dims):
            if rp is None:
                mask = x == torch.amax(x, dim=dims, keepdim=True)
            else:
                mask = rp.maxima[len(self.maxima)].to(x.device)
            self.maxima.append(mask.cpu())
            if rp is None:
                return torch.amax(x, dim=dims)
            w = mask.to(x.dtype)
            return (x * w).sum(dims) / w.sum(dims)

        def pool(x, k, s=None, p=0):
            if rp is None:
                y, idx = real_pool(x, k, s, p, return_indices=True)
            else:
                idx = rp.pooled[len(self.pooled)].to(x.device)
                y = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
            self.pooled.append(idx.cpu())
            return y

        assign = self._recorded(tal.assign, self.assigned, rp and rp.assigned)
        rotated = self._recorded(tal.assign_rotated, self.assigned, rp and rp.assigned)
        anchors = self._recorded(loss_mod.select_mask_anchors, self.mask_anchors,
                                 rp and rp.mask_anchors)
        ranked = self._recorded(rtdetr.ranked, self.ranked, rp and rp.ranked, single=True)
        cells = self._recorded(rtdetr.cell, self.cells, rp and rp.cells, single=True)
        matched = self._recorded(rtdetr.hungarian, self.matched, rp and rp.matched, single=True)

        def corner(f, size):
            fl = cells(f)
            c = rtdetr._clip(fl, 0, size - 1)
            a = f - c
            a = torch.where((fl < 0) | (fl > size - 1), rtdetr._clip(a, 0.0, 1.0), a)
            return c, a[..., None]

        with mock.patch.object(tal, "assign", assign), \
                mock.patch.object(tal, "assign_rotated", rotated), \
                mock.patch.object(loss_mod, "select_mask_anchors", anchors), \
                mock.patch.object(rtdetr, "ranked", ranked), \
                mock.patch.object(rtdetr, "_corner", corner), \
                mock.patch.object(rtdetr, "hungarian", matched), \
                mock.patch.object(world, "tied_max", tied_max), \
                mock.patch.object(F, "max_pool2d", pool):
            yield self

    def flips(self, other) -> dict:
        """Anchors whose foreground flag or ground truth differ from
        ``other``'s assignment, mask anchors chosen otherwise, and pooled
        outputs whose argmax differs."""
        fg = gt = 0
        for a, b in zip(self.assigned, other.assigned):
            fg += int((a[3] != b[3]).sum())
            gt += int(((a[4] != b[4]) & a[3] & b[3]).sum())
        pool = sum(int((a != b).sum()) for a, b in zip(self.pooled, other.pooled))
        anchors = sum(int((a[1] != b[1]).sum()) for a, b in zip(self.mask_anchors,
                                                                 other.mask_anchors))
        differ = lambda xs, ys: sum(int((a[0] != b[0]).sum()) for a, b in zip(xs, ys))
        return {"fg_flips": fg, "gt_flips": gt, "pool_argmax_flips": pool,
                "mask_anchor_flips": anchors, "pooled": sum(a.numel() for a in self.pooled),
                "ranked_flips": differ(self.ranked, other.ranked),
                "cell_flips": differ(self.cells, other.cells),
                "match_flips": differ(self.matched, other.matched),
                "maxima_flips": sum(int((a != b).sum()) for a, b in zip(self.maxima,
                                                                        other.maxima))}


def zoo_step(model, dev, dtype, batch, choices, host_divide: bool = False):
    """(loss, {name: gradient}) of one train step of a copy of ``model`` in
    ``dtype`` on ``dev`` (the trainer's step: images / 255 in fp32, then
    cast; BatchNorm, loss and assigner in fp64 when ``dtype`` is), its
    discrete choices recorded or replayed by ``choices``. ``host_divide``:
    the images divided where ``batch`` lies, before the copy to ``dev``, so
    that every step sees the same images (the card divides a tensor by a
    scalar as a product with its reciprocal, which rounds some pixels one
    fp32 ulp away from the CPU's quotient; an ill-conditioned gradient
    moves by far more than that)."""
    import copy

    import torch

    m = copy.deepcopy(model).to(dev, dtype).train()
    img = (batch["img"].float() / 255.0).to(dev, dtype) if host_divide else None
    batch = {k: tuple(x.to(dev) for x in t) if isinstance(t, tuple) else t.to(dev)
             for k, t in batch.items()}
    if img is None:
        img = (batch["img"].float() / 255.0).to(dtype)
    with choices.active():
        total, _ = m.loss({**batch, "img": img})
        total.backward()
    # a parameter the loss does not reach (RT-DETR's encoder heads) has no gradient
    grads = {n: p.grad.detach().cpu() if p.grad is not None else torch.zeros(p.shape, dtype=dtype)
             for n, p in m.named_parameters()}
    del m
    if dev == "cuda":
        torch.cuda.empty_cache()
    return float(total.detach()), grads


def card_vs_cpu(model, grad_tol: float = TOL_REL):
    """The card against the CPU on ``model``'s weights (unfused, on any
    device): a fused eval forward at YOLO11_CPU_BATCH, 640 px, the
    candidates within TOL_REL (boxes of their max, scores absolute); then
    one fp32 train step on each (``zoo_step``, ``train_batch`` at
    YOLO11_CPU_BATCH) on the discrete choices of the same step in fp64 on
    the card (``SharedChoices``): the loss within TOL_REL and every
    gradient within ``grad_tol`` of the CPU's and of the fp64 step's, each
    tensor of its own max. Printed beside: the CPU's distance from the
    fp64 step, and the choices that the card's fp32 step, left to make its
    own, makes otherwise than the fp64 step. Returns (ok, numbers)."""
    import copy

    import torch

    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn

    shape = (YOLO11_CPU_BATCH, IMGSZ, IMGSZ, 3)
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32))
    fused = fuse_conv_bn(zero_class_biases(copy.deepcopy(model).eval()))
    preds = {}
    for dev in ("cuda", "cpu"):
        with torch.no_grad():
            preds[dev] = copy.deepcopy(fused).to(dev).predictions(x.to(dev)).cpu()
    got, want = preds["cuda"], preds["cpu"]
    box_rel = ((got[..., :4] - want[..., :4]).abs().max() / want[..., :4].abs().max()).item()
    score_abs = (got[..., 4:] - want[..., 4:]).abs().max().item()

    batch = train_batch("cpu", batch=YOLO11_CPU_BATCH)
    ref = SharedChoices()
    ref_loss, ref_grads = zoo_step(model, "cuda", torch.float64, batch, ref)
    own = SharedChoices()
    zoo_step(model, "cuda", torch.float32, batch, own)
    steps = {dev: zoo_step(model, dev, torch.float32, batch, SharedChoices(replay=ref))
             for dev in ("cuda", "cpu")}
    worst_rel, worst_name, vanishing, gmax = grad_errors(steps["cuda"][1], steps["cpu"][1])
    loss_rel = abs(steps["cuda"][0] - steps["cpu"][0]) / abs(steps["cpu"][0])
    vs64 = {dev: grad_errors(steps[dev][1], ref_grads)[:2] for dev in steps}
    ok = (box_rel <= TOL_REL and score_abs <= TOL_REL and loss_rel <= TOL_REL
          and worst_rel <= grad_tol and vs64["cuda"][0] <= grad_tol)
    return ok, {"cands_box_maxrelerr_vs_cpu": box_rel, "cands_score_max_abs_err_vs_cpu": score_abs,
                "loss": steps["cuda"][0], "loss_cpu": steps["cpu"][0], "loss_fp64": ref_loss,
                "loss_relerr_vs_cpu": loss_rel, "grad_maxrelerr_vs_cpu": worst_rel,
                "grad_tol": grad_tol, "grad_worst": worst_name, "grads_vanishing": vanishing,
                "grad_max": gmax, "grad_maxrelerr_vs_fp64": {d: v[0] for d, v in vs64.items()},
                "grad_worst_vs_fp64": {d: v[1] for d, v in vs64.items()},
                "card_fp32_own_choices_vs_fp64": own.flips(ref)}


def zoo_facade(smi_line):
    """``YOLO("yolov10n.yaml")`` on the card through the user's entry
    points: predict ZOO_FACADE_IMAGES PNGs the phase writes (640 x 480), then
    val on them and embed one; the end-to-end head's one2one branch decoded
    and NMS'd. Returns (ok, numbers)."""
    import tempfile

    import torch

    from xlstm_yolo_torch import YOLO
    from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset

    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_dataset(f"{tmp}/ds", n_train=1, n_val=ZOO_FACADE_IMAGES,
                                      width=FIT_WH[0], height=FIT_WH[1], seed=0)
        val_dir = Path(data).parent / "images" / "val"
        m = YOLO("yolov10n.yaml")
        zero_class_biases(m.model)
        t0 = time.perf_counter()
        results = m.predict(val_dir, imgsz=IMGSZ, conf=0.25)
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        metrics = m.val(data=data, imgsz=IMGSZ, batch=BATCH, plots=False)
        torch.cuda.synchronize()
        val_s = time.perf_counter() - t0
        emb = m.embed(next(iter(sorted(val_dir.iterdir()))), imgsz=IMGSZ)
    n_boxes = sum(len(r) for r in results)
    ok = (m.model.e2e and len(results) == ZOO_FACADE_IMAGES and n_boxes > 0
          and all(np.isfinite(v) for v in metrics.values() if isinstance(v, float))
          and len(emb) == 1 and emb[0].shape == (3 * (64 + m.model.nc),)
          and np.isfinite(emb[0]).all())
    return ok, {"images": len(results), "boxes": n_boxes, "predict_s": predict_s,
                "val_s": val_s, "val_metrics": {k: v for k, v in metrics.items()
                                                if isinstance(v, (int, float))},
                "embed_len": int(emb[0].shape[0]), "nvidia_smi": smi_line}


def phase_detect_zoo_path(smi_line):
    """Every model of ZOO built by ``TaskModel`` on the card (parameters and
    strides equal to the JAX package's), then ``Predictor`` inference and
    fp32 train steps at batch 8, 640 px, timed by stage, peak memory by
    path; ZOO_VS_CPU models also against the CPU (``card_vs_cpu``); then
    ``zoo_facade``. No hand-written kernel runs: the counts, set to 0 just
    before, stay 0."""
    import torch

    from xlstm_yolo_torch.nn.tasks import TaskModel

    t_phase = time.perf_counter()
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)).cuda()
    batch = train_batch("cuda")
    zero_all_kernel_counts()
    failed, img_s = [], {}
    for label, cfg, scale, strides, params in ZOO:
        t0 = time.perf_counter()
        model = TaskModel(cfg, scale=scale, device="cuda", seed=0)
        build_s = time.perf_counter() - t0
        built_ok = model.num_params() == params and model.strides == strides
        gflop = forward_gflop(model)
        inf_ok, inf = zoo_inference(model, frames)
        inf["forward_tflop_per_s"] = BATCH * gflop / inf["ms"]["forward"]
        train_ok, train = zoo_train(model, batch)
        cpu_ok, vs_cpu = (card_vs_cpu(model, ZOO_GRAD_TOL.get(label, TOL_REL))
                          if label in ZOO_VS_CPU else (True, {}))
        ok = built_ok and inf_ok and train_ok and cpu_ok
        emit({"phase": f"detect_zoo_path.{label}", "yaml": cfg, "scale": model.scale,
              "params": model.num_params(), "params_jax": params, "strides": model.strides,
              "e2e": model.e2e, "build_s": build_s, "batch": BATCH, "imgsz": IMGSZ,
              "forward_gflop_per_image": gflop,
              "inference": inf, "train": train, **vs_cpu,
              "seconds": time.perf_counter() - t0, "ok": ok})
        if not ok:
            failed.append(label)
        img_s[label] = (inf["img_per_s"], train["img_per_s"])
        del model
        torch.cuda.empty_cache()
    facade_ok, facade = zoo_facade(smi_line)
    counts = all_kernel_counts()
    ok = not failed and facade_ok and not any(counts.values())
    emit({"phase": "detect_zoo_path", "models": len(ZOO), "failed": failed,
          "img_per_s_inference_train": img_s, "facade_yolov10n": facade, "launches": counts,
          "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError(f"detect_zoo_path check failed: {failed or 'facade or launches'}")
    return {k: v for k, v in counts.items() if v}


# tasks_path: the segment, pose and OBB tasks. The flagship of each at its
# public configuration: (label, YAML, nc, kpt_shape, imgsz, strides, the JAX
# TaskModel's parameters at that nc): yolo11n-seg on COCO (80 classes, 640
# px), yolo11n-pose on COCO-pose (1 class, 17 keypoints, 640 px),
# yolo11n-obb on DOTAv1 (15 classes, 1024 px, the size Ultralytics trains it
# at); then the other ten -seg / -pose / -obb YAMLs at their own nc, first
# scale (the P6 files named with it), 640 px
TASK_FLAGSHIPS = [
    ("yolo11n-seg", "yolo11n-seg.yaml", 80, None, 640, (8, 16, 32), 2_876_832),
    ("yolo11n-pose", "yolo11n-pose.yaml", 1, (17, 3), 640, (8, 16, 32), 2_874_446),
    ("yolo11n-obb", "yolo11n-obb.yaml", 15, None, 1024, (8, 16, 32), 2_664_416)]
TASK_OTHERS = [("yolov8n-seg", "yolov8n-seg.yaml", None, (8, 16, 32), 3_409_952),
               ("yolov8n-seg-p6", "yolov8-seg-p6.yaml", "n", (8, 16, 32, 64), 5_302_800),
               ("yolo12n-seg", "yolo12n-seg.yaml", None, (8, 16, 32), 2_855_040),
               ("yolov9c-seg", "yolov9c-seg.yaml", None, (8, 16, 32), 27_897_104),
               ("yolov9e-seg", "yolov9e-seg.yaml", None, (8, 16, 32), 60_512_784),
               ("yolov8n-pose", "yolov8n-pose.yaml", None, (8, 16, 32), 3_295_454),
               ("yolov8n-pose-p6", "yolov8-pose-p6.yaml", "n", (8, 16, 32, 64), 5_182_136),
               ("yolo12n-pose", "yolo12n-pose.yaml", None, (8, 16, 32), 2_886_699),
               ("yolov8n-obb", "yolov8n-obb.yaml", None, (8, 16, 32), 3_228_851),
               ("yolo12n-obb", "yolo12n-obb.yaml", None, (8, 16, 32), 2_673_939)]
# the flagships' fp32 gradients on the card against the CPU's and an fp64
# step's (``task_card_vs_cpu``): TOL_REL, but for yolo11n-obb, whose exact
# gradient is ill-conditioned. Set from ``tools/zoo_grad_probe.py
# yolo11n-obb --nudges 4 --tensor l23.cv4_2_2.bias`` on an H100 (NVIDIA H100
# 80GB HBM3, 700 W): fp64 on weights moved by 2^-24 moves the angle branch's
# last bias 2.4e-4, 1.05e-3, 1.16e-3 and 1.73e-3 over four draws; the
# card's fp32 step on shared choices reads 3.6e-4 from the CPU's
TASK_GRAD_TOL = {"yolo11n-obb": 5e-3}
# Ultralytics' coco-pose.yaml flip_idx
COCO_POSE_FLIP = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


def task_model(cfg: str, nc=None, kpt_shape=None, device="cuda", scale=None):
    """``TaskModel`` of a bundled task YAML at ``nc`` (its own when None) and
    ``kpt_shape`` (a pose YAML's own when None), weights from seed 0."""
    from xlstm_yolo_torch.cfg import load_model_yaml
    from xlstm_yolo_torch.nn.tasks import TaskModel

    d, s = load_model_yaml(cfg)
    if kpt_shape is not None:
        d["kpt_shape"] = list(kpt_shape)
    return TaskModel(d, nc=nc, scale=scale or s, device=device, seed=0)


def task_batch(model, device, batch: int, imgsz: int) -> dict:
    """Seeded uint8 images and three labels an image for ``model``'s task:
    boxes (an OBB model's rotated boxes, cls cx cy w h angle), the
    overlap-encoded masks at imgsz / 4 (segment), keypoints inside each box
    (pose)."""
    import torch

    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    f = imgsz / 640
    boxes = np.float32([[1, 100, 100, 400, 400], [7, 320, 40, 600, 260], [0, 20, 380, 250, 630]])
    boxes[:, 0] %= model.nc
    boxes[:, 1:] *= f
    mask = np.zeros((batch, N_LABELS), bool)
    mask[:, :3] = True
    if model.task == "obb":
        cb = np.zeros((batch, N_LABELS, 6), np.float32)
        cb[:, :3, 0] = boxes[:, 0]
        cb[:, :3, 1:3] = (boxes[:, 1:3] + boxes[:, 3:5]) / 2
        cb[:, :3, 3:5] = (boxes[:, 3:5] - boxes[:, 1:3]) * 0.7
        cb[:, :3, 5] = [0.3, -0.6, 1.1]
    else:
        cb = np.zeros((batch, N_LABELS, 5), np.float32)
        cb[:, :3] = boxes
    out = {"img": imgs, "cls_boxes": cb, "mask": mask}
    if model.task == "segment":
        masks = np.zeros((batch, imgsz // 4, imgsz // 4), np.int32)
        for j, (_, x1, y1, x2, y2) in enumerate((boxes / [1, 4, 4, 4, 4]).astype(int)):
            masks[:, y1:y2, x1:x2] = j + 1
        out["masks"] = masks
    if model.task == "pose":
        nk = model.kpt_shape[0]
        kp = np.zeros((batch, N_LABELS, nk, 3), np.float32)
        kp[:, :3, :, :2] = boxes[None, :, None, 1:3] + rng.uniform(0, 200 * f, (batch, 3, nk, 2))
        kp[:, :3, :, 2] = 2.0
        out["keypoints"] = kp
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def task_inference(model, frames, imgsz: int, iters: int = ZOO_INFER_TIMED) -> tuple:
    """``Predictor`` inference of a fused copy of ``model`` on uint8
    ``frames`` (on the card): letterbox, forward and decode
    (``predictions_full``), NMS (``nms_rotated`` for OBB), then on the host
    the masks assembled or the keypoints gathered for every image at its
    own size; stage ms (CUDA events, the host stage by the clock), the
    mean of ``iters`` after one warm-up, img/s and peak GiB."""
    import copy

    import torch

    from xlstm_yolo_torch.engine.predictor import Predictor
    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn

    fused = fuse_conv_bn(zero_class_biases(copy.deepcopy(model).eval()))
    pred = Predictor(fused, imgsz=imgsz, verbose=False)
    torch.cuda.reset_peak_memory_stats()
    times = {"letterbox": 0.0, "forward_decode": 0.0, "nms": 0.0, "masks_or_keypoints": 0.0}
    n_valid, shapes_ok, finite = 0, True, True
    h0, w0 = frames.shape[1:3]
    with torch.inference_mode():
        for it in range(1 + iters):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            x, (r, px, py) = pred.preprocess(frames)
            ev[1].record()
            full = pred.decode(x)
            ev[2].record()
            dets, valid = pred.postprocess(full["cands"].float())
            ev[3].record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = {k: v.float().cpu().numpy() for k, v in full.items()}
            dn, vn = dets.cpu().numpy(), valid.cpu().numpy()
            for b in range(len(dn)):
                d = dn[b][vn[b]]
                if fused.task == "segment" and len(d):
                    m = pred._assemble_masks(d, host["cands"][b], host["coefs"][b],
                                             host["proto"][b], (h0, w0), r, px, py)
                    shapes_ok &= m.shape == (len(d), h0, w0)
                elif fused.task == "pose" and len(d):
                    k = pred._gather_kpts(d, host["cands"][b], host["kpts"][b], r, px, py)
                    shapes_ok &= k.shape == (len(d), *fused.kpt_shape)
            host_ms = (time.perf_counter() - t0) * 1e3
            if it:
                for k, (a, b) in zip(list(times)[:3], zip(ev[:3], ev[1:])):
                    times[k] += a.elapsed_time(b) / iters
                times["masks_or_keypoints"] += host_ms / iters
    n_valid = int(valid.sum())
    n_cand = sum((imgsz // s) ** 2 for s in fused.strides)
    width = 5 + fused.nc if fused.task == "obb" else 4 + fused.nc
    shapes_ok &= (tuple(full["cands"].shape) == (len(frames), n_cand, width)
                  and tuple(dets.shape) == (len(frames), 300, 7 if fused.task == "obb" else 6))
    finite = all(bool(torch.isfinite(v).all()) for v in full.values())
    total_ms = sum(times.values())
    ok = shapes_ok and finite and n_valid > 0
    return ok, {"shapes_ok": bool(shapes_ok), "finite": finite, "valid_dets": n_valid,
                "ms": times, "total_ms": total_ms, "img_per_s": len(frames) / total_ms * 1e3,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def task_train(model, batch, amp: bool) -> tuple:
    """``timed_step`` of a TrainStep (fp32, or bf16 AMP) over a copy of
    ``model`` on ``batch``; the losses and gradients finite; peak GiB."""
    import copy

    import torch

    from xlstm_yolo_torch.engine.trainer import TrainStep

    step = TrainStep(copy.deepcopy(model), amp=amp)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    times = timed_step(step, batch, losses)
    grads_finite = all(bool(torch.isfinite(p.grad).all())
                       for p in step.model.parameters() if p.grad is not None)
    total_ms = sum(times.values())
    ok = bool(np.isfinite(losses).all()) and grads_finite
    return ok, {"losses": losses, "grads_finite": grads_finite, "ms": times,
                "total_ms": total_ms, "img_per_s": len(batch["img"]) / total_ms * 1e3,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def task_card_vs_cpu(model, imgsz: int, grad_tol: float = TOL_REL) -> tuple:
    """The card against the CPU on ``model``'s weights at batch
    YOLO11_CPU_BATCH: the fused eval's decoded outputs (boxes, scores,
    the angle, coefficients, prototypes, keypoints) each within TOL_REL of
    its max; one fp32 train step's loss within TOL_REL and every gradient
    within ``grad_tol``, both steps on the discrete choices of an fp64 step
    on the card (``SharedChoices``: TAL or rotated TAL, the mask anchors,
    max-pool argmax), of the CPU's and of the fp64 step's."""
    import copy

    import torch

    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn

    shape = (YOLO11_CPU_BATCH, imgsz, imgsz, 3)
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32))
    fused = fuse_conv_bn(zero_class_biases(copy.deepcopy(model).eval()))
    outs = {}
    for dev in ("cuda", "cpu"):
        with torch.no_grad():
            outs[dev] = {k: v.float().cpu() for k, v in
                         copy.deepcopy(fused).to(dev).predictions_full(x.to(dev)).items()}
    nc = fused.nc
    parts = {"boxes": lambda o: o["cands"][..., :4], "scores": lambda o: o["cands"][..., 4:4 + nc]}
    if fused.task == "obb":
        parts["angle"] = lambda o: o["cands"][..., 4 + nc:]
    for key in ("coefs", "proto", "kpts"):
        if key in outs["cpu"]:
            parts[key] = lambda o, key=key: o[key]
    errs = {k: ((f(outs["cuda"]) - f(outs["cpu"])).abs().max()
                / f(outs["cpu"]).abs().max().clamp(min=1e-30)).item() for k, f in parts.items()}
    cpu_batch = {k: v.cpu() for k, v in task_batch(model, "cpu", YOLO11_CPU_BATCH, imgsz).items()}
    ref = SharedChoices()
    ref_loss, ref_grads = zoo_step(model, "cuda", torch.float64, cpu_batch, ref)
    own = SharedChoices()
    zoo_step(model, "cuda", torch.float32, cpu_batch, own)
    steps = {dev: zoo_step(model, dev, torch.float32, cpu_batch, SharedChoices(replay=ref))
             for dev in ("cuda", "cpu")}
    worst_rel, worst_name, vanishing, gmax = grad_errors(steps["cuda"][1], steps["cpu"][1])
    loss_rel = abs(steps["cuda"][0] - steps["cpu"][0]) / abs(steps["cpu"][0])
    vs64 = {dev: grad_errors(steps[dev][1], ref_grads)[:2] for dev in steps}
    ok = (max(errs.values()) <= TOL_REL and loss_rel <= TOL_REL and worst_rel <= grad_tol
          and vs64["cuda"][0] <= grad_tol)
    return ok, {"decoded_maxrelerr_vs_cpu": errs, "loss": steps["cuda"][0],
                "loss_cpu": steps["cpu"][0], "loss_fp64": ref_loss, "loss_relerr_vs_cpu": loss_rel,
                "grad_maxrelerr_vs_cpu": worst_rel, "grad_tol": grad_tol, "grad_worst": worst_name,
                "grads_vanishing": vanishing, "grad_max": gmax,
                "grad_maxrelerr_vs_fp64": {d: v[0] for d, v in vs64.items()},
                "card_fp32_own_choices_vs_fp64": own.flips(ref)}


def task_facade(smi_line) -> tuple:
    """``YOLO`` on the card through the user's entry points for each task,
    on PNGs ``make_synthetic_dataset(task=...)`` writes (640 x 480, 8 train
    and 4 val images): one epoch at the defaults (bf16 AMP, mosaic), then
    ``val`` and ``predict``. yolo11n-pose takes the set's 5 keypoints (a
    copy of its YAML at ``kpt_shape`` [5, 3], as the JAX tests set it) and
    trains with ``device_augment``: its first augmented batch is held
    against the same augmentation on the CPU on the same draws."""
    import tempfile

    import torch
    import yaml

    from xlstm_yolo_torch import YOLO
    from xlstm_yolo_torch.cfg import load_model_yaml
    from xlstm_yolo_torch.data import device_augment as DA
    from xlstm_yolo_torch.data.dataset import build_dataloader
    from xlstm_yolo_torch.engine.trainer import TrainStep

    out, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        for task, cfg in (("segment", "yolo11n-seg.yaml"), ("pose", "yolo11n-pose.yaml"),
                          ("obb", "yolo11n-obb.yaml")):
            data = make_task_set(f"{tmp}/{task}", task)
            kw = {}
            if task == "pose":
                d, _ = load_model_yaml(cfg)
                d.pop("yaml_file", None)
                d["kpt_shape"] = [5, 3]
                cfg = f"{tmp}/yolo11n-pose.yaml"
                Path(cfg).write_text(yaml.safe_dump(d))
                kw["device_augment"] = True
            m = YOLO(cfg)
            recorded = []
            real_aug = TrainStep.augment_batch

            def record(step, batch, real_aug=real_aug, recorded=recorded):
                if not recorded:  # this step's draws, before its update moves the count
                    img = batch["img"]
                    d = step.augment_draws(img.shape[0], img.shape[1], img.device)
                    recorded.append((step, d, {k: v.clone() for k, v in batch.items()}))
                res = real_aug(step, batch)
                if len(recorded[0]) == 3:  # a copy: the step casts res["img"] in place (AMP)
                    recorded[0] += ({k: v.clone() for k, v in res.items()},)
                return res

            t0 = time.perf_counter()
            with mock.patch.object(TrainStep, "augment_batch", record):
                m.train(data=data, epochs=1, imgsz=IMGSZ, batch=BATCH, plots=False,
                        project=f"{tmp}/runs", name=task, **kw)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            metrics = m.val(data=data, imgsz=IMGSZ, batch=BATCH)
            results = m.predict(str(Path(data).parent / "images" / "val"), imgsz=IMGSZ,
                                conf=0.001, verbose=False)
            field = {"segment": "masks", "pose": "keypoints", "obb": "obb"}[task]
            fields_ok = all(getattr(r, field) is not None and len(getattr(r, field)) == len(r)
                            for r in results if len(r))
            key = {"segment": "mAP50(M)", "pose": "mAP50(P)", "obb": "mAP50"}[task]
            entry = {"train_s": train_s, "val": {k: v for k, v in metrics.items()
                                                  if isinstance(v, (int, float))},
                     "predicted": sum(len(r) for r in results), f"results_{field}": fields_ok}
            t_ok = key in metrics and np.isfinite(metrics[key]) and fields_ok and len(results) == 4
            if task == "pose":
                step, d, batch, res = recorded[0]
                img = batch["img"]
                cpu = DA.apply(img.cpu() * 255.0, batch["cls_boxes"].cpu(), batch["mask"].cpu(),
                               d.to("cpu"), step.augment, keypoints=batch["keypoints"].cpu(),
                               flip_idx=step.flip_idx)
                mk = cpu[2]
                errs = {"img": (res["img"].cpu() * 255.0 - cpu[0]).abs().max().item(),
                        "cls_boxes": (res["cls_boxes"].cpu() - cpu[1])[mk].abs().max().item(),
                        "mask_equal": bool(torch.equal(res["mask"].cpu(), mk)),
                        "keypoints": (res["keypoints"].cpu() - cpu[3]).abs().max().item()}
                entry["devaug_card_vs_cpu"] = errs
                t_ok &= (errs["mask_equal"] and errs["cls_boxes"] <= 1e-3
                         and errs["keypoints"] <= 1e-3 and errs["img"] <= 0.1)
            entry["ok"] = bool(t_ok)
            out[task] = entry
            ok &= bool(t_ok)
            del m
            torch.cuda.empty_cache()
    out["nvidia_smi"] = smi_line
    return ok, out


def make_task_set(root: str, task: str) -> str:
    from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset

    return make_synthetic_dataset(root, n_train=8, n_val=4, width=FIT_WH[0], height=FIT_WH[1],
                                  seed=0, task=task)


def phase_tasks_path(smi_line):
    """The three flagships at their public configurations (params and
    strides, ``task_inference``, fp32 and AMP ``task_train`` at batch 8,
    ``task_card_vs_cpu``), the other ten YAMLs (built, one inference and
    one fp32 step at batch 8, 640 px), then ``task_facade``. No hand
    kernel runs: the counts, set to 0 just before, stay 0."""
    import torch

    t_phase = time.perf_counter()
    zero_all_kernel_counts()
    failed, img_s = [], {}
    for label, cfg, nc, kpt, imgsz, strides, params in TASK_FLAGSHIPS:
        t0 = time.perf_counter()
        model = task_model(cfg, nc=nc, kpt_shape=kpt)
        built_ok = model.num_params() == params and model.strides == strides
        frames = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)).cuda()
        batch = task_batch(model, "cuda", BATCH, imgsz)
        inf_ok, inf = task_inference(model, frames, imgsz)
        fp32_ok, fp32 = task_train(model, batch, amp=False)
        amp_ok, amp = task_train(model, batch, amp=True)
        cpu_ok, vs_cpu = task_card_vs_cpu(model, imgsz, TASK_GRAD_TOL.get(label, TOL_REL))
        ok = built_ok and inf_ok and fp32_ok and amp_ok and cpu_ok
        emit({"phase": f"tasks_path.{label}", "yaml": cfg, "task": model.task, "nc": model.nc,
              "kpt_shape": model.kpt_shape if model.task == "pose" else None,
              "params": model.num_params(), "params_jax": params, "strides": model.strides,
              "batch": BATCH, "imgsz": imgsz, "inference": inf, "train_fp32": fp32,
              "train_amp": amp, **vs_cpu, "seconds": time.perf_counter() - t0, "ok": ok})
        if not ok:
            failed.append(label)
        img_s[label] = (inf["img_per_s"], fp32["img_per_s"], amp["img_per_s"])
        del model
        torch.cuda.empty_cache()
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)).cuda()
    for label, cfg, scale, strides, params in TASK_OTHERS:
        t0 = time.perf_counter()
        model = task_model(cfg, scale=scale)
        built_ok = model.num_params() == params and model.strides == strides
        inf_ok, inf = task_inference(model, frames, IMGSZ, iters=1)
        train_ok, train = zoo_train(model, task_batch(model, "cuda", BATCH, IMGSZ))
        ok = built_ok and inf_ok and train_ok
        emit({"phase": f"tasks_path.{label}", "yaml": cfg, "task": model.task,
              "params": model.num_params(), "params_jax": params, "strides": model.strides,
              "inference_ms": inf["total_ms"], "train_ms": train["total_ms"],
              "peak_gib": max(inf["peak_gib"], train["peak_gib"]),
              "seconds": time.perf_counter() - t0, "ok": ok})
        if not ok:
            failed.append(label)
        img_s[label] = (inf["img_per_s"], train["img_per_s"])
        del model
        torch.cuda.empty_cache()
    facade_ok, facade = task_facade(smi_line)
    counts = all_kernel_counts()
    ok = not failed and facade_ok and not any(counts.values())
    emit({"phase": "tasks_path", "models": len(TASK_FLAGSHIPS) + len(TASK_OTHERS),
          "failed": failed, "img_per_s": img_s, "facade": facade, "launches": counts,
          "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError(f"tasks_path check failed: {failed or 'facade or launches'}")
    return {k: v for k, v in counts.items() if v}


# classify_path: the classify task at ImageNet-1k's public configuration
# (Ultralytics imagenet.yaml: 1000 classes; 224 px; batch 64, as cls_path runs
# VisionLSTM2). The six -cls YAMLs at 1000 classes: (label, YAML, the JAX
# TaskModel's parameters there; tests/test_torch_classify.py holds the port to
# the same counts), yolo11n-cls first
CLASSIFY_MODELS = [("yolo11n-cls", "yolo11n-cls.yaml", 2_812_104),
                   ("yolov8n-cls", "yolov8n-cls.yaml", 2_719_288),
                   ("yolo12n-cls", "yolo12n-cls.yaml", 2_999_496),
                   ("yolov8-cls-resnet50", "yolov8-cls-resnet50.yaml", 27_413_032),
                   ("yolov8-cls-resnet101", "yolov8-cls-resnet101.yaml", 46_405_160),
                   ("yolo11-cls-resnet18", "yolo11-cls-resnet18.yaml", 13_115_432)]
VIL_CLASSIFIER = "vil-classifier"  # vil_yolo.yaml rows 0-9 at scale n under Classify
VIL_CLASSIFIER_PARAMS = 2_913_748
CLASSIFY_SRC_HW = (375, 500)  # the size of a typical ImageNet photo
# K3 and K2 at the ViL classifier's three stages at 224 px (name, S, DIM, INNER, NH, batch)
CLASSIFY_CASES = [("cls224_P3_S784", 784, 64, 128, 2, CLS_BATCH),
                  ("cls224_P4_S196", 196, 128, 256, 4, CLS_BATCH),
                  ("cls224_P5_S49", 49, 256, 512, 8, CLS_BATCH)]
CLASSIFY_VS_CPU = ("yolo11n-cls", "yolov8-cls-resnet50", VIL_CLASSIFIER)
# fixed limits of the fp32 gradients against the CPU where the exact gradient is
# ill-conditioned: ResNet-50's train-mode step at batch 2 moves by 0.13-0.15 of a
# tensor's max in fp64 when every weight moves one fp32 ulp (classify_card_vs_cpu
# prints it as ulp_spread), and its fp32 steps lie 0.15-0.27 from fp64
CLASSIFY_GRAD_TOL = {"yolov8-cls-resnet50": 0.5}
FP64_TOL = 1e-6  # the card's fp64 step against the CPU's on the same choices
# the first train batch of make_classify_dataset(seed=0) through
# build_dataloader(task="classify", batch=8, imgsz=64, seed=0) at the default
# keys: SHA-256 of its float32 img bytes then its int64 label bytes, the value
# tests/test_torch_classify_data.py pins on the CPU
CLASSIFY_BATCH_SHA256 = "4a2b4809f6b44db067772a0796d301ceecf4e60cfa2223cca993eb95683e22e2"
CLASSIFY_FACADE_IMGSZ = 64


def vil_classifier_graph() -> dict:
    """The ViL-YOLO-n backbone (``vil_yolo.yaml`` rows 0-9) under a
    ``Classify`` head at 1000 classes: the dict the JAX graph builds too."""
    import copy

    from xlstm_yolo_torch.cfg import load_model_yaml

    cfg, _ = load_model_yaml("vil_yolon.yaml")
    return {"nc": 1000, "scales": cfg["scales"], "backbone": copy.deepcopy(cfg["backbone"]),
            "head": [[-1, 1, "Classify", ["nc"]]]}


def classify_model(label: str, cfg=None, device="cuda"):
    """``TaskModel`` of a CLASSIFY_MODELS YAML at 1000 classes, or the ViL
    classifier with seeded gate kernels; weights from seed 0."""
    from xlstm_yolo_torch.nn.tasks import TaskModel

    if label == VIL_CLASSIFIER:
        return seed_gates(TaskModel(vil_classifier_graph(), scale="n", device=device, seed=0))
    return TaskModel(cfg, nc=1000, device=device, seed=0)


def classify_batch(device, batch: int = CLS_BATCH, imgsz: int = CLS_HW) -> dict:
    """Seeded uint8 images and labels of the 1000 classes."""
    import torch

    rng = np.random.default_rng(6)
    return {"img": torch.from_numpy(rng.integers(0, 256, (batch, imgsz, imgsz, 3),
                                                 dtype=np.uint8)).to(device),
            "label": torch.from_numpy(rng.integers(0, 1000, batch)).to(device)}


def classify_inference(model, frames, dtype: str = "float32", iters: int = ZOO_INFER_TIMED):
    """``Predictor`` inference of a fused copy of ``model`` on uint8 ``frames``
    (on the card): letterbox, then forward and softmax; the probabilities'
    checks (shape, finite, rows summing to 1), the first call's launches of
    COUNTED, stage ms (CUDA events, the mean of ``iters`` after that call),
    img/s and peak GiB. Returns (ok,
    numbers, the first call's probabilities, the predictor)."""
    import copy

    import torch

    from xlstm_yolo_torch.engine.predictor import Predictor
    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn

    fused = fuse_conv_bn(copy.deepcopy(model).eval())
    pred = Predictor(fused, imgsz=CLS_HW, dtype=dtype, verbose=False)
    torch.cuda.reset_peak_memory_stats()
    before = kernel_counters()
    dets, _, out, _ = pred(frames)
    torch.cuda.synchronize()
    first_call = tuple((kernel_counters() - before).tolist())
    probs = out["probs"].float()
    sums = (probs.sum(-1) - 1).abs().max().item()
    shapes_ok = dets is None and tuple(probs.shape) == (len(frames), fused.nc)
    finite = bool(torch.isfinite(probs).all())
    times = {"letterbox": 0.0, "forward_softmax": 0.0}
    with torch.inference_mode():
        for it in range(1 + iters):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            x, _ = pred.preprocess(frames)
            ev[1].record()
            pred.decode(x)
            ev[2].record()
            torch.cuda.synchronize()
            if it:
                for k, (a, b) in zip(times, zip(ev[:2], ev[1:])):
                    times[k] += a.elapsed_time(b) / iters
    total_ms = sum(times.values())
    ok = shapes_ok and finite and sums <= (1e-2 if dtype == "bfloat16" else 1e-4)
    return ok, {"shapes_ok": shapes_ok, "finite": finite, "row_sum_max_err": sums,
                "launches_first_call": first_call, "ms": times, "total_ms": total_ms,
                "img_per_s": len(frames) / total_ms * 1e3,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}, probs, pred


def classify_kernel_parity() -> dict:
    """K3 and K2, fp32 and bf16, at CLASSIFY_CASES against their plain
    versions (``kernel_parity``: fp32 within TOL_REL, bf16 by
    ``compare_bf16``), on seeded layer arguments and the activations and
    carry states K3 leaves for them; not counted. Returns {kernel: {case:
    ms}}."""
    import torch

    from xlstm_yolo_torch.kernels.mlstm_bwd import (KERNEL_CS, mlstm_chunkwise_bwd,
                                                    mlstm_chunkwise_bwd_plain)
    from xlstm_yolo_torch.kernels.vil_cell import Cfg
    from xlstm_yolo_torch.kernels.vil_layer import _launch, vil_layer_fwd, vil_layer_ref

    dev = torch.device("cuda")
    timed = lambda case: case[5]
    nw = lambda args: sum(a.numel() for a in args[2:])

    def layer_case(bf16):
        def make(B, case):
            a = layer_args(B, *case[1:5], seed=case[1] + B + 50, device=dev)
            return [a[0].bfloat16(), a[1].bfloat16(), *a[2:]] if bf16 else a
        return make

    def bwd_case(bf16):
        def make(B, case):
            a = layer_case(bf16)(B, case)
            _, (_, q, k, v, ig, fg), carry = _launch(a, Cfg(case[4]), bf16)
            dh = torch.from_numpy(np.random.default_rng(case[1] + B + 51).normal(
                size=(B, case[1], case[3])).astype(np.float32)).to(dev)
            return (q, k, v, ig, fg, dh), carry
        return make

    run_k2 = lambda args, case: mlstm_chunkwise_bwd(*args[0], case[4], carry=args[1])
    out = {}
    for name, res in (
            ("vil_layer_fwd", kernel_parity(
                "vil_layer_fwd", CLASSIFY_CASES, layer_case(False),
                lambda args, case: (vil_layer_fwd(*args, case[4], chunk_size=CHUNK),),
                lambda args, case: (vil_layer_ref(*args, case[4], chunk_size=CHUNK),),
                lambda args, case: vil_bound("layer", case[5], *case[1:5], nw(args)),
                batch_of=timed)),
            ("mlstm_chunkwise_bwd", kernel_parity(
                "mlstm_chunkwise_bwd", CLASSIFY_CASES, bwd_case(False), run_k2,
                lambda args, case: mlstm_chunkwise_bwd_plain(*args[0], case[4]),
                lambda args, case: bwd_bound(case[5], case[1], case[3], case[4]),
                batch_of=timed)),
            ("vil_layer_fwd_bf16", kernel_parity(
                "vil_layer_fwd_bf16", CLASSIFY_CASES, layer_case(True),
                lambda args, case: (vil_layer_fwd(*args, case[4]),),
                lambda args, case: (vil_layer_ref(*args, case[4], chunk_size=KERNEL_CS,
                                                  keep_fp32=True),),
                lambda args, case: bf16_vil_bound(case[5], *case[1:5], nw(args)),
                batch_of=timed, cmp=compare_bf16, metric=BF16_METRIC)),
            ("mlstm_chunkwise_bwd_bf16", kernel_parity(
                "mlstm_chunkwise_bwd_bf16", CLASSIFY_CASES, bwd_case(True), run_k2,
                lambda args, case: mlstm_chunkwise_bwd_plain(*args[0], case[4], keep_fp32=True),
                lambda args, case: bf16_bwd_bound(case[5], case[1], case[3], case[4]),
                batch_of=timed, cmp=compare_bf16, tol=TOL_BF16_GRAD, metric=BF16_METRIC))):
        out[name] = res["ms_by_case"]
    torch.cuda.empty_cache()
    return out


def vil_classifier_vs_plain(model, frames, batch) -> tuple:
    """The ViL classifier against its plain-forced twin at the model
    boundary. (a) fp32 ``Predictor`` inference: the probabilities within
    TOL_REL of their max. (b) bf16 serving (``dtype="bfloat16"``): the
    probabilities within TOL_REL absolute (as ``main_path_bf16`` holds its
    scores), the relative L2 of the logits printed beside the plain
    versions' own fp32-vs-bf16 gap. (c) An fp32 step (forward,
    cross-entropy, backward), the plain-forced one on the kernels' step's
    max-pool argmax (``SharedChoices``: the SPPF's pools over the 7 x 7 map
    flip under the kernels' other rounding, and a flip moved a gradient by
    9e-2 of its max): the loss within TOL_REL, every gradient within
    TOL_REL of its own max (``grad_errors``). (d) An AMP step: the
    loss within 1e-2, the gradient no further from the plain-forced AMP
    step's than 1.5 times the plain-forced fp32 step's distance from it
    (``grad_dist``), and each ViL layer call of it against its plain version
    on the inputs and output gradient it saw (``bf16_layer_grads``), as
    ``train_loop_amp``. Launches per run: K3 3 (a), K3 bf16 3 (b), K3 3 and
    K2 3 (c), K3 bf16 3 and K2 bf16 3 (d); none plain-forced. Returns (ok,
    numbers)."""
    import copy

    import torch

    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn

    n = 3
    out, ok = {}, True
    # (a), (b): inference
    for dtype, expect in (("float32", (n, 0, 0, 0)), ("bfloat16", (0, n, 0, 0))):
        inf_ok, inf, probs, pred = classify_inference(model, frames, dtype=dtype, iters=3)
        launches = inf["launches_first_call"]
        with torch.inference_mode():
            x, _ = pred.preprocess(frames)
            logits_k = pred.model(x.permute(0, 3, 1, 2)).float()
            before = kernel_counters()
            with plain_vil_kernels():
                ref = pred.decode(x)["probs"].float()
                logits_p = pred.model(x.permute(0, 3, 1, 2)).float()
            plain_launches = tuple((kernel_counters() - before).tolist())
        entry = {"launches": launches, "expected_launches": expect, "inference": inf}
        if dtype == "float32":
            rel = ((probs - ref).abs().max() / ref.abs().max()).item()
            entry["probs_maxrelerr_vs_plain"] = rel
            good = rel <= TOL_REL
        else:
            fused32 = fuse_conv_bn(copy.deepcopy(model).eval())
            with plain_vil_kernels(), torch.inference_mode():
                logits32 = fused32(pred.preprocess(frames)[0].float().permute(0, 3, 1, 2))
            abs_err = (probs - ref).abs().max().item()
            l2 = lambda a, b: ((a - b).norm() / b.norm()).item()
            entry.update({"probs_max_abs_err_vs_plain": abs_err,
                          "logits_rel_l2_vs_plain": l2(logits_k, logits_p),
                          "logits_rel_l2_plain_fp32_gap": l2(logits32.float(), logits_p),
                          "top1_agree_with_plain": (probs.argmax(-1) == ref.argmax(-1))
                          .float().mean().item()})
            good = abs_err <= TOL_REL
            del fused32
        entry["ok"] = bool(inf_ok and good and launches == expect
                           and plain_launches == (0, 0, 0, 0))
        out[f"inference_{dtype}"] = entry
        ok &= entry["ok"]
        del pred
    # (c): the fp32 step, the plain-forced one on the kernels' step's max-pool argmax
    steps, choices = {}, SharedChoices()
    for kind in ("kernels", "plain"):
        step = TrainStep(copy.deepcopy(model), amp=False)
        shared = (choices if kind == "kernels" else SharedChoices(replay=choices)).active()
        with plain_vil_kernels() if kind == "plain" else nullcontext(), shared:
            before = kernel_counters()
            total, _ = step.forward_loss(batch)
            step.backward(total)
            torch.cuda.synchronize()
            launches = tuple((kernel_counters() - before).tolist())
        steps[kind] = (float(total.detach()), {k: p.grad for k, p in step.model.named_parameters()},
                       launches)
        del step
    (loss_k, grads_k, launches), (loss_p, grads_p, plain_launches) = (steps["kernels"],
                                                                      steps["plain"])
    worst_rel, worst_name, vanishing, gmax = grad_errors(grads_k, grads_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    good = (launches == (n, 0, n, 0) and plain_launches == (0, 0, 0, 0) and loss_rel <= TOL_REL
            and worst_rel <= TOL_REL and all(bool(torch.isfinite(g).all())
                                             for g in grads_k.values()))
    out["step_fp32"] = {"launches": launches, "loss": loss_k, "loss_plain": loss_p,
                        "loss_relerr": loss_rel, "grad_maxrelerr": worst_rel,
                        "grad_worst": worst_name, "grads_vanishing": vanishing, "grad_max": gmax,
                        "ok": bool(good)}
    ok &= good
    del steps, grads_k, grads_p
    # (d): the AMP step
    first, calls = {}, []
    for kind in ("kernels", "plain", "plain_fp32"):
        step = TrainStep(copy.deepcopy(model), amp=kind != "plain_fp32")
        record = recording_vil_layers(calls) if kind == "kernels" else nullcontext()
        with plain_vil_kernels() if kind != "kernels" else nullcontext(), record:
            before = kernel_counters()
            total, _ = step.forward_loss(batch)
            step.backward(total)
            torch.cuda.synchronize()
            launches = tuple((kernel_counters() - before).tolist())
        first[kind] = (float(total.detach()),
                       {k: p.grad for k, p in step.model.named_parameters()}, launches)
        del step
    (loss_k, grads_k, launches), (loss_p, grads_p, plain_launches) = (first["kernels"],
                                                                      first["plain"])
    loss_32, grads_32, _ = first["plain_fp32"]
    dist, gap = grad_dist(grads_k, grads_p), grad_dist(grads_32, grads_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    del first, grads_k, grads_p, grads_32
    with uncounted():
        layers = [bf16_layer_grads(**c) for c in calls]
    del calls
    good = (launches == (0, n, 0, n) and plain_launches == (0, 0, 0, 0) and loss_rel <= 1e-2
            and dist <= 1.5 * gap and len(layers) == n and all(lay["ok"] for lay in layers))
    out["step_amp"] = {"launches": launches, "loss": loss_k, "loss_plain": loss_p,
                       "loss_plain_fp32": loss_32, "loss_relerr": loss_rel, "grad_dist": dist,
                       "grad_dist_fp32_gap": gap, "vil_layers": layers, "ok": bool(good)}
    ok &= good
    torch.cuda.empty_cache()
    return bool(ok), out


def classify_card_vs_cpu(model, grad_tol: float = TOL_REL) -> tuple:
    """The card against the CPU on ``model``'s weights at batch
    YOLO11_CPU_BATCH, 224 px: the fused eval's probabilities within TOL_REL
    of their max; one fp32 train step's loss within TOL_REL and every
    gradient (``zoo_step``) within ``grad_tol`` of its own max, both steps
    on one set of discrete choices (``SharedChoices``: the max pools'
    argmax), those of an fp64 step on the card, held to that step too;
    every step on the same images (``zoo_step``'s ``host_divide``).
    Without ViL layers, the fp64 step also on the CPU: its loss and
    gradients within FP64_TOL of the card's; and the card's fp64 step on
    weights one fp32 ulp up, whose distance from it (``ulp_spread``) is the
    gradient's own conditioning. The ViL classifier's kernels take no fp64:
    there the choices are the fp32 card step's own, and its gradients are
    held to the CPU's."""
    import copy

    import torch

    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn

    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (YOLO11_CPU_BATCH, CLS_HW, CLS_HW, 3)).astype(np.float32))
    fused = fuse_conv_bn(copy.deepcopy(model).eval())
    probs = {}
    for dev in ("cuda", "cpu"):
        with torch.no_grad():
            probs[dev] = copy.deepcopy(fused).to(dev).predictions_full(x.to(dev))["probs"].cpu()
    probs_rel = ((probs["cuda"] - probs["cpu"]).abs().max() / probs["cpu"].abs().max()).item()
    batch = {k: v.cpu() for k, v in classify_batch("cpu", YOLO11_CPU_BATCH).items()}
    vil = any(m.__class__.__name__ == "MatrixLSTMCell" for m in model.modules())
    ref = SharedChoices()
    ref_loss, ref_grads = zoo_step(model, "cuda", torch.float32 if vil else torch.float64,
                                   batch, ref, host_divide=True)
    fp64 = {}
    if not vil:
        cpu_loss, cpu_grads = zoo_step(model, "cpu", torch.float64, batch,
                                       SharedChoices(replay=ref), host_divide=True)
        nudged = copy.deepcopy(model)
        with torch.no_grad():
            for p in nudged.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
        ulp_grads = zoo_step(nudged, "cuda", torch.float64, batch, SharedChoices(replay=ref),
                             host_divide=True)[1]
        del nudged
        fp64 = {"fp64_loss_relerr_vs_cpu": abs(cpu_loss - ref_loss) / abs(ref_loss),
                "fp64_grad_maxrelerr_vs_cpu": grad_errors(cpu_grads, ref_grads)[0],
                "ulp_spread": grad_errors(ulp_grads, ref_grads)[:2],
                "ulp_spread_rel_l2": grad_dist(ulp_grads, ref_grads)}
        del cpu_grads, ulp_grads
    steps = {dev: zoo_step(model, dev, torch.float32, batch, SharedChoices(replay=ref),
                           host_divide=True) for dev in ("cuda", "cpu")}
    worst_rel, worst_name, vanishing, gmax = grad_errors(steps["cuda"][1], steps["cpu"][1])
    loss_rel = abs(steps["cuda"][0] - steps["cpu"][0]) / abs(steps["cpu"][0])
    vs_ref = {dev: grad_errors(steps[dev][1], ref_grads)[:2] for dev in steps}
    ok = (probs_rel <= TOL_REL and loss_rel <= TOL_REL and worst_rel <= grad_tol
          and (vil or (vs_ref["cuda"][0] <= grad_tol
                       and fp64["fp64_loss_relerr_vs_cpu"] <= FP64_TOL
                       and fp64["fp64_grad_maxrelerr_vs_cpu"] <= FP64_TOL)))
    return ok, {"probs_maxrelerr_vs_cpu": probs_rel, **fp64, "grad_tol": grad_tol,
                "grad_rel_l2_vs_cpu": grad_dist(steps["cuda"][1], steps["cpu"][1]),
                "loss": steps["cuda"][0],
                "loss_cpu": steps["cpu"][0], "loss_reference": ref_loss,
                "reference": "card fp32, own choices" if vil else "card fp64",
                "loss_relerr_vs_cpu": loss_rel, "grad_maxrelerr_vs_cpu": worst_rel,
                "grad_worst": worst_name, "grads_vanishing": vanishing, "grad_max": gmax,
                "grad_maxrelerr_vs_reference": {d: v[0] for d, v in vs_ref.items()},
                "pooled": len(ref.pooled)}


def classify_facade(smi_line) -> tuple:
    """``YOLO("yolo11n-cls.yaml")`` on the card through the user's entry
    points, on a PNG class set it writes (``make_classify_dataset``: three
    classes, 8 train and 4 val images each at four sizes and aspect
    ratios): the set's first train batch at the default keys against the
    hash the CPU tests pin (CLASSIFY_BATCH_SHA256); two epochs at the
    defaults (bf16 AMP, RandAugment, erasing) at 64 px, batch 8; ``val``
    with ``accuracy_top1`` and ``accuracy_top5``; ``predict`` of a val
    folder with ``Results.probs``."""
    import hashlib
    import tempfile

    import torch

    from xlstm_yolo_torch import YOLO
    from xlstm_yolo_torch.cfg import DEFAULT_CFG_DICT
    from xlstm_yolo_torch.data.dataset import build_dataloader
    from xlstm_yolo_torch.data.synthetic import make_classify_dataset

    with tempfile.TemporaryDirectory() as tmp:
        root = make_classify_dataset(f"{tmp}/set", n_train=8, n_val=4, seed=0)
        loader, _ = build_dataloader(root, "train", batch=8, imgsz=CLASSIFY_FACADE_IMGSZ,
                                     hyp=dict(DEFAULT_CFG_DICT), task="classify", seed=0)
        first = list(loader)[0]
        digest = hashlib.sha256(first["img"].tobytes() + first["label"].tobytes()).hexdigest()
        m = YOLO("yolo11n-cls.yaml")
        t0 = time.perf_counter()
        train_metrics = m.train(data=root, epochs=2, imgsz=CLASSIFY_FACADE_IMGSZ, batch=8,
                                plots=False, project=f"{tmp}/runs", name="cls")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        metrics = m.val(data=root, imgsz=CLASSIFY_FACADE_IMGSZ, batch=8)
        results = m.predict(f"{root}/val/circle", imgsz=CLASSIFY_FACADE_IMGSZ, verbose=False)
    probs_ok = all(r.probs is not None and r.probs.data.shape == (3,) and r.boxes is None
                   and 0 <= r.probs.top1 < 3 and sorted(r.probs.top5) == [0, 1, 2]
                   for r in results)
    ok = (digest == CLASSIFY_BATCH_SHA256 and m.model.nc == 3 and len(results) == 4 and probs_ok
          and {"accuracy_top1", "accuracy_top5"} <= set(metrics)
          and metrics["images"] == 12 and metrics["accuracy_top5"] == 1.0)
    return ok, {"batch_sha256": digest, "batch_sha256_expected": CLASSIFY_BATCH_SHA256,
                "batch_labels": first["label"].tolist(), "train_s": train_s,
                "train_metrics": train_metrics,
                "val": {k: v for k, v in metrics.items() if isinstance(v, (int, float))},
                "predicted": [{"top1": r.probs.top1, "top5": r.probs.top5,
                               "top1conf": float(r.probs.top1conf)} for r in results],
                "nvidia_smi": smi_line}


def phase_classify_path(smi_line):
    """The classify task. K3 and K2 (fp32, bf16) at the ViL classifier's
    grids against their plain versions (``classify_kernel_parity``,
    uncounted); then, the counts set to 0: yolo11n-cls at ImageNet-1k's
    configuration (1000 classes, 224 px, batch 64: parameters equal to
    JAX's, fused ``Predictor`` inference on uint8 375 x 500 frames, fp32
    and AMP train steps, each launching no hand kernel); the other five
    YAMLs (built, one inference and one fp32 step); the ViL classifier
    against its plain-forced twin (``vil_classifier_vs_plain``) and timed;
    yolo11n-cls, yolov8-cls-resnet50 and the ViL classifier against the CPU
    (``classify_card_vs_cpu``); ``classify_facade``. Returns (the path's
    kernel counts, {kernel: {case: ms}})."""
    import torch

    t_phase = time.perf_counter()
    ms_by_case = classify_kernel_parity()
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (CLS_BATCH, *CLASSIFY_SRC_HW, 3), dtype=np.uint8)).cuda()
    batch = classify_batch("cuda")
    zero_all_kernel_counts()
    failed, img_s = [], {}
    for i, (label, cfg, params) in enumerate(CLASSIFY_MODELS):
        t0 = time.perf_counter()
        model = classify_model(label, cfg)
        before = all_kernel_counts()
        inf_ok, inf, _, _ = classify_inference(model, frames,
                                               iters=ZOO_INFER_TIMED if i == 0 else 1)
        fp32_ok, fp32 = task_train(model, batch, amp=False)
        amp_ok, amp = task_train(model, batch, amp=True) if i == 0 else (True, None)
        cpu_ok, vs_cpu = (classify_card_vs_cpu(model, CLASSIFY_GRAD_TOL.get(label, TOL_REL))
                          if label in CLASSIFY_VS_CPU else (True, {}))
        launched = {k: v - before[k] for k, v in all_kernel_counts().items() if v != before[k]}
        ok = (model.num_params() == params and model.task == "classify" and inf_ok and fp32_ok
              and amp_ok and cpu_ok and not launched)
        emit({"phase": f"classify_path.{label}", "yaml": cfg, "nc": model.nc,
              "params": model.num_params(), "params_jax": params, "batch": CLS_BATCH,
              "imgsz": CLS_HW, "src_hw": list(CLASSIFY_SRC_HW), "inference": inf,
              "train_fp32": fp32, **({"train_amp": amp} if amp else {}), **vs_cpu,
              "launches": launched, "seconds": time.perf_counter() - t0, "ok": ok})
        if not ok:
            failed.append(label)
        img_s[label] = (inf["img_per_s"], fp32["img_per_s"], *([amp["img_per_s"]] if amp else []))
        del model
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = classify_model(VIL_CLASSIFIER)
    twin_ok, twin = vil_classifier_vs_plain(model, frames, batch)
    timed = {}
    for amp in (False, True):
        step_ok, timed[f"train_{'amp' if amp else 'fp32'}"] = task_train(model, batch, amp=amp)
        twin_ok &= step_ok
    cpu_ok, vs_cpu = classify_card_vs_cpu(model)
    ok = model.num_params() == VIL_CLASSIFIER_PARAMS and twin_ok and cpu_ok
    emit({"phase": f"classify_path.{VIL_CLASSIFIER}", "graph": "vil_yolo.yaml rows 0-9, scale n, "
          "Classify [1000]", "params": model.num_params(), "params_jax": VIL_CLASSIFIER_PARAMS,
          "batch": CLS_BATCH, "imgsz": CLS_HW, **twin, **timed, **vs_cpu,
          "seconds": time.perf_counter() - t0, "ok": ok})
    if not ok:
        failed.append(VIL_CLASSIFIER)
    img_s[VIL_CLASSIFIER] = (twin["inference_float32"]["inference"]["img_per_s"],
                             twin["inference_bfloat16"]["inference"]["img_per_s"],
                             timed["train_fp32"]["img_per_s"], timed["train_amp"]["img_per_s"])
    del model
    torch.cuda.empty_cache()
    facade_ok, facade = classify_facade(smi_line)
    counts = {k: v for k, v in all_kernel_counts().items() if v}
    ok = not failed and facade_ok and set(counts) == {
        "vil_layer_fwd", "vil_layer_fwd_bf16", "mlstm_chunkwise_bwd", "mlstm_chunkwise_bwd_bf16"}
    emit({"phase": "classify_path", "models": len(CLASSIFY_MODELS) + 1, "failed": failed,
          "img_per_s": img_s, "facade": facade, "launches": counts,
          "classify_ms_by_case": ms_by_case, "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError(f"classify_path check failed: {failed or 'facade or launches'}")
    return counts, ms_by_case


# rtdetr_path: RT-DETR at COCO's configuration, as the rt-detr YAMLs set it
# and Ultralytics trains and serves it (80 classes, 640 px), at batch 8:
# (label, YAML, scale, the JAX TaskModel's parameters at 80 classes;
# tests/test_torch_rtdetr.py holds the port to the same counts), rtdetr-l
# first
RTDETR_MODELS = [("rtdetr-l", "rtdetr-l.yaml", None, 32_970_476),
                 ("rtdetr-x", "rtdetr-x.yaml", None, 67_467_852),
                 ("rtdetr-resnet50", "rtdetr-resnet50.yaml", None, 42_925_132),
                 ("rtdetr-resnet101", "rtdetr-resnet101.yaml", None, 61_917_260),
                 ("yolov8n-rtdetr", "yolov8-rtdetr.yaml", "n", 9_643_868)]
RTDETR_CPU_IMGSZ = 320  # the card against the CPU: a size the CPU steps rtdetr-l at in seconds
# rtdetr-l's fp32 gradients against the CPU's and the fp64 step's, on shared
# choices (sampling cells, selections, matches, pool argmax): the largest
# error of any entry over the model's largest gradient (``grad_spread``).
# On seeded weights the train-mode network amplifies a relative perturbation
# about 1e6-fold from the stem to the last decoder layer, so each tensor of
# its own max is no measure: one-ulp weight moves change a box head's fp64
# gradient by a third. From ``tools/zoo_grad_probe.py rtdetr-l --nudges 4``
# on an H100 (NVIDIA H100 80GB HBM3, 700 W): fp32 steps on weights moved
# below fp32's resolution stand 0.051-0.064 from the unmoved fp32 step
# (fp64 ones 0.020-0.025), the card's fp32 step 0.054-0.072 from the
# CPU's; TF32 convolutions and products would stand far beyond. The same
# function on both devices is held in fp64 instead: the CPU's fp64 step on
# the card's fp64 choices within RTDETR_FP64_TOL of the card's, each tensor
# of its own max
RTDETR_GRAD_TOL = 0.1
RTDETR_FP64_TOL = 1e-6
# an AMP step's loss against the fp32 step's on the same weights and batch:
# the bound tests/test_torch_detect_zoo.py holds the zoo's AMP steps to
AMP_LOSS_TOL = 5e-2


def device_busy_ms(fn, calls: int = 2) -> float:
    """The device's busy ms a call of ``fn`` (the sum of its kernels' device
    times under ``torch.profiler``), after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls


def rtdetr_inference(model, frames, dtype: str = "float32", iters: int = ZOO_INFER_TIMED):
    """``Predictor`` inference of a fused copy of ``model`` in ``dtype`` on
    uint8 ``frames`` (on the card): letterbox, the forward with its NMS-free
    decode (``predictions_full``), the conf filter; stage ms (CUDA events,
    the mean of ``iters`` after one warm-up), img/s, the device's busy ms a
    forward (profiler), peak GiB; the dets finite, (B, 300, 6), some above
    conf."""
    import copy

    import torch

    from xlstm_yolo_torch.engine.predictor import Predictor
    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn

    fused = fuse_conv_bn(copy.deepcopy(model).eval())
    pred = Predictor(fused, imgsz=IMGSZ, dtype=dtype, verbose=False)
    torch.cuda.reset_peak_memory_stats()
    times = {"letterbox": 0.0, "forward_decode": 0.0, "conf_filter": 0.0}
    with torch.inference_mode():
        for it in range(1 + iters):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            x, _ = pred.preprocess(frames)
            ev[1].record()
            full = pred.decode(x)
            ev[2].record()
            dets, valid = pred.postprocess(full)
            ev[3].record()
            torch.cuda.synchronize()
            if it:
                for k, (a, b) in zip(times, zip(ev[:3], ev[1:])):
                    times[k] += a.elapsed_time(b) / iters
        busy = device_busy_ms(lambda: pred.decode(x))
    total_ms = sum(times.values())
    shapes_ok = tuple(dets.shape) == (len(frames), 300, 6)
    finite = bool(torch.isfinite(dets).all())
    n_valid = int(valid.sum())
    return shapes_ok and finite and n_valid > 0, {
        "dtype": dtype, "shapes_ok": shapes_ok, "finite": finite, "valid_dets": n_valid,
        "ms": times, "total_ms": total_ms, "img_per_s": len(frames) / total_ms * 1e3,
        "forward_device_busy_ms": busy, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def rtdetr_batch(model, device, batch: int, imgsz: int) -> dict:
    """``train_batch``'s images and labels at ``imgsz`` (the boxes scaled),
    with denoising queries drawn once (3 groups, seeded) for every step that
    takes the batch."""
    import torch

    from xlstm_yolo_torch.nn import rtdetr as R

    b = train_batch("cpu", batch=batch)
    f = imgsz / IMGSZ
    cb = b["cls_boxes"].clone()
    cb[..., 1:] *= f
    img = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8))
    gt_cls, gt_box = R._gt_targets({"cls_boxes": cb}, float(imgsz), torch.float32)
    dn = R.get_cdn_group(gt_cls, gt_box, b["mask"].float(), model.nc,
                         torch.Generator().manual_seed(0))[:2]
    return {"img": img.to(device), "cls_boxes": cb.to(device), "mask": b["mask"].to(device),
            "dn_queries": tuple(t.to(device) for t in dn)}


def rtdetr_card_vs_cpu(model, imgsz: int = RTDETR_CPU_IMGSZ) -> tuple:
    """The card against the CPU on ``model``'s weights at batch
    YOLO11_CPU_BATCH and ``imgsz``: the fused eval's dets (boxes and
    scores within TOL_REL of their max, classes equal) with the card on the
    CPU's selections; one fp32 train step's loss within TOL_REL and its
    gradients within RTDETR_GRAD_TOL of the CPU's and of the fp64 step's
    (``grad_spread``'s largest error over the model's largest gradient;
    each tensor's error over its own max printed beside); the CPU's fp64
    step within RTDETR_FP64_TOL of the card's (loss and every gradient, each
    tensor of its own max); all steps on the discrete choices of an fp64
    step on the card (``SharedChoices``: the query selection, the
    deformable sampling's grid cells, the Hungarian matches, HGStem's
    max-pool argmax) and on one draw of the denoising queries. Beside: the
    choices that the card's fp32 step and eval, left to make their own,
    make otherwise."""
    import copy

    import torch

    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn

    shape = (YOLO11_CPU_BATCH, imgsz, imgsz, 3)
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32))
    fused = fuse_conv_bn(copy.deepcopy(model).eval())
    rec = SharedChoices()
    with torch.no_grad():
        with rec.active():
            want = copy.deepcopy(fused).cpu().predictions_full(x)["dets"]
        with SharedChoices(replay=rec).active():
            got = copy.deepcopy(fused).cuda().predictions_full(x.cuda())["dets"].cpu()
        own = SharedChoices()
        with own.active():
            copy.deepcopy(fused).cuda().predictions_full(x.cuda())
    rel = lambda g, w: ((g - w).abs().max() / w.abs().max()).item()
    errs = {"boxes": rel(got[..., :4], want[..., :4]), "scores": rel(got[..., 4], want[..., 4]),
            "class_mismatches": int((got[..., 5] != want[..., 5]).sum())}
    batch = rtdetr_batch(model, "cpu", YOLO11_CPU_BATCH, imgsz)
    # every step on images divided on the host (the card's x / 255 rounds
    # some pixels an ulp apart, which this network amplifies)
    ref = SharedChoices()
    ref_loss, ref_grads = zoo_step(model, "cuda", torch.float64, batch, ref, host_divide=True)
    own_step = SharedChoices()
    zoo_step(model, "cuda", torch.float32, batch, own_step, host_divide=True)
    steps = {dev: zoo_step(model, dev, torch.float32, batch, SharedChoices(replay=ref),
                           host_divide=True) for dev in ("cuda", "cpu")}
    worst_rel, worst_name, vanishing, gmax = grad_errors(steps["cuda"][1], steps["cpu"][1])
    spread = grad_spread(steps["cuda"][1], steps["cpu"][1])
    loss_rel = abs(steps["cuda"][0] - steps["cpu"][0]) / abs(steps["cpu"][0])
    vs64 = {dev: grad_errors(steps[dev][1], ref_grads)[:2] for dev in steps}
    spread64 = {dev: grad_spread(steps[dev][1], ref_grads) for dev in steps}
    cpu64_loss, cpu64_grads = zoo_step(model, "cpu", torch.float64, batch,
                                       SharedChoices(replay=ref), host_divide=True)
    fp64_rel, fp64_worst, _, _ = grad_errors(cpu64_grads, ref_grads)
    ok = (errs["boxes"] <= TOL_REL and errs["scores"] <= TOL_REL
          and errs["class_mismatches"] == 0 and loss_rel <= TOL_REL
          and spread["abs_over_grad_max"] <= RTDETR_GRAD_TOL
          and spread64["cuda"]["abs_over_grad_max"] <= RTDETR_GRAD_TOL
          and fp64_rel <= RTDETR_FP64_TOL
          and abs(cpu64_loss - ref_loss) <= RTDETR_FP64_TOL * abs(ref_loss))
    return ok, {"cpu_imgsz": imgsz, "dets_maxrelerr_vs_cpu": errs,
                "eval_card_own_choices_vs_cpu": own.flips(rec),
                "loss": steps["cuda"][0], "loss_cpu": steps["cpu"][0], "loss_fp64": ref_loss,
                "loss_relerr_vs_cpu": loss_rel, "grad_spread_vs_cpu": spread,
                "grad_spread_vs_fp64": spread64, "grad_tol": RTDETR_GRAD_TOL,
                "grad_maxrelerr_vs_cpu": worst_rel,
                "grad_worst": worst_name, "grads_vanishing": vanishing, "grad_max": gmax,
                "grad_maxrelerr_vs_fp64": {d: v[0] for d, v in vs64.items()},
                "grad_worst_vs_fp64": {d: v[1] for d, v in vs64.items()},
                "fp64_cpu_vs_card": {"loss_relerr": abs(cpu64_loss - ref_loss) / abs(ref_loss),
                                     "grad_maxrelerr": fp64_rel, "grad_worst": fp64_worst,
                                     "tol": RTDETR_FP64_TOL},
                "card_fp32_own_choices_vs_fp64": own_step.flips(ref)}


def rtdetr_facade(smi_line) -> tuple:
    """``YOLO("rtdetr-l.yaml")`` on the card through the user's entry points,
    on PNGs the phase writes (640 x 480, 8 train and 4 val images): ``val``
    refused (the JAX package cannot validate RT-DETR), one epoch at the
    defaults with ``val=False`` (bf16 AMP, denoising), ``predict``, then
    saved and reloaded: the same predictions."""
    import tempfile

    import torch

    from xlstm_yolo_torch import YOLO
    from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset

    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_dataset(f"{tmp}/ds", n_train=8, n_val=4, width=FIT_WH[0],
                                      height=FIT_WH[1], seed=0)
        val_dir = str(Path(data).parent / "images" / "val")
        m = YOLO("rtdetr-l.yaml")
        try:
            m.val(data=data, imgsz=IMGSZ)
            refused = False
        except ValueError:
            refused = True
        t0 = time.perf_counter()
        m.train(data=data, epochs=1, imgsz=IMGSZ, batch=BATCH, val=False, plots=False,
                project=f"{tmp}/runs", name="rtdetr")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        results = m.predict(val_dir, imgsz=IMGSZ, conf=0.25, verbose=False)
        m.save(f"{tmp}/w.pt")
        again = YOLO(f"{tmp}/w.pt").predict(val_dir, imgsz=IMGSZ, conf=0.25, verbose=False)
    same = len(again) == len(results) and all(
        a.boxes.data.shape == b.boxes.data.shape
        and np.allclose(a.boxes.data, b.boxes.data, rtol=1e-5, atol=1e-4)
        for a, b in zip(again, results))
    n_boxes = sum(len(r) for r in results)
    ok = (refused and m.model.task == "rtdetr" and np.isfinite(m.metrics["train_loss"])
          and len(results) == 4 and n_boxes > 0 and same)
    return ok, {"val_refused": refused, "train_s": train_s, "train_loss": m.metrics["train_loss"],
                "nc": m.model.nc, "images": len(results), "boxes": n_boxes,
                "reloaded_predictions_equal": same, "nvidia_smi": smi_line}


def phase_rtdetr_path(smi_line):
    """rtdetr-l at COCO's configuration (the JAX parameter count and
    strides; fp32 and bf16 ``rtdetr_inference``; fp32 and AMP train steps
    at batch 8 with denoising, the AMP loss within AMP_LOSS_TOL of the fp32
    one; ``rtdetr_card_vs_cpu``), the other four YAMLs (built, one
    inference and timed fp32 steps at batch 8, 640 px), ``rtdetr_facade``.
    No hand kernel runs: the counts, set to 0 just before, stay 0."""
    import torch

    from xlstm_yolo_torch.nn.tasks import TaskModel

    t_phase = time.perf_counter()
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)).cuda()
    batch = train_batch("cuda")
    zero_all_kernel_counts()
    failed, img_s = [], {}
    for i, (label, cfg, scale, params) in enumerate(RTDETR_MODELS):
        t0 = time.perf_counter()
        model = TaskModel(cfg, scale=scale, device="cuda", seed=0)
        built_ok = (model.task == "rtdetr" and model.num_params() == params
                    and model.strides == (8, 16, 32))
        gflop = forward_gflop(model)
        inf_ok, inf = rtdetr_inference(model, frames, iters=ZOO_INFER_TIMED if i == 0 else 1)
        inf["forward_tflop_per_s"] = BATCH * gflop / inf["ms"]["forward_decode"]
        entry = {"phase": f"rtdetr_path.{label}", "yaml": cfg, "scale": model.scale,
                 "nc": model.nc, "params": model.num_params(), "params_jax": params,
                 "strides": model.strides, "batch": BATCH, "imgsz": IMGSZ,
                 "forward_gflop_per_image": gflop, "inference": inf}
        if i == 0:
            bf_ok, bf16 = rtdetr_inference(model, frames, "bfloat16")
            fp32_ok, fp32 = task_train(model, batch, amp=False)
            amp_ok, amp = task_train(model, batch, amp=True)
            amp_rel = abs(amp["losses"][0] - fp32["losses"][0]) / abs(fp32["losses"][0])
            cpu_ok, vs_cpu = rtdetr_card_vs_cpu(model)
            ok = (built_ok and inf_ok and bf_ok and fp32_ok and amp_ok
                  and amp_rel <= AMP_LOSS_TOL and cpu_ok)
            entry.update({"inference_bf16": bf16, "train_fp32": fp32, "train_amp": amp,
                          "amp_loss_relerr_vs_fp32": amp_rel, "amp_loss_tol": AMP_LOSS_TOL,
                          **vs_cpu})
            img_s[label] = (inf["img_per_s"], bf16["img_per_s"], fp32["img_per_s"],
                            amp["img_per_s"])
        else:
            train_ok, train = task_train(model, batch, amp=False)
            ok = built_ok and inf_ok and train_ok
            entry["train_fp32"] = train
            img_s[label] = (inf["img_per_s"], train["img_per_s"])
        emit({**entry, "seconds": time.perf_counter() - t0, "ok": ok})
        if not ok:
            failed.append(label)
        del model
        torch.cuda.empty_cache()
    facade_ok, facade = rtdetr_facade(smi_line)
    counts = all_kernel_counts()
    ok = not failed and facade_ok and not any(counts.values())
    emit({"phase": "rtdetr_path", "models": len(RTDETR_MODELS), "failed": failed,
          "img_per_s": img_s, "facade": facade, "launches": counts,
          "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError(f"rtdetr_path check failed: {failed or 'facade or launches'}")
    return {k: v for k, v in counts.items() if v}


# world_path: YOLO-World at COCO's open-vocabulary configuration (Ultralytics'
# yolov8-world YAMLs: 80 class prompts, 640 px, batch 8), the CLIP text tower
# at ViT-B/32's published text widths, NAS and FastSAM. (label, YAML, scale,
# the JAX TaskModel's parameters; tests/test_torch_world.py holds the port to
# the same counts), yolov8l-world first
WORLD_MODELS = [("yolov8l-world", "yolov8-world.yaml", "l", 49_391_786),
                ("yolov8l-worldv2", "yolov8-worldv2.yaml", "l", 48_669_866)]
WORLD_OTHERS = [("yolov8n-world", "yolov8-world.yaml", "n", 6_032_922),
                ("yolov8s-world", "yolov8-world.yaml", "s", 16_285_258),
                ("yolov8m-world", "yolov8-world.yaml", "m", 31_844_922),
                ("yolov8x-world", "yolov8-world.yaml", "x", 74_598_426),
                ("yolov8n-worldv2", "yolov8-worldv2.yaml", "n", 5_931_418),
                ("yolov8s-worldv2", "yolov8-worldv2.yaml", "s", 16_006_986),
                ("yolov8m-worldv2", "yolov8-worldv2.yaml", "m", 31_353_018),
                ("yolov8x-worldv2", "yolov8-worldv2.yaml", "x", 73_552_282),
                ("yolo_nas_s", "yolo_nas.yaml", "s", 11_343_216),
                ("yolo_nas_m", "yolo_nas.yaml", "m", 20_274_192),
                ("yolo_nas_l", "yolo_nas.yaml", "l", 36_504_368)]
# CLIP ViT-B/32's text tower (the widths the reference downloads)
CLIP_B32 = dict(vocab_size=49408, context_length=77, width=512, heads=8, layers=12, embed_dim=512)
COCO_NAMES = (
    "person bicycle car motorcycle airplane bus train truck boat traffic_light fire_hydrant "
    "stop_sign parking_meter bench bird cat dog horse sheep cow elephant bear zebra giraffe "
    "backpack umbrella handbag tie suitcase frisbee skis snowboard sports_ball kite "
    "baseball_bat baseball_glove skateboard surfboard tennis_racket bottle wine_glass cup fork "
    "knife spoon bowl banana apple sandwich orange broccoli carrot hot_dog pizza donut cake "
    "chair couch potted_plant bed dining_table toilet tv laptop mouse remote keyboard "
    "cell_phone microwave oven toaster sink refrigerator book clock vase scissors teddy_bear "
    "hair_drier toothbrush").split()
WORLD_PADDED = 20  # a batch guide's padded slots (the empty text's one embedding), of 80
WORLD_CPU_IMGSZ = 320  # the card against the CPU: a size the CPU steps yolov8l-world at in seconds
WORLD_GRAD_TOL = TOL_REL
WORLD_FP64_TOL = 1e-6  # the CPU's fp64 step against the card's, on shared choices


def coco_prompts() -> list:
    """The 80 COCO class names as CLIP prompts."""
    assert len(COCO_NAMES) == 80
    return [f"a photo of a {n.replace('_', ' ')}" for n in COCO_NAMES]


def write_merges(path, texts) -> str:
    """A merge list in the published format (a header, then one pair a
    line) that joins each word of ``texts`` into one token, left to right."""
    from xlstm_yolo_torch.nn.clip_text import split_words

    merges, seen = [], set()
    for w in sorted({w for t in texts for w in split_words(t.lower())}):
        syms = list(w[:-1]) + [w[-1] + "</w>"]
        cur = syms[0]
        for sym in syms[1:]:
            if (cur, sym) not in seen:
                seen.add((cur, sym))
                merges.append((cur, sym))
            cur += sym
    Path(path).write_text("\n".join(["#version: world_path"] + [f"{a} {b}" for a, b in merges])
                          + "\n", encoding="utf-8")
    return str(path)


def world_tower(bpe: str) -> tuple:
    """The text tower at ViT-B/32's widths, seeded, on the card and on the
    CPU: the 80 prompts' features on the card within 1e-5 of the CPU's max;
    the card's encode ms (CUDA events, the mean of 3 after a warm-up) and
    device-busy ms; the tower's GFLOP (meta device). Returns (ok, numbers,
    the card's encoder)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from xlstm_yolo_torch.nn.clip_text import CLIPTextTower, ClipTextEncoder

    prompts = coco_prompts()
    encs = {dev: ClipTextEncoder(bpe, tower=CLIPTextTower(**CLIP_B32), n_merges=None,
                                 device=dev, seed=0) for dev in ("cuda", "cpu")}
    want = encs["cpu"].features(prompts)
    got = encs["cuda"].features(prompts).cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    ms = cuda_time_ms(lambda: encs["cuda"].features(prompts), iters=3, warmup=1)
    busy = device_busy_ms(lambda: encs["cuda"].features(prompts))
    tokens = encs["cpu"].tokenizer(prompts, CLIP_B32["context_length"])
    with torch.device("meta"):
        with FlopCounterMode(display=False) as counter:
            CLIPTextTower(**CLIP_B32)(torch.zeros(tokens.shape, dtype=torch.long))
    gflop = counter.get_total_flops() / 1e9
    feats = encs["cuda"](prompts)
    ok = (rel <= 1e-5 and tuple(got.shape) == (80, 512) and bool(np.isfinite(feats).all())
          and int(tokens.max()) < CLIP_B32["vocab_size"])
    return ok, {"prompts": len(prompts), "tokens": list(tokens.shape),
                "eot_id": int(encs["cpu"].tokenizer.eot), "features_maxrelerr_vs_cpu": rel,
                "encode_ms": ms, "encode_device_busy_ms": busy, "gflop": gflop,
                "tflop_per_s": gflop / ms}, encs["cuda"]


def zero_biases(model):
    """Detections clear the confidence threshold: a world head's
    contrastive biases set to 0 (its logits then sigmoid around 0.5), a
    Detect head's class biases (``zero_class_biases``). Returns the model."""
    import torch

    if model.task != "world":
        return zero_class_biases(model)
    head = getattr(model, f"l{model.parsed.head_index}")
    with torch.no_grad():
        for i in range(head.nl):
            getattr(head, f"cv4_{i}_attn").bias.zero_()
    return model


def world_forward_gflop(model) -> float:
    """``forward_gflop`` with the model's guide on the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from xlstm_yolo_torch.nn.graph import GraphModel

    guide = None if model.txt_feats is None else torch.zeros(model.txt_feats.shape)
    with torch.device("meta"):
        graph = GraphModel(model.parsed).eval()
        with FlopCounterMode(display=False) as counter:
            graph(torch.zeros(1, 3, IMGSZ, IMGSZ),
                  guide=None if guide is None else guide.to("meta"))
    return counter.get_total_flops() / 1e9


def world_inference(model, frames, dtype: str = "float32", iters: int = ZOO_INFER_TIMED):
    """``Predictor`` inference of a fused copy of ``model`` (``zero_biases``)
    in ``dtype`` on uint8 ``frames``: letterbox, forward and decode against
    the model's guide (fp32 in bf16 serving, as JAX leaves it), NMS; stage
    ms (CUDA events, the mean of ``iters`` after one warm-up), img/s, the
    forward's device-busy ms (profiler), peak GiB; the candidates (B, N, 4
    + nc) and dets finite, some valid."""
    import copy

    import torch

    from xlstm_yolo_torch.engine.predictor import Predictor
    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn

    fused = fuse_conv_bn(zero_biases(copy.deepcopy(model).eval()))
    pred = Predictor(fused, imgsz=IMGSZ, dtype=dtype, verbose=False)
    torch.cuda.reset_peak_memory_stats()
    times = {"letterbox": 0.0, "forward_decode": 0.0, "nms": 0.0}
    with torch.inference_mode():
        for it in range(1 + iters):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            x, _ = pred.preprocess(frames)
            ev[1].record()
            cands = pred.decode(x)
            ev[2].record()
            dets, valid = pred.postprocess(cands.float())
            ev[3].record()
            torch.cuda.synchronize()
            if it:
                for k, (a, b) in zip(times, zip(ev[:3], ev[1:])):
                    times[k] += a.elapsed_time(b) / iters
        busy = device_busy_ms(lambda: pred.decode(x))
    n_cand = sum((IMGSZ // s) ** 2 for s in fused.strides)
    shapes_ok = (tuple(cands.shape) == (len(frames), n_cand, 4 + fused.nc)
                 and tuple(dets.shape) == (len(frames), 300, 6))
    finite = bool(torch.isfinite(cands).all() and torch.isfinite(dets).all())
    n_valid = int(valid.sum())
    total_ms = sum(times.values())
    return shapes_ok and finite and n_valid > 0, {
        "dtype": dtype, "cands_dtype": str(cands.dtype), "shapes_ok": shapes_ok,
        "finite": finite, "valid_dets": n_valid, "ms": times, "total_ms": total_ms,
        "img_per_s": len(frames) / total_ms * 1e3, "forward_device_busy_ms": busy,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def world_batch(device, batch: int, imgsz: int, nt: int = 80) -> dict:
    """``train_batch``'s images and labels at ``imgsz`` (the boxes scaled)
    and a per-batch guide ``txt_feats`` (batch, nt, 512), seeded, whose last
    WORLD_PADDED slots share one embedding, as a MultiModalDataset batch's
    padded texts."""
    import torch

    b = train_batch("cpu", batch=batch)
    cb = b["cls_boxes"].clone()
    cb[..., 1:] *= imgsz / IMGSZ
    img = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8))
    txt = np.random.default_rng(6).normal(size=(batch, nt, 512)).astype(np.float32)
    txt[:, nt - WORLD_PADDED:] = txt[:, nt - WORLD_PADDED:nt - WORLD_PADDED + 1]
    return {"img": img.to(device), "cls_boxes": cb.to(device), "mask": b["mask"].to(device),
            "txt_feats": torch.from_numpy(txt).to(device)}


def world_card_vs_cpu(model, imgsz: int = WORLD_CPU_IMGSZ) -> tuple:
    """The card against the CPU on ``model``'s weights at batch
    YOLO11_CPU_BATCH and ``imgsz``: the fused eval's candidates (boxes of
    their max, scores absolute) within TOL_REL; one fp32 train step on a
    batch guide with padded slots, its loss within TOL_REL and every
    gradient within WORLD_GRAD_TOL of the CPU's and of the fp64 step's,
    each tensor of its own max; the CPU's fp64 step within WORLD_FP64_TOL
    of the card's; all steps on the discrete choices of an fp64 step on the
    card (``SharedChoices``: TAL, SPPF's argmax, the text maxima and pooled
    bins) and on images divided on the host."""
    import copy

    import torch

    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn

    shape = (YOLO11_CPU_BATCH, imgsz, imgsz, 3)
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32))
    fused = fuse_conv_bn(zero_biases(copy.deepcopy(model).eval()))
    preds = {}
    for dev in ("cuda", "cpu"):
        with torch.no_grad():
            preds[dev] = copy.deepcopy(fused).to(dev).predictions(x.to(dev)).cpu()
    got, want = preds["cuda"], preds["cpu"]
    box_rel = ((got[..., :4] - want[..., :4]).abs().max() / want[..., :4].abs().max()).item()
    score_abs = (got[..., 4:] - want[..., 4:]).abs().max().item()
    batch = world_batch("cpu", YOLO11_CPU_BATCH, imgsz)
    ref = SharedChoices()
    ref_loss, ref_grads = zoo_step(model, "cuda", torch.float64, batch, ref, host_divide=True)
    own = SharedChoices()
    zoo_step(model, "cuda", torch.float32, batch, own, host_divide=True)
    steps = {dev: zoo_step(model, dev, torch.float32, batch, SharedChoices(replay=ref),
                           host_divide=True) for dev in ("cuda", "cpu")}
    worst_rel, worst_name, vanishing, gmax = grad_errors(steps["cuda"][1], steps["cpu"][1])
    loss_rel = abs(steps["cuda"][0] - steps["cpu"][0]) / abs(steps["cpu"][0])
    vs64 = {dev: grad_errors(steps[dev][1], ref_grads)[:2] for dev in steps}
    cpu64_loss, cpu64_grads = zoo_step(model, "cpu", torch.float64, batch,
                                       SharedChoices(replay=ref), host_divide=True)
    fp64_rel, fp64_worst, _, _ = grad_errors(cpu64_grads, ref_grads)
    ok = (box_rel <= TOL_REL and score_abs <= TOL_REL and loss_rel <= TOL_REL
          and worst_rel <= WORLD_GRAD_TOL and vs64["cuda"][0] <= WORLD_GRAD_TOL
          and fp64_rel <= WORLD_FP64_TOL
          and abs(cpu64_loss - ref_loss) <= WORLD_FP64_TOL * abs(ref_loss))
    return ok, {"cpu_imgsz": imgsz, "cands_box_maxrelerr_vs_cpu": box_rel,
                "cands_score_max_abs_err_vs_cpu": score_abs, "loss": steps["cuda"][0],
                "loss_cpu": steps["cpu"][0], "loss_fp64": ref_loss, "loss_relerr_vs_cpu": loss_rel,
                "grad_maxrelerr_vs_cpu": worst_rel, "grad_tol": WORLD_GRAD_TOL,
                "grad_worst": worst_name, "grads_vanishing": vanishing, "grad_max": gmax,
                "grad_spread_vs_cpu": grad_spread(steps["cuda"][1], steps["cpu"][1]),
                "grad_maxrelerr_vs_fp64": {d: v[0] for d, v in vs64.items()},
                "grad_worst_vs_fp64": {d: v[1] for d, v in vs64.items()},
                "fp64_cpu_vs_card": {"loss_relerr": abs(cpu64_loss - ref_loss) / abs(ref_loss),
                                     "grad_maxrelerr": fp64_rel, "grad_worst": fp64_worst,
                                     "tol": WORLD_FP64_TOL},
                "card_fp32_own_choices_vs_fp64": own.flips(ref)}


def world_facade(smi_line, encoder) -> tuple:
    """``YOLO("yolov8s-world.yaml")`` on the card through the user's entry
    points, on PNGs the phase writes (640 x 480, 8 train and 4 val images),
    with the text tower as ``text_encoder``: one epoch at the defaults with
    validation (the model rebuilt to the set's 3 classes; each batch's guide
    the tower's features of its sampled texts), ``val``, ``predict`` (the
    contrastive biases set to 0 first, so that boxes clear conf), then
    saved and reloaded (the checkpoint holds no guide: the reload's default
    one is the trained model's, as both come from seed 0): the same
    predictions."""
    import tempfile

    import torch

    from xlstm_yolo_torch import YOLO
    from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset

    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_dataset(f"{tmp}/ds", n_train=8, n_val=4, width=FIT_WH[0],
                                      height=FIT_WH[1], seed=0)
        val_dir = str(Path(data).parent / "images" / "val")
        m = YOLO("yolov8s-world.yaml")
        calls = []

        def enc(texts):
            calls.append(len(texts))
            return encoder(texts)

        t0 = time.perf_counter()
        m.train(data=data, epochs=1, imgsz=IMGSZ, batch=BATCH, plots=False, text_encoder=enc,
                project=f"{tmp}/runs", name="world")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        metrics = m.val(data=data, imgsz=IMGSZ, batch=BATCH)
        zero_biases(m.model)  # the predictions clear the confidence threshold
        results = m.predict(val_dir, imgsz=IMGSZ, conf=0.001, verbose=False)
        m.save(f"{tmp}/w.pt")
        again_model = YOLO(f"{tmp}/w.pt")
        same_guide = bool(torch.equal(again_model.model.txt_feats, m.model.txt_feats))
        again = again_model.predict(val_dir, imgsz=IMGSZ, conf=0.001, verbose=False)
    same = len(again) == len(results) and all(
        a.boxes.data.shape == b.boxes.data.shape
        and np.allclose(a.boxes.data, b.boxes.data, rtol=1e-5, atol=1e-4)
        for a, b in zip(again, results))
    n_boxes = sum(len(r) for r in results)
    ok = (m.model.task == "world" and m.model.nc == 3 and calls and np.isfinite(
        m.trainer.metrics["fitness"]) and np.isfinite(metrics["fitness"]) and len(results) == 4
        and n_boxes > 0 and same and same_guide)
    return ok, {"train_s": train_s, "encoder_calls": len(calls), "texts_a_call": calls[:1],
                "train_val": {k: v for k, v in m.trainer.metrics.items()
                              if isinstance(v, (int, float))},
                "val": {k: v for k, v in metrics.items() if isinstance(v, (int, float))},
                "nc": m.model.nc, "images": len(results), "boxes": n_boxes,
                "reloaded_guide_equal": same_guide, "reloaded_predictions_equal": same,
                "nvidia_smi": smi_line}


def nas_and_fastsam(frames, encoder) -> tuple:
    """``NAS("yolo_nas_s.yaml").predict`` on two frames (class biases
    zeroed, so that boxes clear the confidence threshold) and its ``train``
    refused; ``FastSAM`` (yolov8s-seg, one class, class biases zeroed so
    that its segments clear conf 0.4) ``everything`` at 640 px on two
    letterboxed frames, then the box prompt (a kept box: it keeps itself),
    the point prompt (a pixel of its mask) and the text prompt (the
    tower's embeddings of three prompts as crops, one as the text: it ranks
    itself first)."""
    import torch

    from xlstm_yolo_torch.models_extra import FastSAM
    from xlstm_yolo_torch.models_nas import NAS
    from xlstm_yolo_torch.ops.letterbox import letterbox_device

    nas = NAS("yolo_nas_s.yaml")
    zero_class_biases(nas.model)
    res = nas.predict([f for f in frames[:2].cpu().numpy()], imgsz=IMGSZ, conf=0.001,
                      verbose=False)
    try:
        nas.train(data="unused.yaml")
        refused = False
    except NotImplementedError:
        refused = True
    sam = FastSAM()
    zero_class_biases(sam.model)
    # on seeded weights the activations shrink layer by layer to mask logits
    # of about 1e-7, which fp32's sigmoid rounds to 0.5: every mask would be
    # empty; the coefficient convs scaled by 1e4 give masks with pixels
    head = getattr(sam.model, f"l{sam.model.parsed.head_index}")
    with torch.no_grad():
        for j in range(head.nl):
            for t in getattr(head, f"cv4_{j}_2").parameters():
                t.mul_(1e4)
    x, _ = letterbox_device(frames[:2], imgsz=IMGSZ, dtype=torch.float32)
    t0 = time.perf_counter()
    dets, valid, masks = sam.everything(x, conf=0.4, iou=0.9, max_det=100)
    sam_s = time.perf_counter() - t0
    kept = [int(i) for i in np.flatnonzero(valid[0]) if masks[0, i].any()]
    box_keep, point_keep = [], []
    if kept:  # a kept detection with a non-empty mask: each prompt keeps it
        i = kept[0]
        box_keep = FastSAM.box_prompt(dets[0], valid[0], masks[0], dets[0, i, :4])
        ys, xs = np.nonzero(masks[0, i])
        hm = masks.shape[2]
        pt = (float(xs[0] + 0.5) * IMGSZ / hm, float(ys[0] + 0.5) * IMGSZ / hm)
        point_keep = FastSAM.point_prompt(dets[0], valid[0], masks[0], [pt],
                                          img_shape=(IMGSZ, IMGSZ))
    emb = encoder(["a photo of a cat", "a photo of a dog", "a photo of a bus"])
    text_rank = FastSAM.text_prompt(emb, emb[2], topk=3)
    ok = (refused and len(res) == 2 and nas.model.num_params() == 11_343_216
          and dets.shape == (2, 100, 6) and masks.shape == (2, 100, IMGSZ // 4, IMGSZ // 4)
          and sum(len(r) for r in res) > 0 and kept and kept[0] in box_keep
          and kept[0] in point_keep and text_rank[0] == 2)
    return ok, {"nas_predicted": [len(r) for r in res], "nas_train_refused": refused,
                "fastsam_kept": [int(v.sum()) for v in valid], "fastsam_everything_s": sam_s,
                "box_prompt_kept": len(box_keep), "point_prompt_kept": len(point_keep),
                "text_prompt_rank": text_rank}


def phase_world_path(smi_line):
    """The text tower at ViT-B/32's widths (``world_tower``) and the 80 COCO
    prompts as yolov8l-world's classes; yolov8l-world at COCO's
    configuration (the JAX parameter count and strides; fp32 and bf16
    ``world_inference``; fp32 and AMP train steps at batch 8 on a batch
    guide (8, 80, 512) with padded slots, the AMP loss within AMP_LOSS_TOL
    of the fp32 one; ``world_card_vs_cpu``), yolov8l-worldv2 (inference and
    the fp32 step), the other eight world YAMLs and YOLO-NAS s / m / l
    (built with the JAX counts, one inference each), ``world_facade``,
    ``nas_and_fastsam``. No hand kernel runs: the counts, set to 0 just
    before, stay 0."""
    import tempfile

    import torch

    from xlstm_yolo_torch.nn.tasks import TaskModel

    t_phase = time.perf_counter()
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)).cuda()
    zero_all_kernel_counts()
    failed, img_s = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        bpe = write_merges(f"{tmp}/bpe.txt", coco_prompts())
        tower_ok, tower, encoder = world_tower(bpe)
    emit({"phase": "world_path.clip_text_tower", **CLIP_B32, **tower, "ok": tower_ok})
    if not tower_ok:
        failed.append("clip_text_tower")
    for i, (label, cfg, scale, params) in enumerate(WORLD_MODELS):
        t0 = time.perf_counter()
        model = TaskModel(cfg, scale=scale, device="cuda", seed=0)
        built_ok = (model.task == "world" and model.num_params() == params
                    and model.strides == (8, 16, 32))
        model.set_classes(coco_prompts(), encoder=encoder)
        guide_ok = (tuple(model.txt_feats.shape) == (1, 80, 512) and model.nc == 80
                    and model.txt_feats.dtype == torch.float32)
        gflop = world_forward_gflop(model)
        inf_ok, inf = world_inference(model, frames, iters=ZOO_INFER_TIMED if i == 0 else 1)
        inf["forward_tflop_per_s"] = BATCH * gflop / inf["ms"]["forward_decode"]
        batch = world_batch("cuda", BATCH, IMGSZ)
        fp32_ok, fp32 = task_train(model, batch, amp=False)
        entry = {"phase": f"world_path.{label}", "yaml": cfg, "scale": scale, "nc": model.nc,
                 "params": model.num_params(), "params_jax": params, "strides": model.strides,
                 "batch": BATCH, "imgsz": IMGSZ, "forward_gflop_per_image": gflop,
                 "inference": inf, "train_fp32": fp32}
        ok = built_ok and guide_ok and inf_ok and fp32_ok
        if i == 0:
            bf_ok, bf16 = world_inference(model, frames, "bfloat16")
            amp_ok, amp = task_train(model, batch, amp=True)
            amp_rel = abs(amp["losses"][0] - fp32["losses"][0]) / abs(fp32["losses"][0])
            cpu_ok, vs_cpu = world_card_vs_cpu(model)
            ok = ok and bf_ok and amp_ok and amp_rel <= AMP_LOSS_TOL and cpu_ok
            entry.update({"inference_bf16": bf16, "train_amp": amp,
                          "amp_loss_relerr_vs_fp32": amp_rel, "amp_loss_tol": AMP_LOSS_TOL,
                          **vs_cpu})
            img_s[label] = (inf["img_per_s"], bf16["img_per_s"], fp32["img_per_s"],
                            amp["img_per_s"])
        else:
            img_s[label] = (inf["img_per_s"], fp32["img_per_s"])
        emit({**entry, "seconds": time.perf_counter() - t0, "ok": ok})
        if not ok:
            failed.append(label)
        del model, batch
        torch.cuda.empty_cache()
    for label, cfg, scale, params in WORLD_OTHERS:
        t0 = time.perf_counter()
        model = TaskModel(cfg, scale=scale, device="cuda", seed=0)
        built_ok = model.num_params() == params and model.strides == (8, 16, 32)
        inf_ok, inf = world_inference(model, frames, iters=1)
        ok = built_ok and inf_ok
        emit({"phase": f"world_path.{label}", "yaml": cfg, "task": model.task,
              "params": model.num_params(), "params_jax": params, "strides": model.strides,
              "inference_ms": inf["total_ms"], "forward_device_busy_ms":
              inf["forward_device_busy_ms"], "peak_gib": inf["peak_gib"],
              "seconds": time.perf_counter() - t0, "ok": ok})
        if not ok:
            failed.append(label)
        img_s[label] = inf["img_per_s"]
        del model
        torch.cuda.empty_cache()
    facade_ok, facade = world_facade(smi_line, encoder)
    extra_ok, extra = nas_and_fastsam(frames, encoder)
    counts = all_kernel_counts()
    ok = not failed and facade_ok and extra_ok and not any(counts.values())
    emit({"phase": "world_path", "models": len(WORLD_MODELS) + len(WORLD_OTHERS),
          "failed": failed, "img_per_s": img_s, "facade": facade, "nas_fastsam": extra,
          "launches": counts, "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError(f"world_path check failed: {failed or 'facade, NAS / FastSAM or launches'}")
    return {k: v for k, v in counts.items() if v}


# sam_path: SAM ViT-B (Segment Anything's build_sam_vit_b widths: 1024 px, dim 768, 12 blocks,
# 12 heads, window 14, global attention at 2, 5, 8, 11; prompt dim 256) and SAM2.1-tiny
# (Hiera-T: embed 96, stages 1-2-7-2, windows 8-4-14-7, global 5, 7, 9; d_model 256, mem_dim 64,
# 7 memory slots) at 1024 px on seeded perturbed weights; the JAX parameter counts
# (jax.eval_shape of the JAX init; tests/test_torch_sam.py holds the port to the same)
SAM_COUNTS = {"vit_b": 93_993_572, "vit_l": 312_600_932, "vit_h": 641_308_260,
              "mobile_sam": 7_810_916, "sam2_t": 38_185_380}
SAM_SIZE, SAM_ENC_BATCH, SAM_ENC_TIMED = 1024, 8, 3
SAM_VIDEO_FRAMES = 10
SAM_CPU_SIZE, SAM2_CPU_FRAMES = 256, 4  # the card against the CPU: ViT-B / Hiera-T widths at 256 px
SAM_NEAR = 0.01  # the share of a mask's pixels that may lie within TOL_REL of its threshold


def sam_perturb(model, seed: int, std: float = 0.02):
    """Seeded noise on every parameter, drawn on the CPU: the rel-pos
    tables and the memory's temporal table start at zero, which would leave
    their paths undriven."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_((torch.randn(p.shape, generator=g) * std).to(p.device))
    return model


def sam_tflop(variant: str, call) -> float:
    """TFLOP of ``call(model)`` (2 per multiply-add; ``torch.utils.flop_counter``)
    on the meta device, ``variant`` built by ``build_sam``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from xlstm_yolo_torch.models_sam2 import build_sam

    with torch.device("meta"):
        model = build_sam(variant, device="meta")
        with FlopCounterMode(display=False) as counter:
            call(model)
    return counter.get_total_flops() / 1e12


def events_ms(fn):
    """(fn(), its ms between two CUDA events, its host wall ms to the sync)."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b), (time.perf_counter() - t0) * 1e3


def rel_err(got, want) -> float:
    """``compare``'s relative error, of two tensors on any devices."""
    return compare(got.detach().cpu(), want.detach().cpu())[1]


def bool_near(got, want, want_float, thresh: float = 0.0) -> dict:
    """Boolean masks against the reference's: differing pixels away from the
    threshold (must be 0), pixels within TOL_REL of the max of the
    threshold (a share bounded by SAM_NEAR), differing pixels in all."""
    f = np.abs(np.asarray(want_float, np.float64) - thresh)
    near = f <= TOL_REL * f.max()
    diff = np.asarray(got) != np.asarray(want)
    return {"far_mismatches": int((diff & ~near).sum()), "near_share": float(near.mean()),
            "mismatches": int(diff.sum())}


def sam_predict_timed(pred, frame, prompts: dict) -> tuple:
    """``pred.set_image`` then ``predict`` for each prompt, each split into
    its host and device ms (a warm-up call first): set_image's letterbox
    (host) and encode (device, events); predict's decode (events, prompts
    mapped on the host and copied in) and the masks to the original size
    (host: the transfer and the two float cv2-linear resizes)."""
    pred.set_image(frame)
    t0 = time.perf_counter()
    lb = pred.preprocess(frame)
    host_ms = (time.perf_counter() - t0) * 1e3
    _, dev_ms, _ = events_ms(lambda: pred.encode(lb))
    out = {"set_image": {"host_ms": host_ms, "device_ms": dev_ms}}
    oh, ow = frame.shape[:2]
    ok = True
    for name, kw in prompts.items():
        multi = kw.get("multimask_output", True)
        args = {k: v for k, v in kw.items() if k != "multimask_output"}
        pred.predict(**kw)
        (masks, iou), dev_ms, _ = events_ms(lambda: pred.decode(**args))
        t0 = time.perf_counter()
        bm, scores = pred.postprocess(masks, iou, multi)
        host_ms = (time.perf_counter() - t0) * 1e3
        good = (bm.dtype == bool and bm.shape == ((4 if multi else 1), oh, ow)
                and bool(np.isfinite(scores).all()) and bool(masks.isfinite().all()))
        ok = ok and good
        out[name] = {"device_ms": dev_ms, "host_ms": host_ms, "masks": list(bm.shape),
                     "mask_share": float(bm.mean()), "iou": scores.tolist(), "ok": good}
    return ok, out


def sam_prompts(frame) -> dict:
    oh, ow = frame.shape[:2]
    return {"point": {"points": [[ow * 0.5, oh * 0.4]], "point_labels": [1]},
            "box": {"boxes": [ow * 0.2, oh * 0.2, ow * 0.7, oh * 0.8],
                    "multimask_output": False}}


def sam_amg(pred, frame, **kw) -> tuple:
    """``SAMAutoMaskGenerator(pred, **kw).generate`` on ``frame`` (crop layers
    0), after a warm-up call: the device stage (``crop_batches``: encode,
    every point batch's decode, stability, boxes and keep flags, the kept
    masks' copy out; events and wall ms) and the host stage (NMS, uncrop;
    ms), the prompts, batches and masks kept."""
    from xlstm_yolo_torch.data.augment import letterbox
    from xlstm_yolo_torch.models_sam import SAMAutoMaskGenerator

    gen = SAMAutoMaskGenerator(pred, **kw)
    gen.generate(frame)
    lb, _, meta = letterbox(frame, pred.img_size)
    per_crop, dev_ms, dev_wall_ms = events_ms(lambda: gen.crop_batches(lb))
    t0 = time.perf_counter()
    masks, scores, boxes = gen.host_stage(per_crop, frame.shape[:2], meta)
    host_ms = (time.perf_counter() - t0) * 1e3
    oh, ow = frame.shape[:2]
    n_prompts = gen.points_stride ** 2
    candidates = sum(len(c[2]) for c in per_crop if c[2] is not None)
    ok = bool(masks.shape == (len(scores), oh, ow) and len(boxes) == len(scores)
              and np.isfinite(scores).all()
              and (not len(boxes) or (boxes[:, [0, 2]].min() >= 0 and boxes[:, 2].max() <= ow
                                      and boxes[:, 3].max() <= oh)))
    return ok, {"points_stride": gen.points_stride, "prompts": n_prompts,
                "batches": -(-n_prompts // gen.points_batch_size),
                "device_stage_ms": dev_ms, "device_stage_wall_ms": dev_wall_ms,
                "host_stage_ms": host_ms, "candidates_kept_on_device": candidates,
                "masks_kept": len(scores), "ok": ok}


def sam_vit_b(frame) -> tuple:
    """SAM ViT-B at 1024: the count, ``SAMPredictor`` timed (point, box),
    the encoder alone at batch 8 (img/s, TFLOP/s, device-busy ms, peak
    GiB), the automatic generator at its defaults and at stride 8 with the
    thresholds off."""
    import torch

    from xlstm_yolo_torch.models_sam import SAMPredictor
    from xlstm_yolo_torch.models_sam2 import build_sam

    model = sam_perturb(build_sam("vit_b", device="cuda", seed=0), 1)
    params = sum(p.numel() for p in model.parameters())
    pred = SAMPredictor(model, img_size=SAM_SIZE)
    torch.cuda.reset_peak_memory_stats()
    pred_ok, timed = sam_predict_timed(pred, frame, sam_prompts(frame))
    peak_predict = torch.cuda.max_memory_allocated() / 2**30
    tflop = sam_tflop("vit_b", lambda m: m.encode_image(torch.zeros(1, SAM_SIZE, SAM_SIZE, 3)))
    x = torch.rand(SAM_ENC_BATCH, SAM_SIZE, SAM_SIZE, 3, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        emb = model.encode_image(x)
        ms = sum(events_ms(lambda: model.encode_image(x))[1]
                 for _ in range(SAM_ENC_TIMED)) / SAM_ENC_TIMED
        busy = device_busy_ms(lambda: model.encode_image(x), calls=1)
    enc = {"batch": SAM_ENC_BATCH, "ms": ms, "img_per_s": SAM_ENC_BATCH / ms * 1e3,
           "tflop_per_image": tflop, "tflop_per_s": SAM_ENC_BATCH * tflop / ms * 1e3,
           "device_busy_ms": busy, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "finite": bool(emb.isfinite().all())}
    del emb, x
    amg_ok, amg = sam_amg(pred, frame)
    amg8_ok, amg8 = sam_amg(pred, frame, points_stride=8, conf_thres=-1e9,
                            stability_score_thresh=-1.0)
    ok = (params == SAM_COUNTS["vit_b"] and pred_ok and enc["finite"] and amg_ok and amg8_ok
          and amg8["masks_kept"] > 0)
    del pred, model
    torch.cuda.empty_cache()
    return ok, {"params": params, "params_jax": SAM_COUNTS["vit_b"], **timed,
                "predict_peak_gib": peak_predict, "encoder": enc, "amg_default": amg,
                "amg_stride8_thresholds_off": amg8}


def sam_other_variants(frame) -> tuple:
    """vit_l, vit_h and mobile_sam at 1024: the JAX count, one set_image and
    one point predict each (a warm-up first)."""
    import torch

    from xlstm_yolo_torch.models_sam import SAMPredictor
    from xlstm_yolo_torch.models_sam2 import build_sam

    out, ok = {}, True
    for variant in ("vit_l", "vit_h", "mobile_sam"):
        t0 = time.perf_counter()
        model = build_sam(variant, device="cuda", seed=0)
        build_s = time.perf_counter() - t0
        params = sum(p.numel() for p in model.parameters())
        good, timed = sam_predict_timed(SAMPredictor(model, img_size=SAM_SIZE), frame,
                                        {"point": sam_prompts(frame)["point"]})
        good = good and params == SAM_COUNTS[variant]
        ok = ok and good
        out[variant] = {"params": params, "params_jax": SAM_COUNTS[variant], "build_s": build_s,
                        **timed, "ok": good}
        del model
        torch.cuda.empty_cache()
    return ok, out


def sam2_tiny(frame) -> tuple:
    """SAM2.1-tiny at 1024: the count, ``SAM2Predictor`` timed (point), then
    ``SAM2VideoPredictor`` over SAM_VIDEO_FRAMES frames with a point on the
    first (after a warm-up video): each frame's host prep, device step
    (events) and readback ms, the ring's state (7 valid slots from frame 7),
    peak GiB; TinyViT at its defaults once."""
    import torch

    from xlstm_yolo_torch.models_sam2 import SAM2Predictor, SAM2VideoPredictor, TinyViT, build_sam

    model = sam_perturb(build_sam("sam2_t", device="cuda", seed=0), 2)
    params = sum(p.numel() for p in model.parameters())
    pred_ok, timed = sam_predict_timed(SAM2Predictor(model, img_size=SAM_SIZE), frame,
                                       {"point": sam_prompts(frame)["point"]})
    rng = np.random.default_rng(7)
    frames = [frame] + [rng.integers(0, 256, frame.shape, dtype=np.uint8)
                        for _ in range(SAM_VIDEO_FRAMES - 1)]
    point = sam_prompts(frame)["point"]
    vp = SAM2VideoPredictor(model, img_size=SAM_SIZE).init_state()
    vp.track(frames[0], **point)
    vp.track(frames[1])
    vp.init_state()
    torch.cuda.reset_peak_memory_stats()
    per_frame, valid_after, finite = [], [], True
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        x = vp._prep(f)
        prep_ms = (time.perf_counter() - t0) * 1e3
        kw = dict(points=point["points"], point_labels=point["point_labels"],
                  frame_shape=f.shape) if i == 0 else {}
        (masks, iou), dev_ms, _ = events_ms(lambda: vp.step(x, **kw))
        t0 = time.perf_counter()
        best = masks[0, int(np.argmax(iou[0].cpu().numpy()))].cpu().numpy()
        read_ms = (time.perf_counter() - t0) * 1e3
        finite = finite and bool(np.isfinite(best).all())
        per_frame.append({"prep_ms": prep_ms, "device_ms": dev_ms, "readback_ms": read_ms})
        valid_after.append(int(vp._state["valid"].sum()))
    tflop_full = sam_tflop("sam2_t", lambda m: m.track_step(
        torch.zeros(1, SAM_SIZE, SAM_SIZE, 3), torch.zeros(1, 7, (SAM_SIZE // 16) ** 2, 64),
        torch.zeros(1, 7, dtype=torch.int32), torch.ones(1, 7, dtype=torch.bool),
        torch.zeros(1, 1, 2), torch.ones(1, 1)))
    dev = [p["device_ms"] for p in per_frame]
    video = {"frames": len(frames), "per_frame": per_frame, "valid_slots_after": valid_after,
             "ptr": vp._state["ptr"], "ages": vp._state["age"][0].tolist(),
             "device_ms_mean_after_frame_0": float(np.mean(dev[1:])),
             "track_step_tflop": tflop_full,
             "tflop_per_s": tflop_full / np.mean(dev[1:]) * 1e3,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    ring_ok = (valid_after == [min(i + 1, 7) for i in range(len(frames))]
               and vp._state["ptr"] == len(frames) - 1)
    del vp, model
    torch.cuda.empty_cache()
    tiny = TinyViT(device="cuda", seed=0)
    x = torch.rand(1, SAM_SIZE, SAM_SIZE, 3, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(1))
    with torch.inference_mode():
        tiny(x)
        y, tiny_ms, _ = events_ms(lambda: tiny(x))
    tiny_ok = tuple(y.shape) == (1, SAM_SIZE // 16, SAM_SIZE // 16, 256) and bool(
        y.isfinite().all())
    ok = params == SAM_COUNTS["sam2_t"] and pred_ok and finite and ring_ok and tiny_ok
    return ok, {"params": params, "params_jax": SAM_COUNTS["sam2_t"], "predictor": timed,
                "video": video, "ring_ok": ring_ok,
                "tinyvit": {"ms": tiny_ms, "shape": list(y.shape), "ok": tiny_ok}}


def sam_card_vs_cpu(frame) -> tuple:
    """SAM at ViT-B widths and SAM2 at Hiera-T widths at 256 px, fp32, one
    set of seeded perturbed weights built on the CPU and copied to the
    card, inputs divided by 255 on the host: SAM's embedding, masks and IoU
    (point and box), its predictor's booleans by the near-threshold rule;
    SAM2's masks, IoU, bank, ages, validity and pointer over
    SAM2_CPU_FRAMES video frames, a point on the first."""
    import copy

    import torch

    from xlstm_yolo_torch.data.augment import letterbox
    from xlstm_yolo_torch.data.imgproc import resize
    from xlstm_yolo_torch.models_sam import SAM, letterbox_meta_prompts, mask_to_image
    from xlstm_yolo_torch.models_sam2 import SAM2, SAM2VideoPredictor

    S = SAM_CPU_SIZE
    cpu = sam_perturb(SAM(img_size=S, device="cpu", seed=0), 3)
    card = copy.deepcopy(cpu).cuda()
    lb, _, meta = letterbox(frame, S)
    x = torch.from_numpy(lb)[None].float() / 255.0
    errs, bools = {}, {}
    with torch.inference_mode():
        ec, eg = cpu.encode_image(x), card.encode_image(x.cuda())
        errs["embedding"] = rel_err(eg, ec)
        for name, kw in sam_prompts(frame).items():
            p, lab, bx = letterbox_meta_prompts(meta, kw.get("points"), kw.get("point_labels"),
                                                kw.get("boxes"))
            args = [None if a is None else torch.as_tensor(a) for a in (p, lab, bx)]
            mc, ic = cpu.decode(ec, *args)
            mg, ig = card.decode(eg, *[None if a is None else a.cuda() for a in args])
            errs[f"{name}_masks"], errs[f"{name}_iou"] = rel_err(mg, mc), rel_err(ig, ic)
            for k in range(mc.shape[1]):
                fc = mask_to_image(mc[0, k].numpy(), S, meta, frame.shape[:2])
                fg = mask_to_image(mg[0, k].cpu().numpy(), S, meta, frame.shape[:2])
                bools[f"{name}_{k}"] = bool_near(fg > 0, fc > 0, fc)
    cpu2 = sam_perturb(SAM2(img_size=S, device="cpu", seed=0), 4)
    vc = SAM2VideoPredictor(cpu2, img_size=S).init_state()
    vg = SAM2VideoPredictor(copy.deepcopy(cpu2).cuda(), img_size=S).init_state()
    rng = np.random.default_rng(8)
    point = sam_prompts(frame)["point"]
    state_equal = True
    for i in range(SAM2_CPU_FRAMES):
        f = frame if i == 0 else rng.integers(0, 256, frame.shape, dtype=np.uint8)
        xf = torch.from_numpy(resize(f, (S, S)))[None].float() / 255.0
        kw = dict(points=point["points"], point_labels=point["point_labels"],
                  frame_shape=f.shape) if i == 0 else {}
        mc, ic = vc.step(xf, **kw)
        mg, ig = vg.step(xf.cuda(), **kw)
        errs[f"video{i}_masks"], errs[f"video{i}_iou"] = rel_err(mg, mc), rel_err(ig, ic)
        errs[f"video{i}_bank"] = rel_err(vg._state["bank"], vc._state["bank"])
        state_equal = state_equal and vg._state["ptr"] == vc._state["ptr"] and all(
            torch.equal(vg._state[k].cpu(), vc._state[k]) for k in ("age", "valid"))
    worst = max(errs.values())
    far = sum(b["far_mismatches"] for b in bools.values())
    near = max(b["near_share"] for b in bools.values())
    ok = worst <= TOL_REL and far == 0 and near <= SAM_NEAR and state_equal
    return ok, {"card_vs_cpu_imgsz": S, "tol": TOL_REL, "max_rel_err": worst, "rel_err": errs,
                "bool_far_mismatches": far, "bool_mismatches": sum(
                    b["mismatches"] for b in bools.values()), "bool_near_share_max": near,
                "ring_state_equal": state_equal, "ok": ok}


def phase_sam_path(smi_line):
    """SAM ViT-B (``sam_vit_b``), vit_l / vit_h / mobile_sam
    (``sam_other_variants``), SAM2.1-tiny and TinyViT (``sam2_tiny``) at
    1024 px on a uint8 540 x 810 frame, and ``sam_card_vs_cpu``. No hand
    kernel runs (plain XLA in JAX): the counts, set to 0 just before, stay
    0."""
    import torch

    t_phase = time.perf_counter()
    frame = np.random.default_rng(0).integers(0, 256, (*SRC_HW, 3), dtype=np.uint8)
    zero_all_kernel_counts()
    failed = []
    for label, part in (("vit_b", sam_vit_b), ("variants", sam_other_variants),
                        ("sam2_tiny", sam2_tiny), ("card_vs_cpu", sam_card_vs_cpu)):
        t0 = time.perf_counter()
        ok, entry = part(frame)
        ok = bool(ok)
        emit({"phase": f"sam_path.{label}", **entry, "seconds": time.perf_counter() - t0,
              "ok": ok})
        if not ok:
            failed.append(label)
        torch.cuda.empty_cache()
    counts = all_kernel_counts()
    ok = not failed and not any(counts.values())
    emit({"phase": "sam_path", "failed": failed, "launches": counts, "smi": smi_line,
          "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError(f"sam_path check failed: {failed or 'launches'}")
    return {k: v for k, v in counts.items() if v}


EXPORT_FORMATS_GATED = ("onnx", "savedmodel", "tflite")  # need packages the card's machine lacks
EXPORT_REQUESTS = 3  # timed requests to the model server
AUTOBATCH_FRACTION = 0.6
TUNE_ITERATIONS = 2


def graph_ops(path, name: str = "vil_layer_fwd") -> tuple:
    """(nodes of the saved program at ``path`` that call ``xlstm_yolo::name``,
    its operator nodes in all)."""
    import torch

    import xlstm_yolo_torch.kernels.vil_conv  # noqa: F401  (registers the ops)

    target = getattr(torch.ops.xlstm_yolo, name).default
    nodes = [n for n in torch.export.load(str(path)).graph.nodes if n.op == "call_function"]
    return sum(1 for n in nodes if n.target is target), len(nodes)


def counted_call(fn, *args):
    """``fn(*args)`` -> (output, {kernel: launches} of the kernels it
    launched, read from the counts just before and just after)."""
    import torch

    before = all_kernel_counts()
    with torch.inference_mode():
        out = fn(*args)
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in all_kernel_counts().items() if v > before[k]}


def export_programs(model, x, tmp: str) -> tuple:
    """(a) fp32 ``pt2``: 3 K3 nodes, 3 fp32 launches a call of the program
    reloaded through ``AutoBackend``, within TOL_REL of the plain-forced
    model, event ms beside eager ``predictions``. (b) ``half``: 3 bf16
    launches and none fp32, held to native bf16 serving (``compare_bf16``).
    (c) ``nms``: dets and valid of the program against ``non_max_suppression``
    of the eager candidates. Returns (ok, entry, the fp32 program's path)."""
    import copy

    import torch

    from xlstm_yolo_torch.engine.exporter import Exporter
    from xlstm_yolo_torch.nn.autobackend import AutoBackend
    from xlstm_yolo_torch.nn.fuse import cast_params
    from xlstm_yolo_torch.ops.nms import non_max_suppression

    common = dict(imgsz=IMGSZ, batch=BATCH, device="cuda")
    t0 = time.perf_counter()
    path = Exporter(model, output_dir=f"{tmp}/fp32", **common)()
    export_s = time.perf_counter() - t0
    nodes, graph_nodes = graph_ops(path)
    backend = AutoBackend(path, imgsz=IMGSZ, device="cuda")
    got, launches = counted_call(backend._fn, x)
    with plain_vil_kernels(), torch.inference_mode():
        ref = model.predictions(x)
    box_rel = ((got[..., :4] - ref[..., :4]).abs().max() / ref[..., :4].abs().max()).item()
    score_abs = (got[..., 4:] - ref[..., 4:]).abs().max().item()
    with torch.inference_mode():
        eager = model.predictions(x)
        program_ms = cuda_time_ms(lambda: backend._fn(x), iters=10)
        eager_ms = cuda_time_ms(lambda: model.predictions(x), iters=10)
    eager_diff = (got - eager).abs().max().item()
    fp32_ok = (nodes == len(STAGES) and launches == {"vil_layer_fwd": len(STAGES)}
               and box_rel <= TOL_REL and score_abs <= TOL_REL
               and bool(torch.isfinite(got).all()) and tuple(got.shape) == tuple(ref.shape))

    half_path = Exporter(model, half=True, output_dir=f"{tmp}/bf16", **common)()
    half_nodes = graph_ops(half_path)[0]
    half = AutoBackend(half_path, imgsz=IMGSZ, device="cuda")
    got16, launches16 = counted_call(half._fn, x)
    model16 = cast_params(copy.deepcopy(model), torch.bfloat16)
    with torch.inference_mode():
        want16 = model16.predictions(x.bfloat16()).float()
        half_ms = cuda_time_ms(lambda: half._fn(x), iters=10)
        eager16_ms = cuda_time_ms(lambda: model16.predictions(x.bfloat16()), iters=10)
    err16, rel_l2_16, ok16 = compare_bf16(got16, want16)
    half_ok = (half_nodes == len(STAGES) and launches16 == {"vil_layer_fwd_bf16": len(STAGES)}
               and ok16)
    del model16

    nms_path = Exporter(model, nms=True, output_dir=f"{tmp}/nms", **common)()
    (dets, valid), nms_launches = counted_call(AutoBackend(nms_path, imgsz=IMGSZ)._fn, x)
    with torch.inference_mode():
        want_dets, want_valid = non_max_suppression(eager, conf_thres=0.25, iou_thres=0.7,
                                                    max_det=300)
    dets_err = (dets - want_dets).abs().max().item()
    nms_ok = (tuple(dets.shape) == (BATCH, 300, 6) and torch.equal(valid, want_valid)
              and dets_err <= TOL_REL * want_dets.abs().max().item() and int(valid.sum()) > 0
              and nms_launches == {"vil_layer_fwd": len(STAGES)})
    entry = {"export_s": export_s, "k3_nodes": nodes, "graph_nodes": graph_nodes,
             "launches_a_call": launches,
             "cands_box_maxrelerr": box_rel, "cands_score_max_abs_err": score_abs,
             "vs_eager_kernels_max_abs": eager_diff, "program_ms": program_ms,
             "eager_predictions_ms": eager_ms, "fp32_ok": fp32_ok,
             "half": {"k3_nodes": half_nodes, "launches_a_call": launches16,
                      "max_abs_err_beyond_rounding": err16, "rel_l2": rel_l2_16,
                      "program_ms": half_ms, "eager_bf16_predictions_ms": eager16_ms,
                      "ok": half_ok},
             "nms": {"dets_max_abs_err": dets_err, "valid": int(valid.sum()),
                     "valid_equal": bool(torch.equal(valid, want_valid)),
                     "launches_a_call": nms_launches, "ok": nms_ok}}
    return fp32_ok and half_ok and nms_ok, entry, path


def export_torch_format(tmp: str) -> tuple:
    """yolo11n (80 classes) through ``Exporter(format="torch")`` and back
    through ``Model(pt)``: its predictions against the source model's."""
    import torch

    from xlstm_yolo_torch import YOLO
    from xlstm_yolo_torch.engine.exporter import Exporter
    from xlstm_yolo_torch.nn.tasks import TaskModel

    src = TaskModel("yolo11n.yaml", device="cuda", seed=0)
    pt = Exporter(src, format="torch", imgsz=IMGSZ, output_dir=f"{tmp}/torch", device="cuda")()
    back = YOLO(pt, device="cuda")
    x = torch.rand((2, IMGSZ, IMGSZ, 3), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    with torch.inference_mode():
        want, got = src.predictions(x), back.model.predictions(x)
    err = (got - want).abs().max().item()
    ok = back.task == "detect" and back.model.nc == 80 and err <= 1e-5 * want.abs().max().item()
    return ok, {"model": "yolo11n.yaml", "max_abs_err": err, "exact": err == 0.0, "ok": ok}


def export_serving(path, x) -> tuple:
    """``serve_model`` of the fp32 program on localhost: ``RemoteModel``
    against the server's own ``AutoBackend``, ms a request (batch 8 at 640
    px: 39 MB of npz in, 22.6 MB out)."""
    from xlstm_yolo_torch.utils.remote import RemoteModel, serve_model

    server = serve_model(path, imgsz=IMGSZ, device="cuda")
    try:
        host, port = server.server_address
        rm = RemoteModel(f"http://{host}:{port}")
        img = x.cpu().numpy()
        remote, counts = counted_call(rm, img)
        local = server.backend.forward(img)
        t0 = time.perf_counter()
        for _ in range(EXPORT_REQUESTS):
            rm(img)
        ms = (time.perf_counter() - t0) / EXPORT_REQUESTS * 1e3
    finally:
        server.shutdown()
        server.server_close()
    err = float(np.abs(remote - local).max())
    ok = remote.shape == local.shape and err == 0.0 and rm.meta.get("nc") == 80 \
        and counts == {"vil_layer_fwd": len(STAGES)}
    return ok, {"ms_a_request": ms, "batch": int(img.shape[0]), "max_abs_err": err,
                "launches_a_request": counts, "meta": {k: rm.meta.get(k) for k in
                                                        ("task", "nc", "imgsz", "batch")},
                "ok": ok}


def export_profiling(model, tmp: str) -> tuple:
    """``Model.benchmark`` (batch 1: the pt2 row within 0.05, an error row
    for the torch format (a ViL model has no reference names) and each
    gated format); ``profile_model`` img/s at batch 8; ``profile_layers`` at
    batch 1 against ``FlopCounterMode`` of the whole forward."""
    import torch

    from xlstm_yolo_torch import YOLO
    from xlstm_yolo_torch.utils.benchmarks import forward_flops, profile_layers, profile_model

    facade = YOLO("vil_yolon.yaml", device="cuda")
    facade.model = model
    rows = facade.benchmark(imgsz=IMGSZ, output_dir=f"{tmp}/bench", verbose=False)
    by = {r["format"]: r for r in rows}
    bench_ok = (by["pt2"]["ok"] and "error" in by["torch"]
                and all("ImportError" in by[f].get("error", "") for f in EXPORT_FORMATS_GATED))
    prof = profile_model(model, imgsz=IMGSZ, batch=BATCH, n=10)
    layers = profile_layers(model, imgsz=IMGSZ, batch=1, n=3)
    total = forward_flops(model, torch.zeros((1, 3, IMGSZ, IMGSZ), device="cuda"))
    layer_sum = sum(r["gflops"] for r in layers) * 1e9
    vil = [r["gflops"] for r in layers if r["name"] == "ViLBlockPairBlock"]
    ok = (bench_ok and prof["img_s"] > 0 and len(layers) == len(model.parsed.specs)
          and abs(layer_sum - total) <= 1e-6 * total and len(vil) == len(STAGES)
          and min(vil) > 0)
    return ok, {"benchmark": rows, "profile_model": prof, "forward_gflops": total / 1e9,
                "layers_gflops_sum": layer_sum / 1e9, "vil_layers_gflops": vil,
                "layers": [{k: r[k] for k in ("i", "name", "ms", "gflops")} for r in layers],
                "ok": ok}


def export_autobatch() -> tuple:
    """``autobatch_fit`` on the fp32 train step of ViL-YOLO-n at 640 px
    (probes 1 and 4; fraction 0.6): the fit's batch and bytes, and the
    measured peak of one step at the batch it keeps (the fit's, halved
    while the peak passes the budget), at most 0.6 of the card's memory."""
    import torch

    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.utils.autobatch import autobatch_fit

    step = TrainStep(build_main_model("cuda", train=True), amp=False)

    def step_fn(img):
        b = train_batch("cuda", img.shape[0])
        b["img"] = (img * 255).round().to(torch.uint8)
        return step(b)

    fit = autobatch_fit(step_fn, imgsz=IMGSZ, fraction=AUTOBATCH_FRACTION)
    del step
    torch.cuda.empty_cache()
    total, peak = fit["total"], fit["measured_peak_bytes"]
    ok = fit["predicted_bytes"] is not None and peak <= AUTOBATCH_FRACTION * total
    return ok, {"fit_batch": fit["fit_batch"], "batch": fit["batch"],
                "readings": fit["readings"], "fixed": fit["fixed"],
                "per_image": fit["per_image"], "predicted_bytes": fit["predicted_bytes"],
                "measured_peak_bytes": peak, "total_bytes": total,
                "peak_share": peak / total, "ok": ok}


def export_tune(tmp: str) -> tuple:
    """``Model.tune``: two iterations of one fp32 epoch on fit_path's PNG set
    (written again); the CSV's JAX columns and two rows."""
    import csv

    from xlstm_yolo_torch import YOLO
    from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset
    from xlstm_yolo_torch.engine.tuner import SPACE

    data = make_synthetic_dataset(f"{tmp}/ds", n_train=FIT_IMAGES[0], n_val=FIT_IMAGES[1],
                                  width=FIT_WH[0], height=FIT_WH[1], seed=0)
    t0 = time.perf_counter()
    res = YOLO("vil_yolon.yaml", device="cuda").tune(
        data=data, iterations=TUNE_ITERATIONS, epochs=1, batch=BATCH, imgsz=IMGSZ,
        dtype="float32", project=f"{tmp}/tune", plots=False, seed=0, mosaic=0.0)
    with open(f"{tmp}/tune/tune_results.csv") as f:
        rows = list(csv.DictReader(f))
    ok = (len(rows) == TUNE_ITERATIONS and list(rows[0]) == ["iter", "fitness", *SPACE]
          and res["best_hyp"] is not None)
    return ok, {"seconds": time.perf_counter() - t0, "best_fitness": res["best_fitness"],
                "fitness": [float(r["fitness"]) for r in rows], "ok": ok}


def phase_export_path(smi_line):
    """Export and serving (``export_path``): ViL-YOLO-n as
    ``build_main_model`` builds it, batch 8, 640 px, on the letterboxed
    seeded frames of ``main_path``: the programs (``export_programs``), the
    torch format on yolo11n, the model server, benchmark and profiling,
    autobatch and ``Model.tune``. Every kernel count is set to 0 just before
    the parts run and read just after; the plain-forced comparisons launch
    none."""
    import tempfile

    import torch

    from xlstm_yolo_torch.engine.predictor import Predictor

    t_phase = time.perf_counter()
    model = build_main_model("cuda")
    frames = np.random.default_rng(0).integers(0, 256, (BATCH, *SRC_HW, 3), dtype=np.uint8)
    with torch.inference_mode():
        x, _ = Predictor(model, imgsz=IMGSZ).preprocess(torch.from_numpy(frames).cuda())
    failed, program = [], []
    zero_all_kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        def programs():
            ok, entry, path = export_programs(model, x, tmp)
            program.append(path)
            return ok, entry

        for label, part in (("programs", programs),
                            ("torch_format", lambda: export_torch_format(tmp)),
                            ("serving", lambda: export_serving(program[0], x)),
                            ("profiling", lambda: export_profiling(model, tmp)),
                            ("autobatch", export_autobatch), ("tune", lambda: export_tune(tmp))):
            t0 = time.perf_counter()
            before = all_kernel_counts()
            ok, entry = part()
            launches = {k: v - before[k] for k, v in all_kernel_counts().items() if v > before[k]}
            emit({"phase": f"export_path.{label}", **entry, "launches": launches,
                  "seconds": time.perf_counter() - t0, "ok": bool(ok)})
            if not ok:
                failed.append(label)
            torch.cuda.empty_cache()
    counts = {k: v for k, v in all_kernel_counts().items() if v}
    ok = not failed and counts.get("vil_layer_fwd", 0) > 0 and counts.get(
        "vil_layer_fwd_bf16", 0) > 0 and counts.get("mlstm_chunkwise_bwd", 0) > 0
    emit({"phase": "export_path", "failed": failed, "launches": counts, "smi": smi_line,
          "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError(f"export_path check failed: {failed or 'launches'}")
    return counts

# parallel_path: the parallel stack on the one card (module docstring)
PAR_RANKS = 2  # data-parallel ranks sharing the card under gloo
PAR_DP_BATCH = 2  # images a rank: the one-process step takes the global batch of 4
PAR_LOSS_RTOL = 1e-4  # the JAX test_dp_training_matches_single_device's
PAR_SP = (8, 2, 6400, 64, 128)  # B, NH, S, DH, chunk: ViL-YOLO-n's P3
PAR_SP_SEGMENTS = (2, 5)
PAR_SP_TOL = 3e-4  # rtol = atol, the JAX test_sequence_parallel_mlstm's
PAR_PP_CFG = "vil_yolol.yaml"  # the smallest scale with 2 pairs a ViL row
PAR_PP_BATCH = 2
PAR_PP_GRAD_TOL = 1e-5  # stacked vs unstacked, beyond 3x the unstacked step's own spread
PAR_MOE_BATCH = 2
# tests/test_pp_ep.py:test_model_train_mesh_ep's graph, with COCO's 80 classes
MOE_GRAPH = {"nc": 80, "backbone": [[-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
                                    [-1, 1, "MoEFFN", [4, 2]], [-1, 1, "Conv", [64, 3, 2]],
                                    [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "SPPF", [64, 5]]],
             "head": [[[2, 4, 5], 1, "Detect", ["nc"]]]}
NCCL_TRAIN = r"""
import time
t0 = time.perf_counter()
import json, sys, torch, torch.distributed as dist
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset
from xlstm_yolo_torch.engine.trainer import Trainer
from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd as k2
from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd as k3
from xlstm_yolo_torch.nn.tasks import TaskModel
root = sys.argv[1]
data = make_synthetic_dataset(root + "/ds", n_train=8, n_val=4, imgsz=320)
tr = Trainer(TaskModel("vil_yolon.yaml"), overrides={
    "data": data, "epochs": 1, "imgsz": 320, "batch": 4, "mesh_dp": 1, "workers": 0,
    "project": root, "name": "nccl", "plots": False})
metrics = tr.train()
out = {"backend": dist.get_backend(), "world": dist.get_world_size(), "mesh": repr(tr.mesh),
       "device": str(tr.device), "fitness": float(metrics["fitness"]),
       "launches": {"vil_layer_fwd": k3.launches, "vil_layer_fwd_bf16": k3.launches_bf16,
                    "mlstm_chunkwise_bwd": k2.launches,
                    "mlstm_chunkwise_bwd_bf16": k2.launches_bf16}}
dist.destroy_process_group()
out["seconds"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def sliced_choices(rec, lo: int, hi: int):
    """A ``SharedChoices`` to replay the rows [lo, hi) of a recorded
    step's batch: its TAL assignments and max-pool argmaxes (the choices
    of a detection step) sliced along the batch."""
    part = SharedChoices()
    part.assigned = [tuple(t[lo:hi] for t in a) for a in rec["assigned"]]
    part.pooled = [t[lo:hi] for t in rec["pooled"]]
    return part


def parallel_rank(rank: int, world: int, tmp: str) -> None:
    """One data-parallel rank of ``parallel_path``: ViL-YOLO-n on the
    parent's weights, its dp slice of the global batch, the one-process
    step's choices for those rows, one fp32 step's loss and gradients
    through ``TrainStep(mesh=...)`` in a gloo world on the card; reports to
    ``tmp/rank{rank}.pt``."""
    import datetime

    import torch
    import torch.distributed as dist

    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.parallel.mesh import build_mesh, shard_batch, shard_params

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    mesh = build_mesh(dp=world)
    model = build_main_model("cuda", train=True)
    model.load_state_dict(torch.load(f"{tmp}/weights.pt", weights_only=True))
    shard_params(mesh, model)
    step = TrainStep(model, amp=False, mesh=mesh)
    batch = shard_batch(mesh, train_batch("cuda", batch=PAR_DP_BATCH * world))
    lo = mesh.index("dp") * PAR_DP_BATCH
    replay = sliced_choices(torch.load(f"{tmp}/choices.pt", weights_only=True), lo,
                            lo + PAR_DP_BATCH)
    zero_kernel_counters()
    ms = []
    for it in range(2):  # the checked step (cold), then the same step warm, timed
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        with SharedChoices(replay=replay).active():
            part, _ = step.forward_loss(batch)
            step.backward(part)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        if it == 0:
            counts = dict(zip(COUNTED, (int(c) for c in kernel_counters())))
            grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    loss = part.detach().clone()
    dist.all_reduce(loss)
    out = {"rank": rank, "device": str(next(model.parameters()).device),
           "loss_share": float(part.detach()), "loss": float(loss),
           "launches": {k: v for k, v in counts.items() if v}, "step_ms": ms,
           "seconds": time.perf_counter() - t0}
    if rank == 0:
        out["grads"] = grads
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def parallel_dp(tmp: str) -> tuple:
    """The 2-rank dp step of ViL-YOLO-n at 640 px against one process on
    the global batch: loss and every gradient (``grad_errors``, TOL_REL),
    the one process's TAL and max-pool choices replayed in the ranks.
    Returns (ok, numbers, launches of the ranks)."""
    import copy

    import torch
    import torch.multiprocessing as mp

    from xlstm_yolo_torch.engine.trainer import TrainStep

    model = build_main_model("cuda", train=True)
    torch.save(model.state_dict(), f"{tmp}/weights.pt")
    one = TrainStep(copy.deepcopy(model), amp=False)
    rec = SharedChoices()
    with rec.active():
        total, _ = one.forward_loss(train_batch("cuda", batch=PAR_DP_BATCH * PAR_RANKS))
        one.backward(total)
    torch.save({"assigned": rec.assigned, "pooled": rec.pooled}, f"{tmp}/choices.pt")
    one_grads = {n: p.grad.detach().cpu() for n, p in one.model.named_parameters()}
    one_loss = float(total.detach())
    del one, model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(parallel_rank, args=(PAR_RANKS, tmp), nprocs=PAR_RANKS)  # a failed rank raises
    wall = time.perf_counter() - t0
    ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True) for r in range(PAR_RANKS)]
    worst, worst_name, vanishing, gmax = grad_errors(ranks[0]["grads"], one_grads)
    loss_rel = abs(ranks[0]["loss"] - one_loss) / abs(one_loss)
    k_ok = all(r["launches"].get("vil_layer_fwd", 0) > 0
               and r["launches"].get("mlstm_chunkwise_bwd", 0) > 0 for r in ranks)
    ok = loss_rel <= PAR_LOSS_RTOL and worst <= TOL_REL and k_ok
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return ok, {"ranks": PAR_RANKS, "batch_a_rank": PAR_DP_BATCH,
                "loss_by_rank": [r["loss_share"] for r in ranks], "loss": ranks[0]["loss"],
                "loss_one_process": one_loss, "loss_relerr": loss_rel, "loss_rtol": PAR_LOSS_RTOL,
                "grad_maxrelerr": worst, "grad_worst": worst_name, "grad_tol": TOL_REL,
                "grads_vanishing": vanishing, "grad_max": gmax,
                "launches_by_rank": [r["launches"] for r in ranks],
                "devices": [r["device"] for r in ranks],
                "step_ms_cold_warm_by_rank": [r["step_ms"] for r in ranks],
                "rank_seconds": [r["seconds"] for r in ranks], "spawn_wall_seconds": wall}, launches


def parallel_pp() -> tuple:
    """ViL-YOLO-l with ``enable_pipeline`` at pp 2 in the stacked layout (no
    mesh: the pairs in sequence) against the unstacked model on the same
    weights: eval candidates, then one fp32 step's loss and gradients (a
    stacked tensor against its pairs' stacked), the unstacked step's
    choices replayed, cuDNN deterministic. The gradients are held to
    PAR_PP_GRAD_TOL beyond three times the spread of the unstacked step
    run twice (CUDA's max-pool and upsampling backward add in no fixed
    order)."""
    import copy

    import torch

    from xlstm_yolo_torch.engine.trainer import TrainStep

    big = build_main_model("cuda", train=True, cfg=PAR_PP_CFG)
    stacked = copy.deepcopy(big)
    n = stacked.enable_pipeline(stages=2)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (PAR_PP_BATCH, IMGSZ, IMGSZ, 3)).astype(np.float32)).cuda()
    with torch.no_grad():
        want = copy.deepcopy(big).eval().predictions(x)
        got = copy.deepcopy(stacked).eval().predictions(x)
    cand_rel = ((got - want).abs().max() / want.abs().max()).item()
    batch = train_batch("cuda", batch=PAR_PP_BATCH)
    steps, rec = {}, SharedChoices()
    torch.backends.cudnn.deterministic = True
    try:
        for tag, m, ch in (("unstacked", big, rec), ("again", copy.deepcopy(big),
                                                     SharedChoices(replay=rec)),
                           ("stacked", stacked, SharedChoices(replay=rec))):
            st = TrainStep(m, amp=False)
            with ch.active():
                total, _ = st.forward_loss(batch)
                st.backward(total)
            steps[tag] = (float(total.detach()), {k: p.grad.detach().cpu()
                                                  for k, p in m.named_parameters()})
    finally:
        torch.backends.cudnn.deterministic = False
    ref, mine = steps["unstacked"][1], steps["stacked"][1]
    want = {k: torch.stack([ref[k.replace(".pairs.", f".pair{i}.")] for i in range(g.shape[0])])
            if ".pairs." in k else ref[k] for k, g in mine.items()}
    worst, worst_name, _, _ = grad_errors(mine, want)
    noise, noise_name, _, _ = grad_errors(steps["again"][1], ref)
    loss_rel = abs(steps["stacked"][0] - steps["unstacked"][0]) / abs(steps["unstacked"][0])
    grad_tol = PAR_PP_GRAD_TOL + 3 * noise
    ok = n == 3 and cand_rel <= 1e-5 and loss_rel <= 1e-6 and worst <= grad_tol
    del big, stacked
    torch.cuda.empty_cache()
    return ok, {"model": PAR_PP_CFG, "stacked_rows": n, "batch": PAR_PP_BATCH,
                "cands_maxrelerr": cand_rel, "loss": steps["stacked"][0],
                "loss_relerr": loss_rel, "grad_maxrelerr": worst, "grad_worst": worst_name,
                "grad_tol": grad_tol, "cudnn_deterministic": True,
                "unstacked_again_grad_maxrelerr": noise, "unstacked_again_worst": noise_name}


def parallel_sp() -> tuple:
    """The sequence-parallel mLSTM's three plain functions over 2 and 5
    segments at ViL-YOLO-n's P3 shape, on the card, against the unsplit
    ``mlstm_chunkwise``."""
    import torch

    from xlstm_yolo_torch.kernels.mlstm_native import mlstm_chunkwise
    from xlstm_yolo_torch.kernels.mlstm_sp import exclusive_prefix, seeded_pass, segment_summary

    B, NH, S, DH, CS = PAR_SP
    g = torch.Generator("cuda").manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda")
    q, k, v, i, f = mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S), \
        mk(B, NH, S) + 2.0
    with torch.no_grad():
        want = mlstm_chunkwise(q, k, v, i, f, chunk_size=CS)
        errs, ok = {}, True
        for segs in PAR_SP_SEGMENTS:
            n = S // segs
            parts = [[t[:, :, j * n:(j + 1) * n] for t in (q, k, v, i, f)] for j in range(segs)]
            states = exclusive_prefix([segment_summary(*p, chunk_size=CS) for p in parts])
            got = torch.cat([seeded_pass(*p, st, chunk_size=CS) for p, st in zip(parts, states)],
                            2)
            excess = ((got - want).abs() - PAR_SP_TOL * (1 + want.abs())).max().item()
            errs[str(segs)] = (got - want).abs().max().item()
            ok = ok and excess <= 0 and bool(torch.isfinite(got).all())
    return ok, {"shape": dict(zip(("B", "NH", "S", "DH", "chunk"), PAR_SP)),
                "max_abs_err_by_segments": errs, "tol": PAR_SP_TOL}


def parallel_moe() -> tuple:
    """The MoEFFN graph at 640 px on the card against the CPU: eval
    candidates, then one fp32 step's loss (with the load-balance loss) and
    gradients (``zoo_step``; the card's TAL and max-pool choices replayed
    on the CPU)."""
    import copy

    import torch

    from xlstm_yolo_torch.nn.tasks import TaskModel

    model = TaskModel(MOE_GRAPH, device="cuda", seed=0)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (PAR_MOE_BATCH, IMGSZ, IMGSZ, 3)).astype(np.float32))
    with torch.no_grad():
        got = copy.deepcopy(model).eval().predictions(x.cuda()).cpu()
        want = copy.deepcopy(model).cpu().eval().predictions(x)
    box_rel = ((got[..., :4] - want[..., :4]).abs().max() / want[..., :4].abs().max()).item()
    score_abs = (got[..., 4:] - want[..., 4:]).abs().max().item()
    batch = train_batch("cpu", batch=PAR_MOE_BATCH)
    rec = SharedChoices()
    card = zoo_step(model, "cuda", torch.float32, batch, rec)
    cpu = zoo_step(model, "cpu", torch.float32, batch, SharedChoices(replay=rec))
    worst, worst_name, vanishing, _ = grad_errors(card[1], cpu[1])
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    ok = box_rel <= TOL_REL and score_abs <= TOL_REL and loss_rel <= TOL_REL and worst <= TOL_REL
    return ok, {"batch": PAR_MOE_BATCH, "cands_box_maxrelerr_vs_cpu": box_rel,
                "cands_score_max_abs_err_vs_cpu": score_abs, "loss": card[0],
                "loss_relerr_vs_cpu": loss_rel, "grad_maxrelerr_vs_cpu": worst,
                "grad_worst": worst_name, "grads_vanishing": vanishing}


def start_nccl(tmp: str):
    """``Trainer.train`` in a child process that torchrun's variables put in
    a one-rank NCCL world (mesh_dp 1; one epoch of ViL-YOLO-n on 8 PNGs at
    320 px, validated); started after the dp check, read last by
    ``parallel_nccl``."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    return subprocess.Popen([sys.executable, "-c", NCCL_TRAIN, f"{tmp}/nccl"], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(Path(__file__).resolve().parent))


def parallel_nccl(proc) -> tuple:
    """The NCCL trainer's report: NCCL, a world of one, this rank's card,
    the kernels launched, its seconds (timed in the child); and the
    seconds this process waited for it."""
    t0 = time.perf_counter()
    stdout, stderr = proc.communicate(timeout=600)
    wait = time.perf_counter() - t0
    if proc.returncode != 0:
        raise PhaseError(f"the NCCL trainer exited {proc.returncode}: {stderr[-2000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    ok = (out["backend"] == "nccl" and out["world"] == 1 and out["device"] == "cuda:0"
          and out["launches"]["vil_layer_fwd_bf16"] > 0)
    return ok, {**out, "wait_seconds": wait}


def phase_parallel_path(smi_line):
    """The parallel stack on the one card (module docstring): the 2-rank dp
    step, the stacked ViL-YOLO-l, the sp segments, MoEFFN against the CPU,
    and a one-rank NCCL Trainer, which starts after the dp ranks' timed
    steps and runs beside the pp, sp and MoE checks (their ``seconds``
    share the card with it). Returns the launches of the phase's runs
    (this process's and the ranks')."""
    import tempfile

    t_phase = time.perf_counter()
    zero_all_kernel_counts()
    parts, failed, rank_launches = {}, [], {}
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for label, fn in (("dp", lambda: parallel_dp(tmp)), ("pp", parallel_pp),
                              ("sp", parallel_sp), ("moe", parallel_moe),
                              ("nccl", lambda: parallel_nccl(procs[0]))):
                t0 = time.perf_counter()
                ok, numbers, *extra = fn()
                if extra:
                    rank_launches = extra[0]
                parts[label] = {"seconds": time.perf_counter() - t0, **numbers, "ok": bool(ok)}
                if not ok:
                    failed.append(label)
                if label == "dp":  # the ranks' steps are timed: the child starts after them
                    procs.append(start_nccl(tmp))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    counts = {k: v for k, v in all_kernel_counts().items() if v}
    for k, v in {**rank_launches}.items():
        counts[k] = counts.get(k, 0) + v
    for k, v in parts["nccl"]["launches"].items():
        counts[k] = counts.get(k, 0) + v
    ok = not failed and counts.get("vil_layer_fwd", 0) > 0 and counts.get(
        "mlstm_chunkwise_bwd", 0) > 0
    emit({"phase": "parallel_path", **parts, "failed": failed, "launches": counts,
          "smi": smi_line, "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError(f"parallel_path check failed: {failed or 'launches'}")
    return counts


# track_path: ByteTrack and BoT-SORT over ViL-YOLO-n on PNG frames the phase writes
TRACK_FRAMES, TRACK_HW, TRACK_PAN = 24, (480, 640), 3  # frames, (h, w), px the camera pans a frame
TRACK_SQUARES = [((60, 70), (6, 3), 70), ((420, 90), (-5, 4), 80), ((150, 300), (4, -3), 60),
                 ((480, 330), (-3, -2), 75)]  # (start x, y), px a frame, side
TRACK_CLS = (0.1, -12.0)  # class weights' std and biases: some dozens of detections at
# conf 0.1 an image, some of them above 0.25
TRACK_VAL = 32  # val PNGs of the native-batch check, two batches of 16
TRACK_GMC_TOL = 1.5  # px: GMC's pan against the true 3 px (tests/test_trackers.py's bound)


def track_scene(root: Path) -> tuple:
    """TRACK_FRAMES PNGs of TRACK_HW under ``root``: a seeded texture panned
    TRACK_PAN px a frame to the left (the camera moves right) with the four
    bright squares of TRACK_SQUARES on straight paths; -> (frames, (frames,
    4, 4) true boxes x1 y1 x2 y2)."""
    from scipy.ndimage import gaussian_filter

    from xlstm_yolo_torch.data.imgproc import imwrite

    h, w = TRACK_HW
    rng = np.random.default_rng(0)
    tex = gaussian_filter(rng.uniform(0, 255, (h, w + TRACK_PAN * TRACK_FRAMES, 3)), (2, 2, 0))
    tex = np.clip((tex - tex.mean()) * 6 + 128, 0, 255).astype(np.uint8)
    frames, boxes = [], np.zeros((TRACK_FRAMES, len(TRACK_SQUARES), 4), np.float32)
    root.mkdir(parents=True, exist_ok=True)
    for f in range(TRACK_FRAMES):
        img = tex[:, TRACK_PAN * f:TRACK_PAN * f + w].copy()
        for k, ((x0, y0), (vx, vy), side) in enumerate(TRACK_SQUARES):
            x, y = x0 + vx * f, y0 + vy * f
            img[y:y + side, x:x + side] = (250, 210 + 10 * k, 40 + 50 * k)
            boxes[f, k] = (x, y, x + side, y + side)
        imwrite(root / f"{f:03d}.png", img)
        frames.append(img)
    return frames, boxes


def track_detector(model):
    """``model`` (a ViL-YOLO-n ``TaskModel``) shaped in place as
    ``shaped_detector`` shapes its model, but with small class weights and
    low biases (TRACK_CLS): some dozens of scores an image clear conf 0.1,
    a part of them 0.25."""
    import torch

    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_((torch.randn(p.shape, generator=g) * 0.05).to(p.device))
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
        det = getattr(model, f"l{model.parsed.head_index}")
        for i in range(det.nl):
            cls, box = getattr(det, f"cv3_{i}_2"), getattr(det, f"cv2_{i}_2")
            cls.weight.copy_(torch.randn(cls.weight.shape, generator=g) * TRACK_CLS[0])
            cls.bias.fill_(TRACK_CLS[1])
            box.bias.copy_(torch.arange(16.0).repeat(4) * -0.9
                           + torch.randn(box.bias.shape, generator=g) * 0.4)
            box.weight.copy_(torch.randn(box.weight.shape, generator=g) * 0.02)
    return model.eval()


@contextmanager
def recorded_trackers(log: list):
    """``Model.track``'s tracker as it is, each ``update`` recorded in
    ``log`` as (detections, frame, tracks out, ms, GMC ms or None)."""
    import xlstm_yolo_torch.trackers as trackers

    make = trackers.create_tracker

    def create(name):
        tracker = make(name)
        update, gmc = tracker.update, getattr(tracker, "gmc", None)
        gmc_ms = []
        if gmc is not None:
            apply = gmc.apply

            def timed_apply(img, detections=None):
                t0 = time.perf_counter()
                out = apply(img, detections)
                gmc_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            gmc.apply = timed_apply

        def timed_update(dets, img=None):
            d = np.array(dets, np.float32, copy=True)
            t0 = time.perf_counter()
            out = update(dets, img)
            ms = (time.perf_counter() - t0) * 1e3
            log.append((d, img, out.copy(), ms, gmc_ms.pop() if gmc_ms else None))
            return out
        tracker.update = timed_update
        return tracker

    with mock.patch.object(trackers, "create_tracker", create):
        yield


def dets_match(got, want, conf: float = 0.1) -> tuple:
    """(ok, max box error over the largest box value, max score error, rows
    set aside) of two frames' detections (x1 y1 x2 y2 conf cls) as sets:
    each row of ``want`` paired with the nearest unpaired row of ``got`` of
    its class. The predictor's scores are the bf16 roundings of its fp32
    scores (the fast selection, as in JAX), so two scores TOL_REL apart
    may round one bf16 step (2^-8 below 1) apart; where the counts differ,
    the rows that close to ``conf`` are set aside on both sides."""
    step = 2.0 ** -8
    near = 0
    if got.shape != want.shape:
        keep_g, keep_w = np.abs(got[:, 4] - conf) > step, np.abs(want[:, 4] - conf) > step
        near = int((~keep_g).sum() + (~keep_w).sum())
        got, want = got[keep_g], want[keep_w]
        if got.shape != want.shape:
            return False, float("inf"), float("inf"), near
    if not len(want):
        return True, 0.0, 0.0, near
    scale = float(np.abs(want[:, :4]).max())
    free = np.ones(len(got), bool)
    box, score = 0.0, 0.0
    for row in want:
        d = np.abs(got[:, :4] - row[:4]).max(1)
        d[~free | (got[:, 5] != row[5])] = np.inf
        j = int(np.argmin(d))
        if not np.isfinite(d[j]):
            return False, float("inf"), float("inf"), near
        free[j] = False
        box, score = max(box, float(d[j]) / scale), max(score, abs(float(got[j, 4] - row[4])))
    return bool(box <= TOL_REL and score <= step + 1e-7), box, score, near


def cands_vs_plain(model, frames) -> tuple:
    """The candidates of each frame's letterboxed input, with the kernels
    and with the plain versions forced in, at the main path's tolerance:
    (max box error over the largest box value, max score error)."""
    import torch

    from xlstm_yolo_torch.data.augment import letterbox

    box, score = 0.0, 0.0
    for frame in frames:
        img, _, _ = letterbox(frame, IMGSZ)
        x = torch.from_numpy(img).to(next(model.parameters()).device)[None].float() / 255.0
        with torch.inference_mode():
            got = model.predictions(x)
            with plain_vil_kernels():
                want = model.predictions(x)
        box = max(box, ((got[..., :4] - want[..., :4]).abs().max()
                        / want[..., :4].abs().max()).item())
        score = max(score, (got[..., 4:] - want[..., 4:]).abs().max().item())
    return box, score


def track_true_boxes(frames, boxes) -> tuple:
    """The squares' true boxes with seeded noise through ``BOTSORT``
    (``sparseOptFlow``): (ids persist, every square keeps one id from its
    first frame, GMC's pan per frame, ms a frame)."""
    from xlstm_yolo_torch.trackers import BOTSORT

    rng = np.random.default_rng(1)
    tracker = BOTSORT()
    pans, ids_by_square, ms = [], [set() for _ in TRACK_SQUARES], []
    for f, img in enumerate(frames):
        dets = np.concatenate([boxes[f] + rng.normal(0, 1.0, boxes[f].shape),
                               rng.uniform(0.6, 0.95, (len(boxes[f]), 1)),
                               np.zeros((len(boxes[f]), 1))], 1).astype(np.float32)
        t0 = time.perf_counter()
        h = tracker.gmc.apply(img)
        tracker.gmc.apply = lambda img, detections=None, h=h: h  # update applies this frame's
        out = tracker.update(dets, img)
        del tracker.gmc.apply
        ms.append((time.perf_counter() - t0) * 1e3)
        if f:
            pans.append([float(h[0, 2]), float(h[1, 2])])
        for row in out:
            iou = [box_iou(row[:4], b) for b in boxes[f]]
            ids_by_square[int(np.argmax(iou))].add(int(row[4]))
    persist = all(len(s) == 1 for s in ids_by_square) and len(set().union(*ids_by_square)) == 4
    return persist, [sorted(s) for s in ids_by_square], pans, ms


def box_iou(a, b) -> float:
    w = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    h = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = w * h
    return inter / ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)


def track_native_val(model, tmp: str) -> tuple:
    """The native batches: a non-rect val loader at 640 and batch 16 on
    TRACK_VAL synthetic PNGs (640 x 480) against the Python collate of the
    same batches (within one level), the host ms a batch of each, then
    ``Validator`` on ViL-YOLO-n over them (K3 launches a batch, the
    validator's own loader took native batches)."""
    from xlstm_yolo_torch import native
    from xlstm_yolo_torch.data.dataset import build_dataloader
    from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset
    from xlstm_yolo_torch.engine.validator import Validator

    data = make_synthetic_dataset(f"{tmp}/val", n_train=1, n_val=TRACK_VAL, width=640,
                                  height=480, seed=0)
    available = native.available()
    t0 = time.perf_counter()
    native.get_lib()  # the g++ build, on first use
    build_s = time.perf_counter() - t0
    nat, _ = build_dataloader(data, "val", batch=16, imgsz=IMGSZ, augment=False)
    py, _ = build_dataloader(data, "val", batch=16, imgsz=IMGSZ, augment=False)
    py.ds.uint8_images = True  # the loader's Python collate
    levels, n, same = 0.0, 0, True
    for a, b in zip(nat, py, strict=True):  # also reads the files once into the page cache
        levels = max(levels, float(np.abs(a["img"] * 255.0 - b["img"]).max()))
        n += int(a["mask"].sum())
        same = same and all(np.array_equal(a[k], b[k]) for k in ("mask", "ori_shape", "im_idx"))
    ms = {"native": [], "python": []}
    for kind in ("native", "python", "python", "native"):  # in turns, files warm
        loader = nat if kind == "native" else py
        for _ in loader:
            pass
        ms[kind] += [1e3 * s for s in loader.batch_seconds]
    marks, per_batch = [], []
    validator = Validator(model, imgsz=IMGSZ, batch=16)
    validator.callbacks.add("on_val_batch_start", lambda v: marks.append(kernel_counters()))
    validator.callbacks.add("on_val_batch_end",
                            lambda v: per_batch.append(kernel_counters() - marks[-1]))
    metrics = validator(data)
    per_batch = sorted({tuple(c.tolist()) for c in per_batch})
    ok = (available and nat.native_batches == 3 * TRACK_VAL // 16 and py.native_batches == 0
          and levels <= 1.0 + 1e-3 and same and validator.loader.native_batches == TRACK_VAL // 16
          and per_batch == [(len(STAGES), 0, 0, 0)]
          and all(np.isfinite(metrics[k]) for k in FIT_METRICS))
    return ok, {"available": available, "build_s": build_s,
                "native_batches": nat.native_batches,
                "native_ms_per_batch": ms["native"], "python_ms_per_batch": ms["python"],
                "native_ms_mean": float(np.mean(ms["native"])),
                "python_ms_mean": float(np.mean(ms["python"])),
                "max_levels_apart": levels, "labels": n,
                "validator_native_batches": validator.loader.native_batches,
                "validator_launches_per_batch": per_batch, "metrics": metrics,
                "val_img_s": metrics["img_s"]}


def phase_track_path(smi_line):
    """Multi-object tracking on the card (module docstring): ``Model.track``
    with ``bytetrack.yaml`` and ``botsort.yaml`` over the scene's PNGs (K3 3
    times a frame), each frame's detections against the plain-forced
    predictor, both trackers again on the CPU on the card's detections and
    frames, the true boxes through ``BOTSORT``, the native val batches.
    Returns the phase's K3 launches."""
    import tempfile

    import torch

    from xlstm_yolo_torch import YOLO
    from xlstm_yolo_torch.engine.predictor import Predictor
    from xlstm_yolo_torch.trackers import create_tracker
    from xlstm_yolo_torch.trackers.track import trackable

    t_phase = time.perf_counter()
    n = len(STAGES)
    parts, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        frames, boxes = track_scene(Path(tmp) / "frames")
        model = YOLO("vil_yolo.yaml", scale="n")
        track_detector(model.model)
        zero_all_kernel_counts()
        runs = {}
        for name in ("bytetrack", "botsort"):
            log, t0 = [], time.perf_counter()
            before = kernel_counters()
            with recorded_trackers(log):
                results = model.track(Path(tmp) / "frames", tracker=f"{name}.yaml", imgsz=IMGSZ,
                                      verbose=False)
            torch.cuda.synchronize()
            launches = (kernel_counters() - before).tolist()
            runs[name] = (results, log)
            pred_ms = [sum(r.speed.values()) for r in results]  # after the PNG decode
            parts[name] = {
                "seconds": time.perf_counter() - t0, "frames": len(results),
                "launches": launches, "expected_launches": [n * TRACK_FRAMES, 0, 0, 0],
                "detections": [len(d) for d, *_ in log], "tracks": [len(o) for _, _, o, *_ in log],
                "ids": len({int(i) for r in results for i in r.track_ids}),
                "predictor_ms_first_frame": pred_ms[0],
                "predictor_ms_per_frame": float(np.median(pred_ms[1:])),
                "tracker_ms_per_frame": float(np.median([m for *_, m, _ in log])),
                "gmc_ms_per_frame": (float(np.median([g for *_, g in log[1:]]))
                                     if name == "botsort" else None)}
            if launches != parts[name]["expected_launches"] or len(results) != TRACK_FRAMES:
                failed.append(f"{name}_launches")
            if not parts[name]["ids"]:
                failed.append(f"{name}_no_tracks")
        path_launches = {k: v for k, v in zip(COUNTED, kernel_counters().tolist()) if v}
        # each frame's candidates and detections against the plain-forced model
        with uncounted():
            cand_box, cand_score = cands_vs_plain(model.model, frames)
            with plain_vil_kernels():
                plain = Predictor(model.model, imgsz=IMGSZ, conf=0.1, verbose=False)(frames)
        errs = [dets_match(d, trackable(p.boxes.data))
                for (d, *_), p in zip(runs["bytetrack"][1], plain)]
        same_dets = all(np.array_equal(a[0], b[0]) for a, b in zip(runs["bytetrack"][1],
                                                                   runs["botsort"][1]))
        parts["vs_plain"] = {"cands_box_maxrelerr": cand_box, "cands_score_max_abs_err": cand_score,
                             "frames_ok": sum(e[0] for e in errs),
                             "dets_box_maxrelerr": max(e[1] for e in errs),
                             "dets_score_max_abs_err": max(e[2] for e in errs),
                             "rows_at_conf_set_aside": sum(e[3] for e in errs),
                             # boxes clipped to nothing at the frame's edge, not tracked
                             "zero_area_detections": sum(len(p) - len(trackable(p.boxes.data))
                                                         for p in plain),
                             "both_runs_same_detections": same_dets}
        if (not all(e[0] for e in errs) or not same_dets or cand_box > TOL_REL
                or cand_score > TOL_REL):
            failed.append("vs_plain")
        # both trackers again on the CPU, on the card's detections and frames
        replay = {}
        for name, (_, log) in runs.items():
            tracker = create_tracker(f"{name}.yaml")
            t0 = time.perf_counter()
            outs = [tracker.update(d, img) for d, img, *_ in log]
            replay[name] = {"identical": all(np.array_equal(o, rec[2]) for o, rec in
                                             zip(outs, log)),
                            "ms_per_frame": (time.perf_counter() - t0) * 1e3 / len(log)}
            if not replay[name]["identical"]:
                failed.append(f"{name}_replay")
        parts["cpu_replay"] = replay
        # the squares' true boxes through BoT-SORT: ids across the pan, GMC's pan
        persist, ids, pans, ms = track_true_boxes(frames, boxes)
        pan_err = max(max(abs(px + TRACK_PAN), abs(py)) for px, py in pans)
        parts["true_boxes"] = {"ids_per_square": ids, "persist": persist,
                               "gmc_pan_mean": np.mean(pans, 0).tolist(), "gmc_pan_max_err": pan_err,
                               "ms_per_frame": float(np.mean(ms))}
        if not persist or pan_err > TRACK_GMC_TOL:
            failed.append("true_boxes")
        # the native val batches, and validation on them
        zero_kernel_counters()
        val_ok, parts["native_val"] = track_native_val(model.model, tmp)
        for k, v in zip(COUNTED, kernel_counters().tolist()):
            if v:
                path_launches[k] = path_launches.get(k, 0) + v
        if not val_ok:
            failed.append("native_val")
    ok = not failed and path_launches.get("vil_layer_fwd", 0) == 2 * n * TRACK_FRAMES + n * (
        TRACK_VAL // 16)
    emit({"phase": "track_path", "model": "vil_yolo.yaml scale n", "card": smi_line,
          "frames": TRACK_FRAMES, "hw": list(TRACK_HW), "imgsz": IMGSZ, "pan_px": TRACK_PAN,
          **parts, "failed": failed, "launches": path_launches,
          "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise PhaseError(f"track_path check failed: {failed or 'launches'}")
    return path_launches


def main() -> int:
    t_run = time.perf_counter()
    phase = "device"
    try:
        smi_line, name = phase_device()
        phase = "build"
        phase_build()
        phase = "kernel_parity"
        k3, k2, k1, k5, k5b, k4, k7, k6, k8, k3b, k2b, small_dh = phase_kernel_parity()
        phase = "main_path"
        launches = phase_main_path()
        phase = "main_path_bf16"
        bf16_launches = phase_main_path_bf16()
        phase = "train_path"
        train_launches = phase_train_path()
        phase = "train_loop_amp"
        amp_launches = phase_train_loop_amp()
        phase = "fit_path"
        fit_launches, fit_summary = phase_fit_path(smi_line)
        phase = "fit_path_devaug"
        devaug_launches = phase_fit_path_devaug(smi_line, fit_summary)
        phase = "lm_path"
        lm_launches = phase_lm_path()
        phase = "cls_path"
        by_path, cls_img_s = phase_cls_path()
        phase = "kth_path"
        kth_launches = phase_kth_path()
        phase = "conv_path"
        conv_launches = phase_conv_path()
        phase = "lm_train_path"
        lm_train_launches = phase_lm_train_path()
        phase = "scales_path"
        scales_launches = phase_scales_path()
        phase = "vil_headdim_path"
        headdim_launches, dh4_img_s = phase_vil_headdim_path()
        phase = "vil_family_path"
        family_launches, no_outnorm = phase_vil_family_path(
            {"cls_path": cls_img_s, "vil_headdim_path.cls_dh4": dh4_img_s})
        phase = "detect_keys_path"
        keys_launches, rect = phase_detect_keys_path(smi_line)
        phase = "xlstm7b_path"
        xlstm7b_launches = phase_xlstm7b_path()
        phase = "yolo11_path"
        yolo11_launches = phase_yolo11_path()
        phase = "detect_zoo_path"
        zoo_launches = phase_detect_zoo_path(smi_line)
        phase = "tasks_path"
        tasks_launches = phase_tasks_path(smi_line)
        phase = "classify_path"
        classify_launches, classify_ms = phase_classify_path(smi_line)
        phase = "rtdetr_path"
        rtdetr_launches = phase_rtdetr_path(smi_line)
        phase = "world_path"
        world_launches = phase_world_path(smi_line)
        phase = "sam_path"
        sam_launches = phase_sam_path(smi_line)
        phase = "export_path"
        export_launches = phase_export_path(smi_line)
        phase = "parallel_path"
        parallel_launches = phase_parallel_path(smi_line)
        phase = "track_path"
        track_launches = phase_track_path(smi_line)
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
               "fit_path_devaug": devaug_launches,
               "lm_path": dict(zip(("mlstm_chunkwise_fwd", "slstm_scan_fwd"), lm_launches)),
               **by_path,
               "kth_path": {"rowwise_kth_value": kth_launches},
               "conv_path": conv_launches,
               "lm_train_path": lm_train_launches,
               "scales_path": scales_launches,
               **headdim_launches,
               **family_launches,
               "detect_keys_path": keys_launches,
               "xlstm7b_path": xlstm7b_launches,
               "yolo11_path": yolo11_launches,
               "detect_zoo_path": zoo_launches,
               "tasks_path": tasks_launches,
               "classify_path": classify_launches,
               "rtdetr_path": rtdetr_launches,
               "world_path": world_launches,
               "sam_path": sam_launches,
               "export_path": export_launches,
               "parallel_path": parallel_launches,
               "track_path": track_launches}

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
                   if fp32 else {}),
                **({"small_head_dim_ms_by_case": small_dh[name]["ms_by_case"]}
                   if name in small_dh else {}),
                **({"no_outnorm_ms_by_case": no_outnorm[name]["ms_by_case"]}
                   if name in no_outnorm else {}),
                **({"rect_ms_by_case": rect[name]} if name in rect else {}),
                **({"classify_ms_by_case": classify_ms[name]} if name in classify_ms else {})}

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
    emit({"run_seconds": time.perf_counter() - t_run})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
