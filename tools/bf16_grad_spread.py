"""The spread of the bf16 ViL layer's gradient errors over output-gradient
draws, on one NVIDIA GPU: the quantity ``tests/test_torch_cuda.py::
test_vil_layer_bf16_grads_match_plain`` bounds, taken two ways for each of
``DRAWS`` seeded draws of the output gradient at the test's shapes (P4 and
``ragged``, or scale x's widths) and arguments:

* ``kernel``: the kernels (K3 and K2 in bf16 under the hand backward)
  against the plain bf16 forward and backward, the largest error beyond the
  bf16 rounding over the max of each gradient (``_rel_bf16``);
* ``floor``: the plain version against itself on weights one fp32 ulp apart
  (``_nudged``), the test's own noise reference.

Prints the card's name and power limit, one JSON line per shape and draw
(``kernel`` and ``floor`` per gradient, named), and one summary line per
shape and gradient: the largest, median and smallest of each over the draws,
and how many draws the test's bound ``max(MAX_EXCESS_GRAD, 2 floor)`` would
fail. Run from the root of a checkout:

    python3 tools/bf16_grad_spread.py [DRAWS [SHAPE ...]]

SHAPE is one of P4, ragged (the default pair), x_P5, x_ragged.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "tests")]

NAMES = ("x", "conv_act", "rms_scale", "wu", "bu", "wq", "bq", "wk", "bk", "wv", "bv", "wgi",
         "bgi", "wgf", "bgf", "nscale", "nbias", "skip", "wd", "bd")
# the card test's shapes (test_vil_layer_bf16_grads_match_plain), and scale x's P5 and a
# ragged S at its widths (test_bf16_kernels_at_scale_x_width_match_plain)
SHAPES = {"P4": (1600, 128, 4), "ragged": (200, 64, 2), "x_P5": (400, 640, 20),
          "x_ragged": (230, 640, 20)}


def main() -> None:
    from test_torch_cuda import (MAX_EXCESS_GRAD, _bf16_layer_args, _nudged, _rel_bf16)

    from xlstm_yolo_torch.kernels.vil_cell import Cfg
    from xlstm_yolo_torch.kernels.vil_layer import _layer_plain, vil_layer_bwd_ref, vil_layer_fwd

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    draws = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    names = sys.argv[2:] or ["P4", "ragged"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for name in names:
        S, DIM, NH = SHAPES[name]
        args = _bf16_layer_args(2, S, DIM, NH, dev, seed=S + 9)
        _, acts = _layer_plain(args, Cfg(NH, 64))
        nudged = [_nudged(a) for a in args]
        _, acts_n = _layer_plain(nudged, Cfg(NH, 64))
        rows = []
        for d in range(draws):
            g = torch.Generator(dev).manual_seed(1000 + d)
            gout = torch.randn(2, S, DIM, device=dev, generator=g).bfloat16()
            leaves = [a.clone().requires_grad_() for a in args]
            out = vil_layer_fwd(*leaves, NH)
            (out.float() * gout.float()).sum().backward()
            want = vil_layer_bwd_ref(args, acts, gout, NH, chunk_size=64)
            noise = vil_layer_bwd_ref(nudged, acts_n, gout, NH, chunk_size=64)
            torch.cuda.synchronize()
            row = {}
            for n, leaf, w, wn in zip(NAMES, leaves, want, noise):
                row[n] = {"kernel": _rel_bf16(leaf.grad, w)[1],
                          "floor": _rel_bf16(wn.to(leaf.grad.dtype), w)[1]}
            rows.append(row)
            print(json.dumps({"shape": name, "draw": d, "excess": row}), flush=True)
        for n in NAMES:
            k = np.array([r[n]["kernel"] for r in rows])
            f = np.array([r[n]["floor"] for r in rows])
            fails = int((k > np.maximum(MAX_EXCESS_GRAD, 2 * f)).sum())
            print(json.dumps({"summary": name, "grad": n, "draws": draws,
                              "kernel_max": k.max(), "kernel_median": float(np.median(k)),
                              "kernel_min": k.min(), "floor_max": f.max(),
                              "floor_median": float(np.median(f)), "floor_min": f.min(),
                              "fails_at_test_bound": fails}), flush=True)


if __name__ == "__main__":
    main()
