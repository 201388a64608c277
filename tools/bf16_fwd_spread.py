"""The bf16 ViL layer kernel's forward error against its plain version, beside
the plain version's own noise, on one NVIDIA GPU.

    python3 tools/bf16_fwd_spread.py [DRAWS]

For each case (batch, S and ViL-YOLO-n's P4 or P5 widths; S a multiple of
the 64-token chunk or not) and each of DRAWS seeded argument draws
(``chip_smoke.layer_args``; the first seed is the one ``chip_smoke.py``'s
``detect_keys_path`` draws), two readings in ``chip_smoke.compare_bf16``'s
terms, the largest error beyond the bf16 rounding over the output's max (the
gate is ``BF16_MAX_EXCESS``) and the relative L2 error:

* ``kernel``: ``vil_layer_fwd`` on bf16 activations against
  ``vil_layer_ref(..., keep_fp32=True)``;
* ``floor``: the plain version on weights one fp32 ulp apart
  (``chip_smoke.nudged_weights``), rounded to bf16, against the same
  reference.

For the kernel's largest error it also prints where it lies: the token, its
place in its chunk, and whether that chunk is the partial last one. One
JSON line per case and draw, one summary line per case, then the card's name
and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

# (name, B, S, DIM, INNER, NH): P4 at the square 672 bucket (S 1764, 27 chunks and 36 tokens)
# and its neighbours of whole chunks, P4 at 640 px, P5 at the 672 bucket and at 640 px
CASES = [("P4_42x42", 8, 1764, 128, 256, 4), ("P4_S1728", 8, 1728, 128, 256, 4),
         ("P4_S1792", 8, 1792, 128, 256, 4), ("P4_40x40", 8, 1600, 128, 256, 4),
         ("P5_21x21", 8, 441, 256, 512, 8), ("P5_20x20", 8, 400, 256, 512, 8)]


def main() -> int:
    import statistics

    import torch

    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd, vil_layer_ref

    draws = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    smi_line, _ = cs.phase_device()
    cs.phase_build()
    for name, B, S, DIM, INNER, NH in CASES:
        rows = []
        for d in range(draws):
            a = cs.layer_args(B, S, DIM, INNER, NH, seed=S + 31 + 1000 * d, device="cuda")
            a = [a[0].bfloat16(), a[1].bfloat16(), *a[2:]]
            with torch.inference_mode():
                want = vil_layer_ref(*a, NH, chunk_size=KERNEL_CS, keep_fp32=True)
                got = vil_layer_fwd(*a, NH)
                floor = vil_layer_ref(*cs.nudged_weights(a), NH, chunk_size=KERNEL_CS,
                                      keep_fp32=True).bfloat16()
            top = want.abs().max().item()
            k_abs, k_l2, _ = cs.compare_bf16(got, want)
            f_abs, f_l2, _ = cs.compare_bf16(floor, want)
            g, w = got.float(), want.float()
            excess = ((g - w).abs() - 0.5 * cs.bf16_ulp(torch.maximum(g.abs(), w.abs())))
            b, s, c = (int(i) for i in torch.unravel_index(excess.argmax(), excess.shape))
            rows.append({"case": name, "B": B, "S": S, "draw": d, "kernel_excess": k_abs / top,
                         "kernel_rel_l2": k_l2, "floor_excess": f_abs / top, "floor_rel_l2": f_l2,
                         "over_gate": k_abs / top > cs.BF16_MAX_EXCESS,
                         "worst": {"b": b, "token": s, "channel": c,
                                   "in_chunk": s % KERNEL_CS,
                                   "partial_chunk": s >= S // KERNEL_CS * KERNEL_CS
                                   and S % KERNEL_CS != 0,
                                   "want": w[b, s, c].item(), "got": g[b, s, c].item()}})
            cs.emit(rows[-1])
        cs.emit({"case": name, "B": B, "S": S, "draws": draws,
                 "kernel_excess_max_median": [max(r["kernel_excess"] for r in rows),
                                              statistics.median(r["kernel_excess"] for r in rows)],
                 "floor_excess_max_median": [max(r["floor_excess"] for r in rows),
                                             statistics.median(r["floor_excess"] for r in rows)],
                 "over_gate": sum(r["over_gate"] for r in rows),
                 "worst_in_partial_chunk": sum(r["worst"]["partial_chunk"] for r in rows)})
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
