"""Where xLSTM-7B's decode step spends its time on one NVIDIA GPU (PyTorch port).

    python3 tools/xlstm7b_decode_profile.py [num_blocks]

Builds ``xLSTMLarge`` at ``chip_smoke.XLSTM_7B`` (``num_blocks`` 32 unless
given) on seeded weights drawn on the card and prefills a 512-token prompt
at batch 1, as ``chip_smoke.py``'s ``xlstm7b_path`` does. Then:

* ``torch.profiler`` windows (``tools/torch_lm_profile.profile_window``) over
  eager decode steps (``DecodeGraph(graph=False).step``) and over CUDA-graph
  replays (``DecodeGraph().step``): wall ms per token, device-busy ms per
  token, the idle share, kernels per token and the top kernels by name;
* CUDA events around the step's matrix-vector products alone: every
  ``nn.Linear`` of the model, in the step's order, on a one-token input
  (the GEMVs that must read every weight), beside the bytes bound of the
  whole step (``chip_smoke.decode_bytes_bound_ms``) and the graph step's
  event ms.

One JSON line per window; the last line is the card's name and power
limit. Needs a GPU; imports nothing of JAX.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from torch_lm_profile import profile_window  # noqa: E402

STEPS = 8


def event_ms(fn, iters: int = STEPS) -> float:
    import torch

    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(iters):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / iters


def main() -> None:
    import torch

    from xlstm_yolo_torch.nn import xlstm_large as XL

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {**cs.XLSTM_7B, "num_blocks": int(sys.argv[1]) if len(sys.argv) > 1 else 32}
    model = XL.xLSTMLarge(**cfg, device="cuda", seed=0)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg["vocab_size"],
                                                                (1, cs.XL_PROMPT))).cuda()
    last, state = XL.prefill(model, prompt)
    with torch.no_grad():
        for graph in (False, True):
            dec = XL.DecodeGraph(model, 1, 10 * STEPS, graph=graph)
            dec.reset(last, state)
            name = "graph_step" if graph else "eager_step"
            profile_window(f"xlstm7b.{name}", dec.step, STEPS)
            dec.reset(last, state)
            cs.emit({"window": f"xlstm7b.{name}.events", "ms_per_token": event_ms(dec.step)})
            del dec
        linears = [m for m in model.modules() if isinstance(m, torch.nn.Linear)]
        inputs = [torch.randn(1, 1, m.in_features, device="cuda") for m in linears]

        def gemvs():
            for m, x in zip(linears, inputs):
                m(x)

        cs.emit({"window": "xlstm7b.gemvs_only", "num_blocks": cfg["num_blocks"],
                 "linears": len(linears), "ms_per_token": event_ms(gemvs),
                 "weight_gib": sum(m.weight.numel() for m in linears) * 4 / 2**30,
                 "decode_bytes_bound_ms": cs.decode_bytes_bound_ms(model, 1)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
