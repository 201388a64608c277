"""Where the xLSTM language model's time goes on one NVIDIA GPU (PyTorch port).

    python3 tools/torch_lm_profile.py

Traces, with ``torch.profiler`` (CPU and CUDA activities), the models that
``chip_smoke.py`` drives in its ``lm_path`` phase, on the same tokens
(``chip_smoke.lm_inputs``): a few forwards of the README model at its
context, a few greedy ``generate`` steps from the prompt, and a few forwards
of the wide model; then the train steps that ``lm_train_path`` drives (its
three models, ``chip_smoke.LM_TRAIN_MODELS``: the mLSTM-only one at the
README widths, the README model with its sLSTM block, the wide model at S
1024, on ``chip_smoke.lm_train_inputs``: forward, ``lm_loss``, backward,
``StepUpdate``). For each window it prints one JSON line: the wall time
per call, the device-busy time per call (the sum of the CUDA kernels' own
times), the idle share (1 - busy / wall), the number of kernels per call,
and the kernels that take most of the device time, by name. The last line
is the card's name and power limit. Needs a GPU; imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

TOP = 12


def profile_window(name: str, fn, calls: int) -> None:
    """Trace ``calls`` runs of ``fn`` after one warm-up and print the split."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t, n = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (t + ev.self_device_time_total / 1e3, n + 1)
    busy_ms = sum(t for t, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    cs.emit({"window": name, "calls": calls, "wall_ms_per_call": wall_ms / calls,
             "device_busy_ms_per_call": busy_ms / calls,
             "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
             "kernels_per_call": sum(n for _, n in kernels.values()) / calls,
             "top_kernels": [{"name": k[:80], "ms_per_call": t / calls, "per_call": n / calls}
                             for k, (t, n) in top]})


def main() -> int:
    import torch

    from xlstm_yolo_torch.nn.xlstm import generate
    from xlstm_yolo_torch.utils.loss import lm_loss
    from xlstm_yolo_torch.utils.train_utils import StepUpdate

    smi_line, _ = cs.phase_device()
    cs.phase_build()
    model, tokens, wide, wide_tokens = cs.lm_inputs()
    with torch.no_grad():
        profile_window("readme_forward_S256", lambda: model(tokens), calls=5)
        profile_window("readme_generate_8_tokens_from_S192",
                       lambda: generate(model, tokens[:, :cs.LM_PROMPT], max_new_tokens=8), calls=2)
        profile_window("wide_forward_S1024", lambda: wide(wide_tokens), calls=3)
    del model, wide
    for label, cfg, S in cs.LM_TRAIN_MODELS:
        trained = cs.build_lm_model(cfg, "cuda").train()
        update = StepUpdate(trained)
        inputs, targets = cs.lm_train_inputs(cfg["vocab_size"], S)

        def train_step():
            trained.zero_grad(set_to_none=True)
            lm_loss(trained(inputs), targets).backward()
            update(1)

        profile_window(f"{label}_train_step_S{S}", train_step, calls=3)
        del trained, update
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
