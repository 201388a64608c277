"""Where the ViL classifier's time goes on one NVIDIA GPU (PyTorch port).

    python3 tools/torch_cls_profile.py

Traces, with ``torch.profiler`` (CPU and CUDA activities), the model that
``chip_smoke.py`` drives in its ``cls_path`` phase, on the same images
(``chip_smoke.cls_inputs``): a few eval forwards, and a few stochastic-depth
train steps (forward, loss, backward, update). For each window
it prints one JSON line as ``tools/torch_lm_profile.py`` does: the wall time
per call, the device-busy time per call, the idle share, the number of
kernels per call, and the kernels that take most of the device time, by
name. The last line is the card's name and power limit. Needs a GPU; imports
nothing of JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from torch_lm_profile import profile_window  # noqa: E402  (beside this file)


def main() -> int:
    import torch

    from xlstm_yolo_torch.utils.loss import classification_loss
    from xlstm_yolo_torch.utils.train_utils import StepUpdate

    smi_line, _ = cs.phase_device()
    cs.phase_build()
    x, labels = cs.cls_inputs()
    model = cs.build_cls_model(train=False)
    with torch.no_grad():
        profile_window("eval_forward_batch64", lambda: model(x), calls=3)
    model.train()
    update = StepUpdate(model)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def step():
        model.zero_grad(set_to_none=True)
        classification_loss(model(x, generator=gen), labels).backward()
        update(2)

    profile_window("train_step_batch64", step, calls=3)
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
