"""The classify task on one NVIDIA GPU: ``chip_smoke.py``'s ``classify_path``
alone, then where two of its models' time goes.

    python3 tools/torch_classify_profile.py            # the phase, then the profiles
    python3 tools/torch_classify_profile.py --profile  # the profiles alone

Builds the port's kernels and runs ``classify_path`` as ``chip_smoke.py``
runs it (its lines, and a failure ends the run with a non-zero code). Then,
for yolo11n-cls at 1000 classes and the ViL classifier (``vil_yolo.yaml``
rows 0-9 at scale n under ``Classify``), fused, at the phase's batch of 64
letterboxed 224 px frames: traces with ``torch.profiler`` a few eval
forwards with the softmax, and a few fp32 and AMP train steps, and prints
one JSON line a window as ``tools/torch_lm_profile.py`` does (wall and
device-busy ms a call, the idle share, kernels a call, the top kernels by
name). The last line is the card's name and power limit. Needs a GPU;
imports nothing of JAX.
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from torch_lm_profile import profile_window  # noqa: E402  (beside this file)


def main() -> int:
    import torch

    from xlstm_yolo_torch.engine.predictor import Predictor
    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn

    smi_line, _ = cs.phase_device()
    cs.phase_build()
    if "--profile" not in sys.argv[1:]:
        try:
            cs.phase_classify_path(smi_line)
        except Exception as e:  # report the failure as chip_smoke.py does, then stop
            cs.emit({"phase": "classify_path", "ok": False, "error": f"{type(e).__name__}: {e}"})
            return 1
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (cs.CLS_BATCH, *cs.CLASSIFY_SRC_HW, 3), dtype=np.uint8)).cuda()
    batch = cs.classify_batch("cuda")
    for label, cfg in (("yolo11n-cls", "yolo11n-cls.yaml"), (cs.VIL_CLASSIFIER, None)):
        model = cs.classify_model(label, cfg)
        pred = Predictor(fuse_conv_bn(copy.deepcopy(model).eval()), imgsz=cs.CLS_HW, verbose=False)
        with torch.inference_mode():
            x, _ = pred.preprocess(frames)
            profile_window(f"{label}.forward_softmax_batch64", lambda: pred.decode(x), calls=5)
        for amp in (False, True):
            step = TrainStep(copy.deepcopy(model), amp=amp)
            profile_window(f"{label}.train_step_{'amp' if amp else 'fp32'}_batch64",
                           lambda: step(batch), calls=3)
            del step
        del model, pred
        torch.cuda.empty_cache()
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
