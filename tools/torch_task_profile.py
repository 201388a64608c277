"""Where the segment, pose and OBB flagships' time goes on one NVIDIA GPU.

    python3 tools/torch_task_profile.py

For each flagship of ``chip_smoke.py``'s ``tasks_path`` (yolo11n-seg at 80
classes, 640 px; yolo11n-pose at 1 class and 17 keypoints, 640 px;
yolo11n-obb at 15 classes, 1024 px), fused, on the phase's batch of 8
letterboxed frames: traces with ``torch.profiler`` (CPU and CUDA
activities) a few calls of the eval forward and decode
(``predictions_full``) and a few fp32 train steps, and prints one JSON line
a window as ``tools/torch_lm_profile.py`` does (wall and device-busy ms a
call, the idle share, kernels a call, the top kernels by name); then the
host's ms to assemble one mask (segment) at the frame's size, by the clock.
The last line is the card's name and power limit. Needs a GPU; imports
nothing of JAX.
"""
from __future__ import annotations

import copy
import sys
import time
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
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (cs.BATCH, *cs.SRC_HW, 3), dtype=np.uint8)).cuda()
    for label, cfg, nc, kpt, imgsz, _, _ in cs.TASK_FLAGSHIPS:
        model = cs.task_model(cfg, nc=nc, kpt_shape=kpt)
        fused = fuse_conv_bn(cs.zero_class_biases(copy.deepcopy(model).eval()))
        pred = Predictor(fused, imgsz=imgsz, verbose=False)
        with torch.inference_mode():
            x, (r, px, py) = pred.preprocess(frames)
            profile_window(f"{label}.forward_decode_batch8", lambda: pred.decode(x), calls=3)
            full = {k: v.float() for k, v in pred.decode(x).items()}
            dets, valid = pred.postprocess(full["cands"])
        if fused.task == "segment":
            host = {k: v.cpu().numpy() for k, v in full.items()}
            d = dets[0][valid[0]].cpu().numpy()[:1]
            t0 = time.perf_counter()
            for _ in range(5):
                pred._assemble_masks(d, host["cands"][0], host["coefs"][0], host["proto"][0],
                                     cs.SRC_HW, r, px, py)
            cs.emit({"window": f"{label}.one_mask_on_the_host", "ms": (time.perf_counter() - t0)
                     * 1e3 / 5, "frame_hw": list(cs.SRC_HW)})
        step = TrainStep(copy.deepcopy(model), amp=False)
        batch = cs.task_batch(model, "cuda", cs.BATCH, imgsz)
        profile_window(f"{label}.train_step_fp32_batch8", lambda: step(batch), calls=3)
        del model, fused, pred, step
        torch.cuda.empty_cache()
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
