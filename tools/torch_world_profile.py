"""YOLO-World on one NVIDIA GPU: ``chip_smoke.py``'s ``world_path`` alone,
then where yolov8l-world's time goes.

    python3 tools/torch_world_profile.py             # the phase, then the windows
    python3 tools/torch_world_profile.py --phase     # the phase alone
    python3 tools/torch_world_profile.py --profile   # the windows alone

The phase as ``chip_smoke.py`` runs it (its JSON lines). The windows: with
``torch.profiler`` (CPU and CUDA activities), a few calls of yolov8l-world's
fused eval forward and decode at batch 8 on the 80 COCO prompts' guide, in
fp32 and in bf16 serving, a few fp32 train steps on a batch guide with
padded slots, and the text tower's encode of the 80 prompts; one JSON line
a window as ``tools/torch_lm_profile.py`` prints them (wall and
device-busy ms a call, the idle share, kernels a call, the top kernels).
The last line is the card's name and power limit. Needs a GPU; imports
nothing of JAX.
"""
from __future__ import annotations

import copy
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from torch_lm_profile import profile_window  # noqa: E402  (beside this file)


def windows() -> None:
    import torch

    from xlstm_yolo_torch.engine.predictor import Predictor
    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.nn.clip_text import CLIPTextTower, ClipTextEncoder
    from xlstm_yolo_torch.nn.fuse import fuse_conv_bn
    from xlstm_yolo_torch.nn.tasks import TaskModel

    prompts = cs.coco_prompts()
    with tempfile.TemporaryDirectory() as tmp:
        enc = ClipTextEncoder(cs.write_merges(f"{tmp}/bpe.txt", prompts),
                              tower=CLIPTextTower(**cs.CLIP_B32), n_merges=None, device="cuda")
    profile_window("clip_text_tower.encode_80_prompts", lambda: enc.features(prompts), calls=3)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (cs.BATCH, *cs.SRC_HW, 3), dtype=np.uint8)).cuda()
    label, cfg, scale, _ = cs.WORLD_MODELS[0]
    model = TaskModel(cfg, scale=scale, device="cuda", seed=0)
    model.set_classes(prompts, encoder=enc)
    for dtype in ("float32", "bfloat16"):
        fused = fuse_conv_bn(cs.zero_biases(copy.deepcopy(model).eval()))
        pred = Predictor(fused, imgsz=cs.IMGSZ, dtype=dtype, verbose=False)
        with torch.inference_mode():
            x, _ = pred.preprocess(frames)
            profile_window(f"{label}.forward_decode_{dtype}_batch8", lambda: pred.decode(x),
                           calls=3)
        del fused, pred
    step = TrainStep(copy.deepcopy(model), amp=False)
    batch = cs.world_batch("cuda", cs.BATCH, cs.IMGSZ)
    profile_window(f"{label}.train_step_fp32_batch8", lambda: step(batch), calls=3)


def main() -> int:
    smi_line, _ = cs.phase_device()
    if "--profile" not in sys.argv:
        cs.phase_world_path(smi_line)
    if "--phase" not in sys.argv:
        windows()
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
