"""Times the public wrappers of the chunkwise mLSTM forward (K1,
``mlstm_chunkwise_fwd``) and the sLSTM scan (K5, ``slstm_scan_fwd``) on one
NVIDIA GPU, in whichever checkout of this repository is first on the path:

    PYTHONPATH=<checkout> python3 tools/wrapper_times.py

so that ``tools/ab_kernels.sh`` can run the same shapes in a parent commit
and a change, in turns, on one card. Shapes: K1 at the language model's
head dims and sequence lengths (and the ragged lengths ``generate`` gives
it); K5 at head dims 32, 64 and 128 at batch 8, and at head dim 128 at
batch 64. Prints the card's name and power limit, then one JSON line per
shape: ``ms``, the wrapper call's time by CUDA events over 20 calls after 2
(host work included where it outlasts the kernel), ``device_ms``, the time
of the kernel's own launches per call from torch.profiler, and microseconds
per step of each. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

K1_SHAPES = [(8, 4, 256, 64), (8, 4, 200, 64), (8, 4, 1024, 256), (8, 4, 1024, 128)]
K5_SHAPES = [(8, 4, 256, 32), (8, 4, 1024, 64), (8, 4, 1024, 128), (64, 4, 256, 128)]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 2) -> float:
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


def device_ms(fn, name: str, iters: int = 10) -> float:
    """Device time per call of the kernels whose name holds ``name``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
             for e in prof.key_averages() if name in e.key)
    return us / iters / 1e3


def main() -> None:
    from xlstm_yolo_torch.kernels.mlstm_fwd import mlstm_chunkwise_fwd
    from xlstm_yolo_torch.kernels.slstm import slstm_scan_fwd

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    report = lambda kernel, shape, ms, dev_ms: print(json.dumps(
        {"kernel": kernel, "shape": list(shape), "ms": ms, "device_ms": dev_ms,
         "us_per_step": ms * 1e3 / shape[2], "device_us_per_step": dev_ms * 1e3 / shape[2]}),
        flush=True)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()
    with torch.no_grad():
        for B, NH, S, DH in K1_SHAPES:
            args = (mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S),
                    mk(B, NH, S) + 2.0)
            run = lambda: mlstm_chunkwise_fwd(*args)
            report("mlstm_chunkwise_fwd", (B, NH, S, DH), cuda_time_ms(run),
                   device_ms(run, "mlstm"))
        for B, NH, S, DH in K5_SHAPES:
            wx, r, b = mk(B, S, NH, 4, DH), mk(NH, DH, 4, DH) * DH ** -0.5, mk(NH, 4, DH)
            run = lambda: slstm_scan_fwd(wx, r, b)
            report("slstm_scan_fwd", (B, NH, S, DH), cuda_time_ms(run), device_ms(run, "slstm"))


if __name__ == "__main__":
    main()
