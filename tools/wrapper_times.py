"""Times the public wrappers of the chunkwise mLSTM forward (K1,
``mlstm_chunkwise_fwd``) and the sLSTM scan (K5, ``slstm_scan_fwd``) on one
NVIDIA GPU, in whichever checkout of this repository is first on the path:

    PYTHONPATH=<checkout> python3 tools/wrapper_times.py

so that ``tools/ab_kernels.sh`` can run the same shapes in a parent commit
and a change, in turns, on one card. Shapes: K1 at the language model's
head dims and sequence lengths (and the ragged lengths ``generate`` gives
it); K5 at head dims 32, 64 and 128 at batch 8, and at head dim 128 at
batch 64. Where the checkout has them, also the backward kernels the
language model's train step runs: the chunkwise backward (K2,
``mlstm_chunkwise_bwd_heads`` on K1's workspace) at head dims 256 and 128,
with each of its three stages' device time, and the sLSTM backward
(``slstm_scan_bwd``: the reverse-time kernel, then the dr einsum and the db
sum) at K5's shapes. Prints the card's name and power limit, then one JSON
line per shape: ``ms``, the wrapper call's time by CUDA events over 20 calls
after 2 (host work included where it outlasts the kernel), ``device_ms``,
the time of the kernel's own launches per call from torch.profiler, and
microseconds per step of each. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

K1_SHAPES = [(8, 4, 256, 64), (8, 4, 200, 64), (8, 4, 1024, 256), (8, 4, 1024, 128)]
K5_SHAPES = [(8, 4, 256, 32), (8, 4, 1024, 64), (8, 4, 1024, 128), (64, 4, 256, 128)]
K2_SHAPES = [(8, 4, 1024, 256), (8, 4, 1024, 128)]
K2_STAGES = ("bwd_wide_local", "bwd_state_scan", "bwd_wide_carry")


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


def device_ms(fn, name, iters: int = 10) -> float:
    """Device time per call of the kernels whose name holds ``name`` (or
    any of the names in a tuple)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
             for e in prof.key_averages()
             if any(n in e.key for n in ((name,) if isinstance(name, str) else name)))
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
        backward_kernels(mk, report)


def backward_kernels(mk, report) -> None:
    """K2 at the wide head dims and the sLSTM backward, where the checkout
    has them (a parent commit of ``tools/ab_kernels.sh`` may not)."""
    try:
        from xlstm_yolo_torch.kernels.mlstm_fwd import (_carry_states,
                                                        mlstm_chunkwise_bwd_heads)
        from xlstm_yolo_torch.kernels.mlstm_fwd import _launch as mlstm_fwd_launch
        from xlstm_yolo_torch.kernels.slstm import _launch as slstm_launch
        from xlstm_yolo_torch.kernels.slstm import slstm_scan_bwd
    except ImportError:
        return
    for B, NH, S, DH in K2_SHAPES:
        q = mk(B, NH, S, DH)
        args = (q, q + 0.3 * mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S) - 3.0,
                mk(B, NH, S) + 3.0)
        _, ws, off = mlstm_fwd_launch(*args, "exp", 1e-6, states=True)
        carry, dh = _carry_states(ws, off, B * NH, S, DH), mk(B, NH, S, DH)
        run = lambda: mlstm_chunkwise_bwd_heads(*args, dh, carry=carry)
        report("mlstm_chunkwise_bwd", (B, NH, S, DH), cuda_time_ms(run),
               device_ms(run, K2_STAGES))
        print(json.dumps({"kernel": "mlstm_chunkwise_bwd", "shape": [B, NH, S, DH],
                          "stage_device_ms": {n: device_ms(run, n) for n in K2_STAGES}}),
              flush=True)
    for B, NH, S, DH in K5_SHAPES:
        wx, r, b = mk(B, S, NH, 4, DH), mk(NH, DH, 4, DH) * DH ** -0.5, mk(NH, 4, DH)
        y, _, saved = slstm_launch(wx, r, b, None, return_last_state=False, save=True)
        dy = mk(B, S, NH, DH)
        run = lambda: slstm_scan_bwd(r, y, saved, dy)
        report("slstm_scan_bwd", (B, NH, S, DH), cuda_time_ms(run), device_ms(run, "slstm_bwd"))


if __name__ == "__main__":
    main()
