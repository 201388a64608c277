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
(``slstm_scan_bwd``: the reverse-time kernel, then the dr product and the db
sum) at K5's shapes. Then the kth value (K8, ``rowwise_kth_value``) at
``chip_smoke.py``'s cases, with ``torch.topk``'s time beside it and the
share of its bytes bound. Then the bf16 entries of the ViL layer (K3 bf16,
``vil_layer_fwd`` on bf16 activations, under grad as the AMP step runs it)
and of the chunkwise backward (K2 bf16, on what that forward saves) at
ViL-YOLO-n's P3 / P4 / P5 at batch 8 and at batch 128, each with the device
time of every kernel it launches (``stage_device_ms``, by kernel name), so
that a parent and a change compare stage by stage whatever their stages
are called. Prints the card's name and power limit, then one JSON line per
shape: ``ms``, the wrapper call's time by CUDA events over 20 calls after 2
(host work included where it outlasts the kernel), ``device_ms``, the time
of the kernel's own launches per call from torch.profiler (the largest of
three sessions: a session now and then loses events), and microseconds
per step of each. ``--only bf16`` times the bf16 entries alone. Imports
nothing of JAX.
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
# the bf16 entries at ViL-YOLO-n's stages: (name, S, DIM, NH), at each batch
BF16_STAGES = [("P3", 6400, 64, 2), ("P4", 1600, 128, 4), ("P5", 400, 256, 8)]
BF16_BATCHES = (8, 128)


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
    any of the names in a tuple): the largest of three profiler sessions,
    since a session now and then loses events and reads low."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = (name,) if isinstance(name, str) else name
    best = 0.0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
                 for e in prof.key_averages() if any(n in e.key for n in names))
        best = max(best, us / iters / 1e3)
    return best


def stage_device_ms(fn, iters: int = 10) -> dict:
    """Device time per call of every kernel ``fn`` launches, by its name
    (parameter list dropped)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
        if not us:
            continue
        name = e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
        out[name] = out.get(name, 0.0) + us / iters / 1e3
    return out


def main() -> None:
    import sys

    from xlstm_yolo_torch.kernels.mlstm_fwd import mlstm_chunkwise_fwd
    from xlstm_yolo_torch.kernels.slstm import slstm_scan_fwd

    only_bf16 = sys.argv[1:] == ["--only", "bf16"]
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
    if only_bf16:
        bf16_kernels(report)
        return
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
        kth_kernel()
    bf16_kernels(report)


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


def kth_kernel() -> None:
    """K8 at chip_smoke.py's cases (its rows, seeds and k): the wrapper's
    event ms, the kernel's device ms, torch.topk's (another function where
    values tie; a yardstick) and the device time's share of the bytes
    bound (x read once, the result written once, at 3.35 TB/s)."""
    from chip_smoke import K8_CASES, kth_rows

    from xlstm_yolo_torch.kernels.topk import rowwise_kth_value

    for name, R, N, k, ties in K8_CASES:
        x = kth_rows(R, N, ties, seed=R + N, device=torch.device("cuda"))
        run = lambda: rowwise_kth_value(x, k)
        lib = lambda: torch.topk(x, k).values[:, -1:]
        dev = device_ms(run, "kth_value")
        bound_ms = 4 * (R * N + R) / 3.35e12 * 1e3
        print(json.dumps({"kernel": "rowwise_kth_value", "case": name, "shape": [R, N, k],
                          "ms": cuda_time_ms(run), "device_ms": dev,
                          "library_ms": cuda_time_ms(lib), "library_device_ms": device_ms(lib, ""),
                          "bound_ms": bound_ms, "bound_share": bound_ms / dev if dev else None}),
              flush=True)


def bf16_kernels(report) -> None:
    """K3 bf16 under grad (saving the backward's activations) and K2 bf16
    on what it saved, with a seeded output gradient, at each stage and
    batch; the arguments are chip_smoke.py's seeded layer arguments."""
    from chip_smoke import layer_args

    from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
    from xlstm_yolo_torch.kernels.vil_cell import Cfg
    from xlstm_yolo_torch.kernels.vil_layer import _launch

    dev = torch.device("cuda")
    for B in BF16_BATCHES:
        for name, S, DIM, NH in BF16_STAGES:
            INNER = 2 * DIM
            a = layer_args(B, S, DIM, INNER, NH, seed=S + B + 20, device=dev)
            args = [a[0].bfloat16(), a[1].bfloat16(), *a[2:]]
            fwd = lambda: _launch(args, Cfg(NH), True)
            _, (_, q, k, v, ig, fg), carry = fwd()
            dh = torch.from_numpy(np.random.default_rng(S + B + 21).normal(
                size=(B, S, INNER)).astype(np.float32)).to(dev)
            bwd = lambda: mlstm_chunkwise_bwd(q, k, v, ig, fg, dh, NH, carry=carry)
            for kernel, fn in (("vil_layer_fwd_bf16", fwd), ("mlstm_chunkwise_bwd_bf16", bwd)):
                stages = stage_device_ms(fn)
                report(kernel, (B, NH, S, 64), cuda_time_ms(fn), sum(stages.values()))
                print(json.dumps({"kernel": kernel, "case": name, "shape": [B, S, DIM, INNER, NH],
                                  "stage_device_ms": stages}), flush=True)
            del args, a, q, k, v, ig, fg, carry, dh
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
