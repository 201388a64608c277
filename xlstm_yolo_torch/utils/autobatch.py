"""The largest batch that fits a share of the card's memory.

Port of ``device_memory_bytes`` and ``autobatch`` in
``xlstm_yolo_tpu/utils/autobatch.py``. The JAX package reads XLA's peak
estimate of the compiled step at two batches; here the readings are
``torch.cuda.max_memory_allocated`` of one run of the step at each probe
batch, after ``reset_peak_memory_stats`` (the memory already held, the
model and its optimizer state, is part of the fixed term). The same
linear fit, ``bytes(b) = fixed + b * per_image``, is solved for
``fraction`` of the card's memory and rounded down to a power of two; as
in JAX, degenerate readings give 16. Unlike JAX, a probe that fails
raises (a kernel that does not build is never hidden behind a default
batch), and there is no CPU fallback: the readings are the card's. And
the card's readings are not linear in the batch as XLA's estimates are
(cuDNN picks other algorithms and workspaces at other batches: ViL-YOLO-n's
fp32 step at 640 px read 192 MB an image between batches 1 and 4 and 268
at 256, on an NVIDIA H100 80GB HBM3 at 700 W, ``chip_smoke.py``'s
``export_path``), so the chosen batch is run once more and halved while
its peak passes the budget.
"""
from __future__ import annotations

import torch


def device_memory_bytes(device: str | torch.device = "cuda") -> int:
    """The card's memory in bytes; raises on the CPU."""
    from . import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"autobatch reads CUDA memory; {dev} has none")
    return int(torch.cuda.get_device_properties(dev).total_memory)


def peak_bytes(step_fn, batch: int, imgsz: int, ch: int = 3,
               device: str | torch.device = "cuda") -> int:
    """Peak allocated bytes of one ``step_fn(img)`` on zeros (batch, imgsz,
    imgsz, ch) float32 images on the card."""
    dev = torch.device(device)
    x = torch.zeros((batch, imgsz, imgsz, ch), device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step_fn(x)
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev))


def fit_batch(readings, total: int, fraction: float = 0.60, max_batch: int = 1024) -> dict:
    """The linear fit of ``readings`` ((b0, bytes0), (b1, bytes1)) solved
    for ``fraction`` of ``total`` -> {batch, fixed, per_image,
    predicted_bytes}; batch 16 (the JAX default) where the readings do not
    grow with the batch."""
    (b0, y0), (b1, y1) = readings
    if y1 <= y0 or y0 <= 0:
        print("autobatch: degenerate memory readings; using batch=16")
        return {"batch": 16, "fixed": None, "per_image": None, "predicted_bytes": None}
    per_image = (y1 - y0) / (b1 - b0)
    fixed = y0 - b0 * per_image
    best = int((total * fraction - fixed) / per_image)
    b = 1
    while b * 2 <= min(best, max_batch):
        b *= 2
    return {"batch": max(1, b), "fixed": fixed, "per_image": per_image,
            "predicted_bytes": fixed + b * per_image}


def autobatch_fit(step_fn, imgsz: int = 640, fraction: float = 0.60, max_batch: int = 1024,
                  probe: tuple = (1, 4), ch: int = 3,
                  device: str | torch.device = "cuda") -> dict:
    """``fit_batch`` on the step's readings at the ``probe`` batches, with
    them (``readings``) and the card's memory (``total``); then the fit's
    batch (``fit_batch``) runs once more and is halved while its peak
    (``measured_peak_bytes``) passes ``fraction`` of the memory: ``batch``
    is the one that fits."""
    total = device_memory_bytes(device)
    readings = [(b, peak_bytes(step_fn, b, imgsz, ch, device)) for b in probe]
    fit = {**fit_batch(readings, total, fraction, max_batch), "readings": readings,
           "total": total}
    fit["fit_batch"] = b = fit["batch"]
    if fit["predicted_bytes"] is not None:
        print(f"autobatch: fit batch={b} uses ~{fit['predicted_bytes'] / total:.0%} of "
              f"{total / 1024**3:.1f} GiB (fraction target {fraction:.0%})")
    peak = peak_bytes(step_fn, b, imgsz, ch, device)
    while peak > fraction * total and b > 1:
        print(f"autobatch: batch={b} peaked at {peak / total:.0%}; halving")
        b //= 2
        peak = peak_bytes(step_fn, b, imgsz, ch, device)
    fit["batch"], fit["measured_peak_bytes"] = b, peak
    return fit


def autobatch(step_fn, imgsz: int = 640, fraction: float = 0.60, max_batch: int = 1024,
              probe: tuple = (1, 4), ch: int = 3, device: str | torch.device = "cuda") -> int:
    """Largest power-of-two batch whose step uses at most ``fraction`` of
    the card's memory (the reference's 60% default). ``step_fn(img)`` runs
    one step on (B, imgsz, imgsz, ch) float32 images on the card."""
    return autobatch_fit(step_fn, imgsz, fraction, max_batch, probe, ch, device)["batch"]
