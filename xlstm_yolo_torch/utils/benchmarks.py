"""Export parity and latency: ``benchmark``, ``profile_model``,
``profile_layers``, ``Profile`` and ``loader_throughput``.

Port of ``xlstm_yolo_tpu/utils/benchmarks.py``. ``benchmark`` exports the
model to each format, reloads it through ``nn.autobackend.AutoBackend``,
and gives one row per format: {format, ok, max_abs_diff, ms_per_image},
with ``mAP50-95`` when ``data`` is given, or an ``error`` where the format
failed (a gated format's missing package included: every format is tried,
none is silently left out). Times are wall clock around calls that end in
a copy to the host, or around a CUDA synchronize.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..engine.exporter import FORMATS


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def benchmark(model, data: str | dict | None = None, imgsz: int = 640, formats: tuple = FORMATS,
              output_dir: str = "runs/benchmark", verbose: bool = True,
              floor: float | None = None, device: str | torch.device = "cuda") -> list:
    """Export -> reload -> parity and ms per image, one row per format (see
    the module docstring), on ``device`` (the card unless the caller asks
    for the CPU); ``data`` validates the model (``mAP50-95``, held to
    ``floor`` when given)."""
    from ..engine.exporter import Exporter
    from ..nn.autobackend import AutoBackend
    from . import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    x = np.asarray(rng.random((1, imgsz, imgsz, 3)), np.float32)
    with torch.inference_mode():
        want = model.eval().to(device).predictions(torch.from_numpy(x).to(device))
        want = want.float().cpu().numpy()

    rows = []
    for fmt in formats:
        row = {"format": fmt, "ok": False, "max_abs_diff": float("nan"),
               "ms_per_image": float("nan")}
        try:
            path = Exporter(model, format=fmt, imgsz=imgsz, batch=1, output_dir=output_dir,
                            device=device)()
            backend = AutoBackend(path, imgsz=imgsz, device=device).warmup()
            got = backend.forward(x)
            row["max_abs_diff"] = float(np.abs(got - want).max())
            n = 5
            t0 = time.perf_counter()
            for _ in range(n):
                backend.forward(x)
            row["ms_per_image"] = (time.perf_counter() - t0) / n * 1e3
            row["ok"] = row["max_abs_diff"] < 0.05

            if data is not None:
                from ..engine.validator import Validator

                m = Validator(model, imgsz=imgsz, batch=1)(data=data)
                row["mAP50-95"] = m["mAP50-95"]
                if floor is not None:
                    row["ok"] = row["ok"] and m["mAP50-95"] >= floor
        except Exception as e:  # noqa: BLE001 — a failed format is a result row
            row["error"] = f"{type(e).__name__}: {e}"[:200]
        rows.append(row)
        if verbose:
            print(row)
    return rows


def profile_model(model, imgsz: int = 640, batch: int = 1, n: int = 10, warmup: int = 2) -> dict:
    """Sigma-clipped latency of ``model.predictions`` on zeros, on the
    model's device (each call ended by a CUDA synchronize there): ms_mean,
    ms_std, img_s."""
    dev = _device(model)
    model = model.eval()
    x = torch.zeros((batch, imgsz, imgsz, 3), device=dev)
    times = []
    with torch.inference_mode():
        for i in range(warmup + n):
            t0 = time.perf_counter()
            model.predictions(x)
            _sync(dev)
            if i >= warmup:
                times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    mu, sigma = times.mean(), times.std()
    clipped = times[np.abs(times - mu) <= 2 * sigma] if sigma > 0 else times
    return {"ms_mean": float(clipped.mean() * 1e3), "ms_std": float(clipped.std() * 1e3),
            "img_s": float(batch / clipped.mean())}


def forward_flops(model, x, upto: int | None = None) -> float:
    """FLOPs of one eval forward of ``model`` on NCHW ``x`` (to layer
    ``upto``), by ``torch.utils.flop_counter.FlopCounterMode`` (the ViL
    layers through their ops' formulas)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(x, upto=upto)
    return float(fc.get_total_flops())


def profile_layers(model, imgsz: int = 256, batch: int = 1, n: int = 5) -> list:
    """Per-layer ms and GFLOPs: the graph replayed up to each layer
    (``upto``), timed (the least of ``n`` runs, each ended by a CUDA
    synchronize) and counted (``forward_flops``); a row is the difference
    from the one before. Returns [{i, name, ms, gflops}, ...]."""
    dev = _device(model)
    model = model.eval()
    x = torch.zeros((batch, model.ch, imgsz, imgsz), device=dev)
    rows = []
    prev_t, prev_f = 0.0, 0.0
    with torch.inference_mode():
        for spec in model.parsed.specs:
            flops = forward_flops(model, x, spec.i)
            model(x, upto=spec.i)
            _sync(dev)
            ts = []
            for _ in range(n):
                t0 = time.perf_counter()
                model(x, upto=spec.i)
                _sync(dev)
                ts.append(time.perf_counter() - t0)
            t = min(ts) * 1e3
            rows.append({"i": spec.i, "name": spec.name, "ms": max(t - prev_t, 0.0),
                         "gflops": max(flops - prev_f, 0.0) / 1e9})
            prev_t, prev_f = t, flops
    return rows


class Profile:
    """Context timer that accumulates seconds (``t``; ``dt`` the last
    span), with a CUDA synchronize at both ends once the process uses the
    card.

    >>> with Profile() as p: out = model(x)
    >>> p.dt  # seconds
    """

    def __init__(self, t: float = 0.0):
        self.t = t
        self.dt = 0.0

    @staticmethod
    def _sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.dt = time.perf_counter() - self._start
        self.t += self.dt
        return False

    def __str__(self):
        return f"Elapsed time is {self.t} s"


def loader_throughput(loader, epochs: int = 1, max_batches: int | None = None) -> dict:
    """The host input pipeline alone: img/s of iterating ``loader``
    (decode, augment, collate; no device work), per epoch."""
    rates = []
    for _ in range(epochs):
        n, t0 = 0, time.perf_counter()
        for bi, batch in enumerate(loader):
            n += len(batch["img"])
            if max_batches is not None and bi + 1 >= max_batches:
                break
        dt = max(time.perf_counter() - t0, 1e-9)
        rates.append(round(n / dt, 1))
    return {"img_s_per_epoch": rates, "best": max(rates)}
