"""Device resolution shared by the port's entry points, and the dtype the
loss and the train-mode BatchNorm compute in."""
from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a torch.device; a CUDA device with no GPU present
    raises instead of quietly running on the CPU. Under torchrun
    (``LOCAL_RANK`` set) a bare ``cuda`` is this rank's card,
    ``cuda:{LOCAL_RANK}``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain CPU path")
    return dev


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or as it is when it is wider (fp64 stays fp64): the
    dtype of the computations the port keeps in fp32 under bf16 autocast."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
