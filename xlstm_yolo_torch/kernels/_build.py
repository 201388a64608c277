"""Lazy nvcc build and ctypes binding for the port's hand-written kernels.

Each ``csrc/*.cu`` source exposes a plain C interface. On first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout (named by the content hash of the source and the ``csrc/*.cuh``
headers, so an edited source or header rebuilds) and loaded with
``ctypes``. Nothing happens at import time: the package imports on hosts
with no CUDA toolkit, where only the kernels' plain versions run. Building
and loading hold one process-wide lock: the threads of a server may be the
first callers, and two threads of one process would write the same
temporary file. Processes (the ranks of a torchrun world on one host) each
write files of their own and rename them into place, so that none reads or
writes half a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
_LOCK = threading.RLock()  # build_library and CudaLibrary.load, process-wide


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit on PATH")
    return found


def build_library(source: str, extra_flags: tuple = ()) -> Path:
    """Compile ``csrc/<source>`` into a shared library (cached by the
    content hash of the source and of the headers beside it) and return its
    path. nvcc's output (ptxas register and shared memory counts included)
    is kept beside it as ``.log``; a failed build raises with that output."""
    with _LOCK:
        return _build(source, extra_flags)


def _build(source: str, extra_flags: tuple) -> Path:
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS + extra_flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src.name}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    log = out.with_suffix(f".{os.getpid()}.log")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(log, out.with_suffix(".log"))
    os.replace(tmp, out)
    return out


def check_tensor(where: str, name: str, t, shape, device, dtype=None):
    """A kernel argument as the C interface needs it: of ``dtype`` (float32
    unless the entry takes another, as the bf16 entries take their
    activations in bfloat16), on ``device``, of ``shape``; returned
    contiguous. Raises otherwise: a kernel never converts its arguments."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if t.dtype != dtype:
        raise TypeError(f"{where}: {name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{where}: {name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{where}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t.contiguous()


class CudaLibrary:
    """A ``csrc`` source built and loaded on first use. ``declare`` maps each
    exported C function to its (restype, argtypes)."""

    def __init__(self, source: str, declare: dict):
        self.source = source
        self.declare = declare
        self._lib = None

    def load(self) -> ctypes.CDLL:
        with _LOCK:
            if self._lib is None:
                lib = ctypes.CDLL(str(build_library(self.source)))
                for name, (restype, argtypes) in self.declare.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = list(argtypes)
                self._lib = lib
            return self._lib
