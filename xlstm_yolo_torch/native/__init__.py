"""The host's native image path: ``imgproc.cpp`` built with g++ on first
use and bound with ctypes.

Port of ``xlstm_yolo_tpu/native/__init__.py``. ``letterbox_batch`` letterboxes
and normalizes a list of uint8 RGB images into one float32 NHWC batch in a
single pass per output pixel, across threads; ``hsv_inplace`` applies the
HSV gains to one image in place. The source is built with the JAX package's
flags into ``build/native/`` at the root of the checkout, named by the
hash of the source and the flags, and renamed into place, so that
processes building at once never load half a library. ``available()`` is
False only where no ``g++`` is found (the caller then assembles batches in
Python); a build or load that fails while ``g++`` exists raises with the
compiler's output. Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "imgproc.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC", "-pthread",
             "-std=c++17")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def build_library(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` with g++ (cached by the hash of the source and the
    flags) and return the shared library's path; raises with g++'s output
    when the build fails."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    out = build_dir / f"{source.stem}_{tag}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(source), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) for {source.name}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def available() -> bool:
    """Whether the native path can run: a ``g++`` is on PATH."""
    return shutil.which("g++") is not None


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            if not available():
                raise RuntimeError("native imgproc needs g++, which is not on PATH")
            lib = ctypes.CDLL(str(build_library()))
            lib.letterbox_batch.restype = None
            lib.letterbox_batch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int]
            lib.hsv_inplace.restype = None
            lib.hsv_inplace.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                                        ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                        ctypes.c_float]
            _LIB = lib
        return _LIB


def default_threads(n: int) -> int:
    """One thread an image, at most as many as this process may run on
    (``sched_getaffinity``: a container's CPU allowance, not the host's
    core count)."""
    try:
        avail = len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        avail = os.cpu_count() or 1
    return max(1, min(n, avail))


def letterbox_batch(images: list, imgsz: int, n_threads: int | None = None,
                    scaleup: bool = True) -> tuple:
    """HWC uint8 RGB images -> ((n, imgsz, imgsz, 3) float32 in [0, 1], the
    padding 114 / 255; (n, 3) float32 metas = (scale, pad_x, pad_y))."""
    lib = get_lib()
    n = len(images)
    images = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    for im in images:
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"letterbox_batch takes (H, W, 3) uint8 images, got {im.shape}")
    out = np.empty((n, imgsz, imgsz, 3), np.float32)
    metas = np.empty((n, 3), np.float32)
    ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data_as(ctypes.c_void_p) for im in images])
    hs = (ctypes.c_int * n)(*[im.shape[0] for im in images])
    ws = (ctypes.c_int * n)(*[im.shape[1] for im in images])
    lib.letterbox_batch(ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)), hs, ws, n, imgsz,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        metas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        default_threads(n) if n_threads is None else int(n_threads),
                        int(scaleup))
    return out, metas


def hsv_inplace(img: np.ndarray, hgain: float, sgain: float, vgain: float) -> np.ndarray:
    """Scale hue, saturation and value of a C-contiguous (H, W, 3) uint8 RGB
    image in place by the gains; returns it."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or not img.flags.c_contiguous:
        raise ValueError("hsv_inplace takes a C-contiguous (H, W, 3) uint8 image")
    get_lib().hsv_inplace(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), img.shape[0],
                          img.shape[1], hgain, sgain, vgain)
    return img
