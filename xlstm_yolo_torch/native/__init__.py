"""The host's native image path: ``imgproc.cpp``, ``jpeg.cpp`` and
``contours.cpp``, each built with g++ on first use and bound with ctypes.

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

``jpeg_decode`` / ``jpeg_encode`` are the JPEG codec of ``jpeg.cpp`` (what
OpenCV's ``imread`` / ``imencode`` give, its header says how);
``find_external_contours`` is the border follower of ``contours.cpp``. A
ctypes call releases the GIL, so loader threads decode in parallel.
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
JPEG_SOURCE = SOURCE.with_name("jpeg.cpp")
CONTOURS_SOURCE = SOURCE.with_name("contours.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC", "-pthread",
             "-std=c++17")
_LOCK = threading.Lock()
_LIBS: dict = {}


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


_U8P = ctypes.POINTER(ctypes.c_uint8)
_INTP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    SOURCE: {
        "letterbox_batch": (None, [ctypes.POINTER(ctypes.c_void_p), _INTP, _INTP, ctypes.c_int,
                                   ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                                   ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]),
        "hsv_inplace": (None, [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                               ctypes.c_float]),
    },
    JPEG_SOURCE: {
        "jpeg_info": (ctypes.c_int, [_U8P, ctypes.c_size_t, _INTP, _INTP, _INTP]),
        "jpeg_decode": (ctypes.c_int, [_U8P, ctypes.c_size_t, _U8P, ctypes.c_int, ctypes.c_int]),
        "jpeg_encode": (ctypes.c_long, [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, _U8P, ctypes.c_size_t]),
    },
    CONTOURS_SOURCE: {
        "find_external_contours": (ctypes.c_long, [_U8P, ctypes.c_int, ctypes.c_int, _INTP,
                                                   ctypes.c_long, _INTP, ctypes.c_long]),
    },
}


def get_lib(source: Path = SOURCE) -> ctypes.CDLL:
    """The loaded library of ``source``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            if not available():
                raise RuntimeError(f"native {source.stem} needs g++, which is not on PATH")
            lib = ctypes.CDLL(str(build_library(source)))
            for name, (restype, argtypes) in _SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _LIBS[source] = lib
        return lib


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


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

MAX_PIXELS = 1 << 30  # OpenCV's default CV_IO_MAX_IMAGE_PIXELS
JPEG_ERRORS = {
    -1: "not a JPEG stream (no SOI marker)",
    -2: "arithmetic-coded JPEG is not supported (only Huffman coding)",
    -3: "12-bit JPEG is not supported (only 8-bit samples)",
    -4: "lossless or hierarchical JPEG is not supported",
    -5: "4-component (CMYK / YCCK) JPEG is not supported",
    -6: "corrupt JPEG data",
    -7: "no JPEG frame header",
    -8: "JPEG with other than 1 or 3 components is not supported",
    -9: "JPEG sampling factors that do not divide the largest are not supported",
}


def _u8(buf) -> tuple:
    arr = np.frombuffer(buf, np.uint8)
    return arr, arr.ctypes.data_as(_U8P)


def jpeg_info(data: bytes) -> tuple[int, int, int]:
    """(h, w, components) of a JPEG stream's frame header; ValueError naming
    the case where the frame is one the decoder refuses."""
    lib = get_lib(JPEG_SOURCE)
    arr, ptr = _u8(data)
    h, w, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.jpeg_info(ptr, arr.size, ctypes.byref(h), ctypes.byref(w), ctypes.byref(nc))
    if rc:
        raise ValueError(JPEG_ERRORS.get(rc, f"JPEG error {rc}"))
    return h.value, w.value, nc.value


def jpeg_decode(data: bytes) -> np.ndarray:
    """A JPEG stream -> RGB uint8 (H, W, 3), gray replicated; what
    ``cv2.imdecode(..., IMREAD_COLOR)[..., ::-1]`` gives before EXIF
    orientation (``data.imgproc.imread`` applies that)."""
    h, w, _ = jpeg_info(data)
    if h * w > MAX_PIXELS:
        raise ValueError(f"JPEG of {h} x {w} pixels is above the {MAX_PIXELS} that OpenCV reads")
    out = np.empty((h, w, 3), np.uint8)
    arr, ptr = _u8(data)
    rc = get_lib(JPEG_SOURCE).jpeg_decode(ptr, arr.size, out.ctypes.data_as(_U8P), h, w)
    if rc:
        raise ValueError(JPEG_ERRORS.get(rc, f"JPEG error {rc}"))
    return out


def jpeg_encode(img: np.ndarray, quality: int = 95) -> bytes:
    """RGB (H, W, 3) or gray (H, W) uint8 -> baseline JFIF bytes, equal to
    ``cv2.imencode(".jpg", img[..., ::-1], [IMWRITE_JPEG_QUALITY, quality])``
    (4:2:0 chroma for RGB)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = np.ascontiguousarray(img[..., 0])
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)) or 0 in img.shape:
        raise ValueError(f"jpeg_encode takes (H, W, 3) RGB or (H, W) gray uint8, got {img.shape}")
    if img.shape[0] > 65535 or img.shape[1] > 65535:
        raise ValueError(f"JPEG sides are at most 65535, got {img.shape[:2]}")
    h, w = img.shape[:2]
    nc = 1 if img.ndim == 2 else 3
    lib = get_lib(JPEG_SOURCE)
    cap = 1024 + h * w * nc * 2
    out = np.empty(cap, np.uint8)
    n = lib.jpeg_encode(img.ctypes.data_as(_U8P), h, w, nc, int(quality),
                        out.ctypes.data_as(_U8P), cap)
    if n < 0:
        out = np.empty(-n, np.uint8)
        n = lib.jpeg_encode(img.ctypes.data_as(_U8P), h, w, nc, int(quality),
                            out.ctypes.data_as(_U8P), -n)
    return out[:n].tobytes()
