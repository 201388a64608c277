"""Foundation utilities: logging, terminal colours, exception and retry
decorators, thread helpers, environment probes, run-directory increments,
persistent settings, and the device resolution and fp32 promotion shared
by the port's entry points.

Port of ``xlstm_yolo_tpu/utils/__init__.py``: ``LOGGER`` / ``set_logging``
(rank-aware through the torchrun ``RANK`` variable), ``colorstr``,
``emojis``, ``TryExcept``, ``Retry``, ``ThreadingLocked``, ``threaded``,
the ``is_*`` probes, ``increment_path`` and ``SettingsManager`` /
``SETTINGS`` (a JSON file under ``XLSTM_YOLO_CONFIG_DIR``, else
``~/.config/xlstm_yolo_torch``; read when it exists, on the first use of
``SETTINGS`` and not on import; written only by ``save`` / ``reset``).
"""
from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import platform
import sys
import threading
import time
from pathlib import Path

import torch

RANK = int(os.getenv("RANK", -1))
LOCAL_RANK = int(os.getenv("LOCAL_RANK", -1))


def set_logging(name: str = "xlstm_yolo_torch", verbose: bool = True) -> logging.Logger:
    """A logger that prints bare messages to stdout on rank -1 or 0 and only
    errors elsewhere."""
    level = logging.INFO if verbose and RANK in (-1, 0) else logging.ERROR
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("%(message)s"))
        h.setLevel(level)
        logger.addHandler(h)
    logger.propagate = False
    return logger


LOGGER = set_logging()


def emojis(s: str) -> str:
    """``s`` without its non-ASCII characters on Windows, as it is elsewhere."""
    return s.encode().decode("ascii", "ignore") if platform.system() == "Windows" else s


def colorstr(*input):
    """ANSI-coloured text: ``colorstr("blue", "bold", "hello")``; a lone
    string is blue and bold."""
    *args, string = input if len(input) > 1 else ("blue", "bold", input[0])
    colors = {
        "black": "\033[30m", "red": "\033[31m", "green": "\033[32m", "yellow": "\033[33m",
        "blue": "\033[34m", "magenta": "\033[35m", "cyan": "\033[36m", "white": "\033[37m",
        "bright_red": "\033[91m", "bright_green": "\033[92m", "bright_yellow": "\033[93m",
        "bold": "\033[1m", "underline": "\033[4m", "end": "\033[0m",
    }
    return "".join(colors[x] for x in args) + f"{string}" + colors["end"]


class TryExcept(contextlib.ContextDecorator):
    """A context manager or decorator that logs an exception as a warning
    and swallows it."""

    def __init__(self, msg: str = "", verbose: bool = True):
        self.msg = msg
        self.verbose = verbose

    def __enter__(self):
        return self

    def __exit__(self, exc_type, value, traceback):
        if self.verbose and value:
            LOGGER.warning(f"{self.msg}{': ' if self.msg else ''}{value}")
        return True


class Retry:
    """Retry the decorated function ``times`` times, waiting ``delay``
    seconds and doubling it after each failure; the last failure raises."""

    def __init__(self, times: int = 3, delay: float = 2.0):
        self.times = times
        self.delay = delay

    def __call__(self, func):
        @functools.wraps(func)
        def wrapped(*args, **kwargs):
            attempts = 0
            while True:
                try:
                    return func(*args, **kwargs)
                except Exception:
                    attempts += 1
                    if attempts > self.times:
                        raise
                    time.sleep(self.delay * (2 ** (attempts - 1)))

        return wrapped


class ThreadingLocked:
    """Run the decorated function under a lock of its own."""

    def __init__(self):
        self.lock = threading.Lock()

    def __call__(self, f):
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            with self.lock:
                return f(*args, **kwargs)

        return wrapped


def threaded(func):
    """Run the decorated function in a daemon thread and return the thread."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        t = threading.Thread(target=func, args=args, kwargs=kwargs, daemon=True)
        t.start()
        return t

    return wrapper


def is_colab() -> bool:
    return "COLAB_RELEASE_TAG" in os.environ or "COLAB_BACKEND_VERSION" in os.environ


def is_kaggle() -> bool:
    return os.environ.get("PWD") == "/kaggle/working"


def is_docker() -> bool:
    return Path("/.dockerenv").exists()


def is_pytest_running() -> bool:
    return "PYTEST_CURRENT_TEST" in os.environ or "pytest" in sys.modules


TESTS_RUNNING = is_pytest_running()


def increment_path(path: str | Path, exist_ok: bool = False, sep: str = "",
                   mkdir: bool = False) -> Path:
    """``runs/exp`` -> ``runs/exp2``, ``exp3``, ... while the path exists
    (a file keeps its suffix: ``a.txt`` -> ``a2.txt``); ``exist_ok`` keeps
    it as it is; ``mkdir`` creates the directory."""
    path = Path(path)
    if path.exists() and not exist_ok:
        base, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = Path(f"{base}{sep}{n}{suffix}")
            if not p.exists():
                path = p
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


class SettingsManager(dict):
    """User settings, the defaults updated from a JSON file when it exists."""

    DEFAULTS = {
        "settings_version": "0.1.0",
        "datasets_dir": "datasets",
        "weights_dir": "weights",
        "runs_dir": "runs",
        "sync": False,
        "tensorboard": True,
    }

    def __init__(self, file: str | Path | None = None):
        super().__init__(self.DEFAULTS)
        root = Path(os.getenv("XLSTM_YOLO_CONFIG_DIR",
                              Path.home() / ".config" / "xlstm_yolo_torch"))
        self.file = Path(file) if file else root / "settings.json"
        if self.file.exists():
            with contextlib.suppress(Exception):
                self.update(json.loads(self.file.read_text()))

    def save(self):
        self.file.parent.mkdir(parents=True, exist_ok=True)
        self.file.write_text(json.dumps(dict(self), indent=2))

    def reset(self):
        self.clear()
        super().update(self.DEFAULTS)
        self.save()


def __getattr__(name: str):
    """``SETTINGS``, the user's ``SettingsManager``, read on first use (not
    on import) and kept."""
    if name == "SETTINGS":
        globals()["SETTINGS"] = SettingsManager()
        return globals()["SETTINGS"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a torch.device; a CUDA device with no GPU present
    raises instead of quietly running on the CPU. Under torchrun
    (``LOCAL_RANK`` set) a bare ``cuda`` is this rank's card,
    ``cuda:{LOCAL_RANK}``.

    A CUDA device also turns TF32 off for matmul and cuDNN, process-wide:
    the port computes fp32 in fp32, the precision its card checks hold it
    to (PyTorch's default lets cuDNN convolve in TF32, so a fresh process
    would otherwise convolve at about 1e-3 of the fp32 result)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain CPU path")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or as it is when it is wider (fp64 stays fp64): the
    dtype of the computations the port keeps in fp32 under bf16 autocast."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
