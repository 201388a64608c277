"""Checks: version parsing and comparison, image sizes rounded to the
stride, suffix, YAML and file checks, a path-safety guard, and a bf16
self-test.

Port of ``xlstm_yolo_tpu/utils/checks.py``. ``check_file`` searches the
port's own ``cfg`` tree. ``check_bf16`` runs the port's fp32 and bf16
forwards of a model (``yolov8n.yaml`` by default) on ``device``, the card
unless the caller asks for the CPU, and compares them as the JAX one does.
Nothing is installed at run time: a missing optional package turns a
feature off.
"""
from __future__ import annotations

import copy
import re
from pathlib import Path

from . import LOGGER


def parse_version(version: str = "0.0.0") -> tuple:
    """'2.0.1+cpu' -> (2, 0, 1)."""
    try:
        return tuple(int(x) for x in re.findall(r"\d+", version)[:3])
    except Exception:
        return (0, 0, 0)


def check_version(current: str = "0.0.0", required: str = "0.0.0",
                  name: str = "version", hard: bool = False) -> bool:
    """``current`` against a requirement such as '>=8.0,<9.0'; a failure
    warns, or raises ModuleNotFoundError with ``hard``."""
    if not current or not required:
        return True
    c = parse_version(current)
    ok = True
    for clause in required.strip(" ").split(","):
        m = re.match(r"([^0-9]*)([\d.]+)", clause.strip())
        if not m:
            continue
        op, ver = m.group(1).strip() or ">=", parse_version(m.group(2))
        ok &= {"==": c == ver, "!=": c != ver, ">=": c >= ver,
               "<=": c <= ver, ">": c > ver, "<": c < ver}.get(op, True)
    if not ok:
        msg = f"{name} {required} required, but {name}=={current} is installed"
        if hard:
            raise ModuleNotFoundError(msg)
        LOGGER.warning(msg)
    return ok


def check_imgsz(imgsz, stride: int = 32, min_dim: int = 1, max_dim: int = 2, floor: int = 0):
    """An image size rounded up to a multiple of ``stride``: an int gives an
    int, [h, w] a list ([s, s] from [s] with ``min_dim`` 2)."""
    stride = int(stride)
    scalar = isinstance(imgsz, (int, float))
    sizes = [int(imgsz)] if scalar else [int(x) for x in imgsz]
    if len(sizes) > max_dim:
        raise ValueError(f"imgsz={imgsz} has more than {max_dim} dimensions")
    out = [max(int(-(-x // stride) * stride), floor) for x in sizes]
    if out != sizes:
        LOGGER.warning(f"imgsz={sizes} must be multiple of stride {stride}, updating to {out}")
    if scalar:
        return out[0]
    if min_dim == 2 and len(out) == 1:
        out = [out[0], out[0]]
    return out


def check_suffix(file, suffix=(".pt", ".yaml"), msg: str = ""):
    """Raise unless every file has one of ``suffix`` (or none)."""
    if not file or not suffix:
        return
    if isinstance(suffix, str):
        suffix = (suffix,)
    for f in [file] if isinstance(file, (str, Path)) else file:
        s = Path(f).suffix.lower().strip()
        if s and s not in suffix:
            raise ValueError(f"{msg}{f} acceptable suffix is {suffix}, not {s}")


def check_yaml(file, suffix=(".yaml", ".yml")) -> str:
    """A YAML path, suffix-checked and resolved as ``check_file`` does."""
    check_suffix(file, suffix)
    return check_file(file, suffix)


def check_file(file, suffix="") -> str:
    """``file`` where it exists, else the first file of that name under the
    port's ``cfg`` tree; FileNotFoundError for neither."""
    if suffix:
        check_suffix(file, suffix)
    f = str(file).strip()
    if not f or Path(f).exists():
        return f
    root = Path(__file__).resolve().parent.parent / "cfg"
    hits = sorted(root.rglob(Path(f).name))
    if not hits:
        raise FileNotFoundError(f"'{f}' does not exist")
    return str(hits[0])


def check_is_path_safe(basedir, path) -> bool:
    """True when ``path`` resolves inside ``basedir``."""
    base = Path(basedir).resolve()
    target = Path(path).resolve()
    return target.parts[: len(base.parts)] == base.parts


def check_bf16(model=None, imgsz: int = 64, tol: float = 0.05, device="cuda") -> bool:
    """Whether a bf16 forward agrees with the fp32 one: the largest absolute
    difference of the decoded candidates over the fp32 output's largest
    magnitude (at least 1e-3) under ``tol``, on a ramp image. ``model`` is a
    ``TaskModel`` (default ``yolov8n.yaml``); its bf16 twin is a copy with
    its parameters cast (``nn.fuse.cast_params``), the BatchNorm statistics
    kept fp32, as the JAX self-test casts ``params``."""
    import torch

    from ..nn.fuse import cast_params
    from . import resolve_device

    dev = resolve_device(device)
    if model is None:
        from ..nn.tasks import TaskModel

        model = TaskModel("yolov8n.yaml", device=dev)
    model = model.to(dev).eval()
    x = torch.linspace(0, 1, imgsz * imgsz * 3, dtype=torch.float32,
                       device=dev).reshape(1, imgsz, imgsz, 3)
    with torch.inference_mode():
        full = model.predictions(x)
        half = cast_params(copy.deepcopy(model), torch.bfloat16).predictions(
            x.to(torch.bfloat16)).float()
    denom = full.abs().max().clamp_min(1e-3)
    rel = float((full - half).abs().max() / denom)
    ok = rel < tol
    if not ok:
        LOGGER.warning(f"bf16 self-test failed: max rel err {rel:.4f} >= {tol}")
    return ok
