"""Model YAML loading for the port, from its own copies under ``cfg/models``.

Port of ``yaml_load``, ``model_yaml_path`` and ``load_model_yaml`` in
``xlstm_yolo_tpu/cfg/__init__.py``.
"""
from __future__ import annotations

import re
from pathlib import Path

import yaml

MODELS_DIR = Path(__file__).parent / "models"


def yaml_load(path: str | Path) -> dict:
    with open(path, errors="ignore", encoding="utf-8") as f:
        data = yaml.safe_load(f.read()) or {}
    if not isinstance(data, dict):
        raise TypeError(f"YAML file {path} should define a dict, got {type(data)}")
    return data


def model_yaml_path(name: str | Path) -> Path:
    """A model YAML by path, else by name among the bundled models."""
    p = Path(name)
    if p.exists():
        return p
    cand = MODELS_DIR / p.name
    if cand.exists():
        return cand
    raise FileNotFoundError(f"model yaml {name!r} not found (searched {MODELS_DIR})")


def load_model_yaml(name: str | Path) -> tuple[dict, str | None]:
    """Load a model YAML; a name like ``vil_yolon.yaml`` resolves to the
    bundled ``vil_yolo.yaml`` at scale ``n``. Returns (dict, scale)."""
    p = Path(name)
    scale = None
    m = re.match(r"^(.*?)([nsmlxtcbe])(-[a-z0-9]+)?$", p.stem)
    if not p.exists() and (MODELS_DIR / p.with_suffix(".yaml").name).exists():
        m = None  # an exact bundled file wins over scale-letter stripping
    if not p.exists() and m is not None:
        base = f"{m.group(1)}{m.group(3) or ''}.yaml"
        if (MODELS_DIR / base).exists():
            p = MODELS_DIR / base
            scale = m.group(2)
    if scale is None:
        p = model_yaml_path(name)
    d = yaml_load(p)
    d["yaml_file"] = str(p)
    return d, scale
