"""Config system and model YAML loading for the port, from its own copies
of ``default.yaml`` and the model YAMLs under ``cfg/models``.

Port of ``get_cfg``, ``check_cfg``, ``check_dict_alignment``, ``yaml_load``,
``model_yaml_path`` and ``load_model_yaml`` in
``xlstm_yolo_tpu/cfg/__init__.py``: defaults, then overrides, typed
validation and did-you-mean errors for mistyped keys. The keys of the JAX
package's device mesh are accepted at their defaults and refused otherwise
(``UNSUPPORTED``); the ``dtype`` key picks the train step's arithmetic
(``amp_of``).
"""
from __future__ import annotations

import difflib
import re
from pathlib import Path
from types import SimpleNamespace

import yaml

CFG_DIR = Path(__file__).parent
MODELS_DIR = CFG_DIR / "models"

# typed key groups (the JAX package's, which follow the reference's)
CFG_FLOAT_KEYS = {"warmup_epochs", "box", "cls", "dfl", "degrees", "shear", "time", "pose", "kobj",
                  "workspace", "batch"}
CFG_FRACTION_KEYS = {"dropout", "lr0", "lrf", "momentum", "weight_decay", "warmup_momentum",
                     "warmup_bias_lr", "hsv_h", "hsv_s", "hsv_v", "translate", "scale",
                     "perspective", "flipud", "fliplr", "bgr", "mosaic", "mixup", "copy_paste",
                     "conf", "iou", "fraction", "erasing", "crop_fraction"}
CFG_INT_KEYS = {"epochs", "patience", "workers", "seed", "close_mosaic", "mask_ratio",
                "max_det", "vid_stride", "line_width", "nbs", "save_period", "imgsz",
                "mesh_dp", "mesh_tp", "mesh_sp", "max_labels", "mosaic_n"}
CFG_BOOL_KEYS = {"save", "exist_ok", "verbose", "deterministic", "single_cls", "rect", "cos_lr",
                 "overlap_mask", "val", "save_json", "save_hybrid", "half", "dnn", "plots",
                 "show", "save_txt", "save_conf", "save_crop", "save_frames", "show_labels",
                 "show_conf", "visualize", "augment", "agnostic_nms", "retina_masks",
                 "show_boxes", "keras", "optimize", "int8", "dynamic", "simplify", "nms",
                 "profile", "multi_scale", "stream_buffer", "device_augment"}
# keys of the JAX package that the port refuses away from their defaults: one card
UNSUPPORTED = ("mesh_dp", "mesh_tp", "mesh_sp", "mesh_pp", "mesh_ep", "pp_microbatches")
DTYPES = ("bfloat16", "float32")


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


DEFAULT_CFG_DICT = yaml_load(CFG_DIR / "default.yaml")
for _k, _v in DEFAULT_CFG_DICT.items():
    if isinstance(_v, str) and _v.lower() == "none":
        DEFAULT_CFG_DICT[_k] = None


def check_cfg(cfg: dict, hard: bool = True) -> dict:
    """Typed validation: floats, fractions in [0, 1], ints, bools; then the
    port's refusals (``UNSUPPORTED`` away from its default, an unknown
    ``dtype``)."""
    for k, v in list(cfg.items()):
        if v is None:
            continue
        if k in CFG_FLOAT_KEYS:
            if not isinstance(v, (int, float)):
                _type_err(k, v, "float", hard)
            cfg[k] = float(v)
        elif k in CFG_FRACTION_KEYS:
            if not isinstance(v, (int, float)):
                _type_err(k, v, "float", hard)
            cfg[k] = float(v)
            if not (0.0 <= cfg[k] <= 1.0):
                raise ValueError(f"'{k}={v}' must be in [0, 1]")
        elif k in CFG_INT_KEYS:
            if not isinstance(v, int):
                if isinstance(v, float) and v.is_integer():
                    cfg[k] = int(v)
                else:
                    _type_err(k, v, "int", hard)
        elif k in CFG_BOOL_KEYS:
            if not isinstance(v, bool):
                if isinstance(v, str) and v.lower() in ("true", "false"):
                    cfg[k] = v.lower() == "true"
                else:
                    _type_err(k, v, "bool", hard)
    for k in UNSUPPORTED:
        if k in cfg and cfg[k] != DEFAULT_CFG_DICT[k]:
            raise ValueError(f"'{k}={cfg[k]}' is not supported by the PyTorch port (one "
                             f"card); leave it at {DEFAULT_CFG_DICT[k]!r}")
    if cfg.get("dtype") not in (None, *DTYPES):
        raise ValueError(f"'dtype={cfg['dtype']}' must be one of {DTYPES}")
    return cfg


def _type_err(k, v, t, hard):
    msg = f"'{k}={v}' is of invalid type {type(v).__name__}, expected {t}"
    if hard:
        raise TypeError(msg)


def check_dict_alignment(base: dict, custom: dict) -> None:
    """A did-you-mean error for every key of ``custom`` not in ``base``."""
    unknown = [k for k in custom if k not in base]
    if unknown:
        msgs = []
        for k in unknown:
            matches = difflib.get_close_matches(k, base.keys(), n=3)
            hint = f" - did you mean {matches}?" if matches else ""
            msgs.append(f"'{k}' is not a valid key{hint}")
        raise KeyError("; ".join(msgs))


def get_cfg(cfg: dict | str | Path | SimpleNamespace | None = None,
            overrides: dict | None = None) -> SimpleNamespace:
    """Defaults, then ``cfg``, then ``overrides``, validated, as a namespace."""
    if cfg is None:
        merged = dict(DEFAULT_CFG_DICT)
    elif isinstance(cfg, (str, Path)):
        merged = {**DEFAULT_CFG_DICT, **yaml_load(cfg)}
    elif isinstance(cfg, SimpleNamespace):
        merged = {**DEFAULT_CFG_DICT, **vars(cfg)}
    else:
        check_dict_alignment(DEFAULT_CFG_DICT, cfg)
        merged = {**DEFAULT_CFG_DICT, **cfg}
    if overrides:
        overrides = dict(overrides)
        overrides.pop("__dict__", None)
        check_dict_alignment(merged, overrides)
        merged.update(overrides)
    check_cfg(merged)
    return SimpleNamespace(**merged)


def amp_of(args: SimpleNamespace) -> bool:
    """The train step's arithmetic from the ``dtype`` key: bfloat16 (the
    default) is AMP (``TrainStep(amp=True)``), float32 the fp32 step."""
    return str(getattr(args, "dtype", "bfloat16")) == "bfloat16"
