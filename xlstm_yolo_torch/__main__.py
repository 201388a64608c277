"""The command line: ``python -m xlstm_yolo_torch TASK MODE k=v ...``

Port of ``xlstm_yolo_tpu/__main__.py``: the same grammar (``parse_kv``,
``_coerce``, ``HELP``) and the same dispatch over train, val, predict,
track, export and benchmark on ``engine.model.Model``. The ``device`` key
(``cfg/default.yaml``) goes to ``Model(device=...)``: the card by default,
``device=cpu`` for the CPU, an index ``n`` for ``cuda:n``.
"""
from __future__ import annotations

import sys

from .cfg import DEFAULT_CFG_DICT, MODES, TASKS, check_dict_alignment


def parse_kv(args: list[str]) -> dict:
    """k=v pairs -> a dict of coerced values; ``k= v``, ``k =v`` and
    ``k = v`` are joined first. An argument without '=' exits."""
    merged: list[str] = []
    for a in args:
        if a.endswith("="):
            merged.append(a)
        elif a.startswith("=") and merged:
            merged[-1] += a
        elif "=" not in a and merged and merged[-1].endswith("="):
            merged[-1] += a
        else:
            merged.append(a)
    out = {}
    for a in merged:
        if "=" not in a:
            raise SystemExit(f"argument {a!r} is not k=v")
        k, v = a.split("=", 1)
        out[k] = _coerce(v)
    return out


def _coerce(v: str):
    """'true' / 'false' -> bool, 'none' / 'null' / '' -> None, then int,
    then float, else the string."""
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null", ""):
        return None
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


HELP = f"""usage: python -m xlstm_yolo_torch TASK MODE [k=v ...]

    TASK in {TASKS}
    MODE in {MODES}
    device=cpu runs on the CPU; the default is the GPU (cuda)

examples:
    python -m xlstm_yolo_torch detect train data=coco8.yaml model=yolov8n.yaml epochs=10
    python -m xlstm_yolo_torch detect predict model=runs/detect/train/best.pt source=img.jpg save=True
    python -m xlstm_yolo_torch detect val model=best.pt data=coco8.yaml
    python -m xlstm_yolo_torch detect export model=best.pt format=pt2
"""


def _device(value) -> str:
    if value is None or value == "":
        return "cuda"
    if isinstance(value, int):
        return f"cuda:{value}"
    return str(value)


def entrypoint(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(HELP)
        return 0
    task = argv[0] if argv[0] in TASKS else "detect"
    rest = argv[1:] if argv[0] in TASKS else argv
    mode = rest[0] if rest and rest[0] in MODES else "predict"
    kv = parse_kv(rest[1:] if rest and rest[0] in MODES else rest)
    check_dict_alignment({**DEFAULT_CFG_DICT, "model": None}, kv)

    from . import Model

    device = _device(kv.pop("device", None))
    model_src = kv.pop("model", None) or ("yolov8n.yaml" if task == "detect"
                                          else f"yolov8n-{task[:3]}.yaml")
    m = Model(model_src, task=task, device=device)
    if mode == "train":
        m.train(**kv)
    elif mode == "val":
        print(m.val(**kv))
    elif mode == "predict":
        for r in m.predict(kv.pop("source", None), **kv):
            print(r.verbose())
    elif mode == "track":
        for r in m.track(kv.pop("source", None), **kv):
            print(len(r), "tracks")
    elif mode == "export":
        print(m.export(**kv))
    elif mode == "benchmark":
        m.benchmark(**kv)
    return 0


if __name__ == "__main__":
    raise SystemExit(entrypoint())
