"""Summarizes the turns of ``tools/ab_kernels.sh``: for every kernel case,
the time of each turn and the mean of the parent's and of the change's
turns with their ratio, and the same of the device time where a line has
one (the wrappers' lines of ``tools/wrapper_times.py``, the sLSTM
backward's and K8's ``kernel_parity`` lines); for the bf16 entries of the
ViL layer and the chunkwise backward also each stage's device time, per
turn. Reads the files
the script wrote (``$AB_OUT/ab_<turn>_<name>.txt``); the turns whose
directory name is ``parent`` are the parent's, the others the change's.

    python3 tools/ab_summary.py ab/out

Prints one JSON line per case and one per bf16 stage. Reads only text: it
runs anywhere.
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict
from pathlib import Path


def turns(out_dir: Path):
    """(turn number, is parent, lines) per file, in turn order."""
    for f in sorted(out_dir.glob("ab_*_*.txt"), key=lambda f: int(f.name.split("_")[1])):
        yield int(f.name.split("_")[1]), f.stem.endswith("_parent"), f.read_text().splitlines()


def main() -> None:
    out_dir = Path(sys.argv[1] if len(sys.argv) > 1 else "ab/out")
    ms = defaultdict(lambda: defaultdict(list))      # case -> side -> [ms per turn]
    dev = defaultdict(lambda: defaultdict(list))     # case -> side -> [device ms per turn]
    stages = defaultdict(lambda: defaultdict(list))  # (case, stage) -> side -> [ms per turn]
    for _, parent, lines in turns(out_dir):
        side = "parent" if parent else "change"
        for line in lines:
            if not line.startswith("{"):
                continue
            d = json.loads(line)
            if d.get("phase") == "kernel_parity" and "ms" in d:
                case = f"{d['kernel']} {d['case']} parity"
                ms[case][side].append(d["ms"])
                if "device_ms" in d:
                    dev[case][side].append(d["device_ms"])
            elif "stage_device_ms" in d and "case" in d:
                case = f"{d['kernel']} {d['case']} B{d['shape'][0]}"
                for name, t in d["stage_device_ms"].items():
                    if "elementwise" not in name:
                        stages[(case, name)][side].append(t)
            elif "device_ms" in d and "kernel" in d:
                case = f"{d['kernel']} {'x'.join(map(str, d['shape']))} wrapper"
                ms[case][side].append(d["ms"])
                dev[case][side].append(d["device_ms"])
    mean = lambda v: sum(v) / len(v) if v else None
    for case, sides in ms.items():
        p, c = mean(sides["parent"]), mean(sides["change"])
        row = {"case": case, "parent_ms": sides["parent"], "change_ms": sides["change"],
               "parent_mean": p, "change_mean": c, "speedup": p / c if p and c else None}
        if case in dev:
            dp, dc = mean(dev[case]["parent"]), mean(dev[case]["change"])
            row.update(parent_device_ms=dp, change_device_ms=dc,
                       device_speedup=dp / dc if dp and dc else None)
        print(json.dumps(row))
    for (case, name), sides in stages.items():
        print(json.dumps({"case": case, "stage": name, "parent_ms": mean(sides["parent"]),
                          "change_ms": mean(sides["change"])}))


if __name__ == "__main__":
    main()
