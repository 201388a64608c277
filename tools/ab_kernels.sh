#!/usr/bin/env bash
# Times the hand-written kernels of several checkouts of this repository on
# one card, in turns. For each root given, in order, chip_smoke.py's
# kernel_parity phase (build, parity against the plain versions, per-case
# times) runs in that root, in a process of its own, and then this
# checkout's tools/wrapper_times.py (K1 and K5 through their public wrappers
# at shapes the smoke run does not time, K2 at head dims 128 and 256, the
# sLSTM backward, and the bf16 entries of K3 and K2 at ViL-YOLO-n's stages at
# batch 8 and 128 with the device time of each kernel they launch, by name,
# so that the two checkouts compare stage by stage) on that root's package;
# the output of both goes to $AB_OUT/ab_<turn>_<root's last name>.txt (AB_OUT
# defaults to ab/out). To
# compare a parent commit with the working tree, unpack the parent into a
# directory .gitignore lists and run parent, change, change, parent:
#
#     mkdir -p ab/parent
#     git archive <parent> xlstm_yolo_torch chip_smoke.py | tar -x -C ab/parent
#     bash tools/ab_kernels.sh ab/parent . . ab/parent
set -u
out=${AB_OUT:-ab/out}
mkdir -p "$out"
out=$(cd "$out" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
turn=0
for root in "$@"; do
  turn=$((turn + 1))
  name=$(basename "$(cd "$root" && pwd)")
  (cd "$root" && python3 -c "import chip_smoke as c; c.phase_device(); c.phase_build(); c.phase_kernel_parity()" \
    && PYTHONPATH=. python3 "$here/tools/wrapper_times.py") > "$out/ab_${turn}_${name}.txt" 2>&1
  echo "turn $turn: $root rc=$?"
done
