#!/bin/sh
# Parent against change: chip_smoke.py of two trees on one card, in one run,
# in turns (parent, change, change, parent), every output line stamped with
# the wall time. The trees are unpacked beforehand, into directories that
# .gitignore lists, and the script runs from the checkout's root on a
# machine with one GPU:
#
#   mkdir -p build/ab/parent build/ab/change
#   git archive <parent commit> | tar -x -C build/ab/parent
#   git archive $(git write-tree) | tar -x -C build/ab/change
#   sh tools/chip_smoke_ab.sh OUT_DIR          # about 33 minutes
#   python3 tools/chip_smoke_phases.py OUT_DIR/ab*.out
#
# Each tree builds its own kernels under its own build/. Outputs go to
# OUT_DIR/ab<i>-<tree>.out.
out=${1:?usage: sh tools/chip_smoke_ab.sh OUT_DIR}
mkdir -p "$out"
out=$(cd "$out" && pwd)
stamp() {
    python3 -c '
import sys, time
for line in sys.stdin:
    print(f"{time.time():.3f} {line}", end="", flush=True)
'
}
i=0
for tree in parent change change parent; do
    i=$((i + 1))
    (cd build/ab/$tree && python3 chip_smoke.py 2>&1; echo "rc=$?") | stamp > "$out/ab$i-$tree.out"
done
for f in "$out"/ab*.out; do echo "== $f"; tail -n 2 "$f" | cut -c1-200; grep '"phase": "done"' "$f" | cut -c1-120; done
