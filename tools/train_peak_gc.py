"""Peak device bytes of ``chip_smoke.py``'s full-width train run (phase
``train`` (a): Qwen3-1.7B, 6 steps) under three settings of Python's cyclic
garbage collector, each in a fresh process, in the tree of the current
directory (its ``chip_smoke.py`` and ``src/``). Needs one CUDA device:

    cd <tree> && python3 <checkout>/tools/train_peak_gc.py     # ~3 min on an H100

A train step that leaves tensors in reference cycles frees them only when the
collector runs, so its peak moves with the collector's generation-0
threshold, and in a longer process with every allocation made before the
run; a step that leaves none has one peak at every setting. Prints one JSON
line a setting: the thresholds, the run's peak and held bytes (as
``train_full_width`` records them), and the collections that ran during the
launcher's steps, by generation.
"""

import json
import subprocess
import sys

# generation-0 threshold small (cycles freed within a step), Python's default
# (700, 10, 10), and large (cycles outlive several steps)
SETTINGS = ((50, 1000, 1000), (700, 10, 10), (10000, 10, 10))

CHILD = r"""
import gc, json, sys, torch
import chip_smoke as cs

dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
threshold = tuple(json.loads(sys.argv[1]))
runs = [0, 0, 0]
gc.callbacks.append(lambda phase, info: phase == "start" and runs.__setitem__(info["generation"],
                                                                             runs[info["generation"]] + 1))
during = {}
launcher = cs.train_main


def counted(argv):
    before = list(runs)
    out = launcher(argv)
    during["collections"] = [b - a for a, b in zip(before, runs)]
    return out


cs.train_main = counted
gc.collect()
gc.set_threshold(*threshold)
rec = cs.train_full_width(dev)
print(json.dumps({"threshold": threshold, "peak_bytes": rec["peak_bytes"], "held_bytes": rec["held_bytes"],
                  "collections_during_steps": during["collections"], "step_ms": rec["step_ms"]}), flush=True)
"""


def main() -> int:
    rc = 0
    for setting in SETTINGS:
        p = subprocess.run([sys.executable, "-c", CHILD, json.dumps(setting)], capture_output=True, text=True,
                           timeout=600)
        lines = [line for line in p.stdout.splitlines() if line.startswith('{"threshold"')]
        if p.returncode != 0 or not lines:
            rc = 1
            tail = (p.stderr.strip().splitlines() or [""])[-1]
            print(json.dumps({"threshold": setting, "rc": p.returncode, "error": tail[-300:]}), flush=True)
        else:
            print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
