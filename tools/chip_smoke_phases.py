#!/usr/bin/env python3
"""Seconds each phase of ``chip_smoke.py`` took, from outputs whose lines
carry the wall time in front (``tools/chip_smoke_ab.sh`` writes them).

    python3 tools/chip_smoke_phases.py OUT_DIR/ab*.out

For each file: the seconds from the first line to each phase's JSON line
(a phase's line is printed when it ends), the seconds since the line before
it, and the whole run, with the script's exit code.
"""

from __future__ import annotations

import json
import sys


def phases(path: str) -> tuple[list[tuple[str, float]], float, str]:
    """([(phase, seconds since the first line)], seconds in all, rc)."""
    rows, first, last, rc = [], None, None, "?"
    with open(path) as f:
        for line in f:
            stamp, _, rest = line.partition(" ")
            try:
                t = float(stamp)
            except ValueError:
                continue
            first = t if first is None else first
            last = t
            rest = rest.strip()
            if rest.startswith("rc="):
                rc = rest[3:]
            if rest.startswith('{"phase"'):
                rows.append((json.loads(rest)["phase"], t - first))
    return rows, (last or 0.0) - (first or 0.0), rc


def main(paths: list[str]) -> int:
    for path in paths:
        rows, total, rc = phases(path)
        print(f"{path}: {total:.1f} s in all, rc={rc}")
        before = 0.0
        for name, at in rows:
            print(f"  {name:<18} at {at:8.1f} s  took {at - before:7.1f} s")
            before = at
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
