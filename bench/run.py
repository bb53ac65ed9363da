"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one card.

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It runs the cell ``<name>`` of
``BENCHMARK.json`` for ``<s>`` seconds and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics with ``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared with the reference, beside its
limit, which are also the last lines of its standard error.

It exits with another code than 0, and prints no result, where there is no
card, where the program cannot be imported from the checkout's ``src/``, or
where the process holds JAX or the JAX package once the window has closed.
The kernels build into ``build/repro_torch/`` inside the checkout, so only
the first run of a checkout compiles them.
"""

from __future__ import annotations

import time


def _process_start() -> float:
    """``time.perf_counter()``'s reading when this process started (read
    from its start time since boot, 10 ms steps), or now where that cannot be
    read."""
    now = time.perf_counter()
    try:
        import os

        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return now - age if 0 <= age < 60 else now
    except (OSError, ValueError, IndexError, AttributeError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

#: top-level module names that may not be loaded in the process that prints
#: the result: JAX and the JAX package, compared whole (``repro_torch``
#: begins with ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def import_program(root: Path):
    """``repro_torch`` from the checkout's ``src/``, and nowhere else."""
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"the program is not in this checkout: {src / 'repro_torch'} is missing")
    sys.path.insert(0, str(src))
    import repro_torch

    where = Path(repro_torch.__file__).resolve()
    if src.resolve() not in where.parents:
        raise SystemExit(f"repro_torch was imported from {where}, not from {src}")
    return repro_torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    if not (root / "BENCHMARK.json").is_file():
        print("run from the root of a checkout: BENCHMARK.json is missing", file=sys.stderr)
        return 2

    import torch

    from bench import harness

    cell = harness.load_cell(args.workload, root=root)
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 3
    import_program(root)

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START,
                              root=root)
    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)} after the window: the port may not load JAX "
              f"or the JAX package", file=sys.stderr)
        return 4
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
