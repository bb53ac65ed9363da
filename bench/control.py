"""The control of the benchmark's comparison, and the faults it must catch.

    python3 -m bench.control --workload <name> --seeds 1,2,3 --seconds 3 \\
        --as float32 [--as float64 --as unchanged ...]

runs whole runs of the cell (set-up, a short window at the cell's own load,
the comparison), one for each seed and each ``--as``, in one process, and
prints one JSON line each: the seed, what stood in the program's place, and
the numbers compared. ``--as``:

* ``program``: the program itself, as ``bench.run`` drives it;
* ``exact``, ``float64``, ``float32``: the plain reference put in the
  program's place, its products and sums in exact integers or in that float
  type; the control is the precision below exact in which the sums are no
  longer exact for the configuration (a float64 product of a 16-bit limb and
  a 31-bit coefficient is exact; one of two 31-bit residues is not);
* a fault planted in the program's entry: ``unchanged`` (the call returns
  its input), ``half_left_out`` (only the first half of the columns
  encoded, the rest zero), ``no_exchange`` (each output row from its own
  input row alone, as if no row crossed between processors), ``altered``
  (one coded element of each call changed where it is produced).

Each of these but ``program`` and ``exact`` must come out not correct.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness, plugins
from .reference import encode as ref_encode
from .reference import generators

PRECISIONS = ("exact", "float64", "float32")
FAULTS = ("unchanged", "half_left_out", "no_exchange", "altered")


def reference_entry(precision: str):
    """The plain reference in the program's place, in ``precision``."""

    def entry(config, device):
        payload = plugins.load_module(plugins.BENCH, "payloads", config["payload"]["kind"])
        A = generators.matrix(config["code"])
        q = config["code"]["q"]

        def to_program(raw, config, dev):
            return payload.to_reference(raw, config).clone()

        return to_program, lambda x: ref_encode.encode(x, A, q, precision=precision)

    return entry


def fault_entry(fault: str, traffic: dict, seed: int):
    """The program's entry with ``fault`` planted in what it returns."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")

    def entry(config, device):
        payload = plugins.load_module(plugins.BENCH, "payloads", config["payload"]["kind"])
        program = plugins.load_module(plugins.BENCH, "entries", traffic["entry"]).build(
            config, traffic.get("entry_options", {}), device)
        q = config["code"]["q"]
        g = torch.Generator()
        g.manual_seed(harness.sub_seed(seed, "fault"))

        def call(x):
            if fault == "unchanged":
                return x
            if fault == "half_left_out":
                half = x.shape[1] // 2
                y = torch.zeros_like(x)
                y[:, :half] = program(x[:, :half].contiguous()).reshape(x.shape[0], -1)
                return y
            if fault == "no_exchange":
                y = torch.empty_like(x)
                for k in range(x.shape[0]):
                    alone = torch.zeros_like(x)
                    alone[k] = x[k]
                    y[k] = program(alone).reshape(x.shape[0], -1)[k]
                    del alone
                return y
            y = program(x).reshape(x.shape[0], -1)
            r = int(torch.randint(0, y.shape[0], (), generator=g))
            c = int(torch.randint(0, y.shape[1], (), generator=g))
            y[r, c] = (int(y[r, c]) + 1) % q
            return y

        return payload.to_program, call

    return entry


def stand_in(what: str, traffic: dict, seed: int):
    if what == "program":
        return None
    if what in PRECISIONS:
        return reference_entry(what)
    return fault_entry(what, traffic, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--as", dest="stand_ins", action="append", required=True,
                    choices=("program",) + PRECISIONS + FAULTS)
    args = ap.parse_args(argv)
    from .run import import_program

    import_program(harness.ROOT)
    traffic = harness.load_cell(args.workload).traffic
    for seed in (int(s) for s in args.seeds.split(",")):
        for what in args.stand_ins:
            t0 = time.perf_counter()
            r = harness.run_cell(args.workload, seed, args.seconds, False, t_start=t0,
                                 entry=stand_in(what, traffic, seed))
            print(json.dumps({"workload": args.workload, "seed": seed, "as": what, "correct": r["correct"],
                              "attempted": r["attempted"], "checks": r["checks"],
                              "seconds": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
