"""Topology planner (PyTorch port): which encode algorithm should this scenario run?

Given K, p, a payload size, and a topology, prints the autotuner's candidate
table — per-algorithm C1 (rounds), C2 (elements per port), α-β predicted
time, worst per-link contention — and its choice (marked ``←``).

Run:  PYTHONPATH=src python examples/topology_planner_torch.py \
          --K 16 --p 1 --payload-bytes 65536 --topology two-level --intra 4

      # recursive multi-level hierarchy (chip < slice < pod):
      PYTHONPATH=src python examples/topology_planner_torch.py \
          --K 32 --topology hierarchy --levels 4,4,2

Topologies: flat | ring | torus | torus3d | two-level | hierarchy.
``torus``/``two-level`` take ``--intra`` (fast-domain size);
``hierarchy`` takes ``--levels`` — comma-separated per-level sizes,
innermost (fastest links) first, multiplying to K (default: a balanced
three-level factorization of K); ``torus3d`` reuses ``--levels`` as its
(cols, rows, depth) dims. Generators: general | vandermonde | dft
(structured kinds unlock the specific algorithms; dft needs K compatible
with the field).

Reading the output: a candidate is an (algorithm, pipeline) pair — rows
like ``butterfly+remap-digits`` are a base compile rewritten by a named
``topo.passes`` pipeline (here the Gray-relabeled butterfly whose partners
are torus neighbors). On a hierarchy the ``multilevel`` row is the recursive
schedule whose phases align with the topology's levels (gather on the
fastest links, one digit-reduction shoot per level); ``contention`` is the
worst number of messages sharing one link in any round — the quantity the
level-aligned schedules are designed to keep off the slow trunks.

``--emit-ir`` additionally prints the chosen algorithm's compiled
ScheduleIR: every communication round (port, transfers, elements per
message, example src→dst pairs with their slot selectors) and every local
contraction — the exact schedule the simulator interprets and
``dist.collectives.ir_encode`` executes.

``--pipeline NAME`` applies one named pass pipeline from the
``topo.passes.PIPELINES`` registry to the cheapest base candidate it
applies to and prints the before/after α-β price plus the rewritten IR —
the single-pipeline view of what the autotuner enumerates.

The planner runs on the host only: it prices schedules and computes nothing
on a device, so it takes no ``--device``.
"""

from __future__ import annotations

import argparse

from repro_torch.core.encode import default_q_for
from repro_torch.core.ir import CommRound, round_port_groups
from repro_torch.topo import PIPELINES, autotune, ir_time, make_topology


def emit_ir(ir, max_pairs: int = 4) -> str:
    """Human-readable dump of a compiled ScheduleIR."""
    lines = [
        f"ScheduleIR[{ir.algorithm}] K={ir.K} p={ir.p} "
        f"C1={ir.c1} C2={ir.c2}"
        + (f" placement={list(ir.placement)}" if ir.placement else "")
    ]
    rnd = 0
    for step in ir.steps:
        if isinstance(step, CommRound):
            rnd += 1
            lines.append(f"  round {rnd}:")
            for g in round_port_groups(step):
                pairs = " ".join(f"{s}->{d}" for s, d in g.pairs[:max_pairs])
                more = "" if len(g.pairs) <= max_pairs else f" …(+{len(g.pairs) - max_pairs})"
                slots = ",".join(f"{ss}->{ds}" for ss, ds in g.slots)
                coeff = " coeffs" if g.coeffs_by_dst else ""
                lines.append(
                    f"    port {g.port} [{g.mode}] {len(g.slots)} elem/msg "
                    f"slots[{slots}]{coeff}: {pairs}{more}"
                )
        else:
            shape = (
                "structure-only"
                if step.coeffs is None
                else "x".join(str(s) for s in step.coeffs.shape)
            )
            lines.append(
                f"  local: {len(step.in_slots)} slots -> {len(step.out_slots)} "
                f"slots (coeffs {shape})"
            )
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--K", type=int, default=16, help="number of processors")
    ap.add_argument("--p", type=int, default=1, help="ports per processor")
    ap.add_argument("--payload-bytes", type=int, default=65536)
    ap.add_argument(
        "--topology",
        default="two-level",
        choices=("flat", "ring", "torus", "torus3d", "two-level", "hierarchy"),
    )
    ap.add_argument(
        "--intra", type=int, default=None, help="fast-domain size (torus/two-level)"
    )
    ap.add_argument(
        "--levels",
        default=None,
        help="hierarchy level sizes, innermost first, comma-separated "
        "(e.g. 4,4,2 = 4 chips < 4 slices < 2 pods; Π levels must equal K)",
    )
    ap.add_argument(
        "--generator", default="general", choices=("general", "vandermonde", "dft")
    )
    ap.add_argument("--q", type=int, default=None, help="field prime (default: auto)")
    ap.add_argument(
        "--emit-ir",
        action="store_true",
        help="print the chosen algorithm's compiled ScheduleIR "
        "(rounds, transfers, slot selectors, local contractions)",
    )
    ap.add_argument(
        "--pipeline",
        default=None,
        choices=sorted(PIPELINES),
        help="apply one named pass pipeline to the cheapest base candidate "
        "it applies to; print before/after α-β price and the rewritten IR",
    )
    args = ap.parse_args(argv)

    q = args.q or default_q_for(args.K, args.p)
    levels = (
        tuple(int(s) for s in args.levels.split(",")) if args.levels else None
    )
    topo = make_topology(args.topology, args.K, k_intra=args.intra, levels=levels)
    result = autotune(
        args.K, args.p, args.payload_bytes, topo, q=q, generator=args.generator
    )

    extra = f" levels={getattr(topo, 'levels', None)}" if args.topology == "hierarchy" else ""
    print(
        f"K={args.K} p={args.p} payload={args.payload_bytes}B "
        f"topology={topo.name}{extra} generator={args.generator} q={q}"
    )
    w = max(28, max(len(c.algorithm) for c in result.candidates) + 2)
    print(f"{'algorithm':<{w}}{'C1':>4}{'C2':>5}{'time':>12}{'contention':>12}")
    for c in result.candidates:
        mark = " ←" if c is result.chosen else ""
        print(
            f"{c.algorithm:<{w}}{c.c1:>4}{c.c2:>5}"
            f"{c.predicted_time * 1e6:>10.2f}µs{c.estimate.max_contention:>12}{mark}"
        )
    ch = result.chosen
    print(
        f"\nchosen: {ch.algorithm} — C1={ch.c1} rounds, C2={ch.c2} elements/port, "
        f"predicted {ch.predicted_time * 1e6:.2f} µs"
    )
    if args.emit_ir:
        print()
        print(emit_ir(ch.ir))
    if args.pipeline:
        show_pipeline(args, result, topo)


def show_pipeline(args, result, topo) -> None:
    """Apply one named pass pipeline to the cheapest base candidate it
    applies to; print the before/after α-β price and the rewritten IR."""
    pl = PIPELINES[args.pipeline]
    base = next(
        (
            c
            for c in result.candidates
            if not c.pipeline and pl.applicable(c.ir, topo)
        ),
        None,
    )
    print()
    if base is None:
        print(f"pipeline {pl.name!r}: not applicable to any candidate here")
        return
    pay = max(1, args.payload_bytes // 4)
    rewritten = pl.apply(base.ir, topo, pay)
    t0, t1 = ir_time(base.ir, topo, pay), ir_time(rewritten, topo, pay)
    note = " (no rewrite: already optimal)" if rewritten is base.ir else ""
    print(
        f"pipeline {pl.name!r} on {base.algorithm}: "
        f"{t0 * 1e6:.2f}µs → {t1 * 1e6:.2f}µs{note}"
    )
    print(emit_ir(rewritten))


if __name__ == "__main__":
    main()
