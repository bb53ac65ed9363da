"""Render the hill-climb table from ``results/perf_iterations_torch.jsonl``
(:func:`render`), the topology validation table from a topology benchmark
record (predicted α-β time vs. measured wall time per algorithm, the
autotuner's calibration input; :func:`render_topology`), and the per-round
predicted-vs-measured drift table from a trace file (:func:`render_drift`,
the observability layer's report). The text is the reference's, so the
same record renders to the same string in both packages."""

from __future__ import annotations

import json
import sys


def render(log_path: str = "results/perf_iterations_torch.jsonl") -> str:
    with open(log_path) as fh:
        rows = [json.loads(l) for l in fh]
    out = []
    out.append(
        "| iter | cell | levers | compute_s | mem_s (flash) | coll_s | coll GB/dev | "
        "temp GB/dev | bound | roofline-frac |"
    )
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        lev = "+".join(k for k, v in r["levers"].items() if v) or "—"
        mf = r.get("memory_flash_s", r["memory_s"])
        out.append(
            f"| {r['profile']} | {r['arch']}×{r['shape']}×{r['mesh']} | {lev} | "
            f"{r['compute_s']:.3f} | {mf:.3f} | {r['collective_s']:.3f} | "
            f"{r['collective_gb_per_dev']:.1f} | {r['temp_gb_per_dev']:.0f} | "
            f"{r['bottleneck']} | {r['roofline_fraction']:.3f} |"
        )
    out.append("")
    out.append("Hypotheses (verbatim from the run log):")
    out.append("")
    for r in rows:
        out.append(f"* **{r['profile']}** — {r.get('hypothesis', '')}")
    return "\n".join(out)


def _topology_table(r: dict, K, p, payload) -> list:
    out = [
        f"Topology benchmark — K={K}, p={p}, payload "
        f"{payload} elems, mesh {r['mesh']}, model {r['topology']}; "
        f"autotuner choice: **{r['autotuner_choice']}**",
        "",
        "| algorithm | C1 | C2 | predicted µs | measured µs |",
        "|---|---|---|---|---|",
    ]
    for alg, pred in r["predicted"].items():
        meas = r["measured_us"].get(alg)
        out.append(
            f"| {alg} | {pred['c1']} | {pred['c2']} | {pred['us']:.1f} | "
            f"{f'{meas:.1f}' if meas is not None else '—'} |"
        )
    return out


def render_topology(path: str = "results/BENCH_torch_topology.json") -> str:
    with open(path) as fh:
        r = json.load(fh)
    out = _topology_table(r, r["K"], r["p"], r["payload_elems"])
    if "three_level" in r:
        out.append("")
        out.extend(
            _topology_table(r["three_level"], r["K"], r["p"], r["payload_elems"])
        )
    out.append("")
    out.append(
        "Measured numbers come from forced-host CPU meshes (collective "
        "emulation, not ICI) — feed them back via `autotune(..., measured=...)` "
        "rather than comparing across columns directly."
    )
    return "\n".join(out)


def render_drift(source, threshold: float = 0.5) -> str:
    """Per-round predicted-vs-measured drift table, sorted by relative
    error (worst first). ``source`` is a trace file path (the JSONL span
    sink or Chrome trace that ``dist.collectives.ir_encode(tracer=...)``
    emitted) or an in-memory span list; rows whose
    |measured−predicted|/predicted exceeds ``threshold`` are flagged ⚠:
    the rounds whose α/β constants (or schedule) are mispriced, to be re-fed
    through ``obs.feed.feed_calibration``."""
    from ..obs.feed import drift_rows

    if isinstance(source, str):
        from ..obs.export import read_spans

        source = read_spans(source)
    rows = drift_rows(source, threshold)
    out = [
        f"Per-round drift — predicted α-β µs vs. measured wall µs "
        f"(flag threshold: rel err > {threshold:g})",
        "",
        "| round | algorithm | level | predicted µs | measured µs | rel err | |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lvl = "—" if r["level"] is None else str(r["level"])
        out.append(
            f"| {r['round']} | {r['algorithm']} | {lvl} | "
            f"{r['predicted_us']:.1f} | {r['measured_us']:.1f} | "
            f"{r['rel_err']:.2f} | {'⚠' if r['flagged'] else ''} |"
        )
    if not rows:
        out.append("| — | — | — | — | — | — | (no traced rounds) |")
    out.append("")
    n_flag = sum(r["flagged"] for r in rows)
    out.append(
        f"{n_flag}/{len(rows)} rounds flagged. Forced-host CPU traces "
        "always drift (collective emulation, not ICI); refit with "
        "`obs.feed.feed_calibration` to re-price from these measurements."
    )
    return "\n".join(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    arg = argv[0] if argv else "results/perf_iterations_torch.jsonl"
    if arg.endswith(".jsonl") and "trace" in arg:
        print(render_drift(arg))
    elif arg.endswith(".trace.json"):
        print(render_drift(arg))
    elif arg.endswith(".json"):
        print(render_topology(arg))
    else:
        print(render(arg))


if __name__ == "__main__":
    main()
