#!/usr/bin/env python
"""Trace one multi-level encode end-to-end with the PyTorch port.

Builds the recursive three-level Vandermonde encode
(``plan_multilevel(8, 1, (2, 2, 2))``: pod × slice × chip, K = 8) and runs
its IR through ``repro_torch.dist.collectives.ir_encode(tracer=...,
topo=Hierarchy((2, 2, 2)))`` on ``--device`` (default: the card): one span
per CommRound with the α-β prediction stamped next to the measured wall
time. The first traced call is discarded as warm-up (it builds the kernels'
constants and, on the card, loads the kernels); only the second call's spans
are kept. The output must equal the untraced ``ir_encode`` and the host
oracle ``encode_oracle``. Writes both trace sinks plus the metrics snapshot.

Usage::

    python tools/trace_encode_torch.py [--out results/traces/encode_torch] \\
        [--device cpu] [--feed results/BENCH_torch_topology.json] [--drift]

``--feed`` pushes the traced rounds through ``obs.feed.feed_calibration``
(refit α/β, persist into the ``calibration`` block where
``topo.calibrate.load_fitted_costs`` / ``launch.profiles.resolve_profile``
read it). ``--drift`` prints the per-round predicted-vs-measured table.
Check the traces with ``python tools/check_trace.py <out>.trace.json`` (and
``<out>.jsonl``).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/traces/encode_torch",
                    help="output path prefix (writes <out>.trace.json + <out>.jsonl + <out>.metrics.json)")
    ap.add_argument("--payload", type=int, default=1 << 14,
                    help="payload elems per source shard")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--feed", default=None, metavar="PATH",
                    help="refit α/β from the trace and persist into PATH's calibration block")
    ap.add_argument("--drift", action="store_true",
                    help="print the per-round predicted-vs-measured drift table")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.core.field import M31, Field, resolve_device, to_numpy, to_tensor
    from repro_torch.core.matrices import distinct_points, random_vector, vandermonde
    from repro_torch.core.prepare_shoot import encode_oracle
    from repro_torch.dist.collectives import ir_encode
    from repro_torch.obs import (
        Tracer,
        get_registry,
        write_chrome_trace,
        write_spans_jsonl,
    )
    from repro_torch.topo import Hierarchy, plan_multilevel

    dev = resolve_device(args.device)
    K = 8
    f = Field(M31)
    A = np.asarray(vandermonde(f, distinct_points(f, K, seed=0)))
    topo = Hierarchy(levels=(2, 2, 2))
    ir = plan_multilevel(K, 1, (2, 2, 2)).to_ir(A)

    tracer = Tracer()
    fn = ir_encode(ir, device=dev, tracer=tracer, topo=topo)
    x_host = random_vector(f, (K, args.payload), seed=1)
    x = to_tensor(x_host, dev)
    fn(x)  # warm-up
    n0 = len(tracer.spans)
    out = fn(x)
    spans = tracer.spans[n0:]
    untraced = ir_encode(ir, device=dev)
    assert bool((out == untraced(x)).all()), "traced != untraced output"
    assert np.array_equal(to_numpy(out).astype(np.uint64), encode_oracle(x_host, A)), "traced != encode_oracle"
    comm = [s for s in spans if "comm_round" in s.attrs]
    print(f"traced {len(comm)} comm rounds / {len(spans)} spans "
          f"(schedule: {ir.c1} rounds, {ir.c2} slot-rounds) on {dev}")
    assert len(comm) == ir.c1, f"expected {ir.c1} round spans, got {len(comm)}"

    chrome = write_chrome_trace(spans, args.out + ".trace.json",
                                process_name="trace_encode_torch")
    jsonl = write_spans_jsonl(spans, args.out + ".jsonl")
    metrics = args.out + ".metrics.json"
    get_registry().write_json(metrics)
    print(f"wrote {chrome}\nwrote {jsonl}\nwrote {metrics}")

    if args.feed:
        from repro_torch.obs import feed_calibration

        fitted = feed_calibration(spans, args.feed)
        print(f"fed calibration -> {args.feed}:")
        for j, c in enumerate(fitted):
            print(f"  level {j}: alpha={c.alpha:.3e}s beta={c.beta:.3e}s/elem")
    if args.drift:
        from repro_torch.launch.perf_report import render_drift

        print()
        print(render_drift(spans))
    return 0


if __name__ == "__main__":
    sys.exit(main())
