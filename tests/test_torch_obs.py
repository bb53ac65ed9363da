"""Differential tests of the port's observability layer (``repro_torch.obs``)
against the reference's (``repro.obs``), on the CPU.

The same instrument calls, spans and files go through both packages: span
trees, the Chrome-trace and JSONL sinks (each package reads the other's
files), metrics snapshots, the calibration feed (``round_measurements``,
``refit_from_spans``, ``drift_rows``, ``persist_fitted_costs`` and
``load_fitted_costs``) and the traced ``interpret``. Values must be equal —
floats too, since both run the same numpy code — except span timestamps and
durations, which are wall-clock readings of each run.
"""

import json

import numpy as np
import pytest

from repro import obs as robs
from repro.core.field import M31, Field
from repro.core.matrices import distinct_points, random_vector, vandermonde
from repro.core.simulator import interpret as r_interpret
from repro.topo import Hierarchy as RHierarchy
from repro.topo import load_fitted_costs as r_load
from repro.topo import plan_multilevel as r_plan_multilevel
from repro_torch import obs as pobs
from repro_torch.core.simulator import interpret as p_interpret
from repro_torch.topo import Hierarchy as PHierarchy
from repro_torch.topo import load_fitted_costs as p_load
from repro_torch.topo import plan_multilevel as p_plan_multilevel
from test_torch_plans import _values_equal as same

BOTH = [robs, pobs]


def _no_times(spans):
    """Span dicts without their wall-clock fields."""
    out = []
    for s in spans:
        d = s if isinstance(s, dict) else s.to_dict()
        out.append({k: v for k, v in d.items() if k not in ("ts_us", "dur_us")})
    return out


def _tree(mod):
    tr = mod.Tracer()
    with tr.span("outer", kind="root") as outer:
        with tr.span("inner-a", i=0):
            pass
        with tr.span("inner-b", i=1) as b:
            with tr.span("leaf"):
                pass
            b.attrs["bytes"] = 64
    return tr, outer


def test_span_nesting_matches_reference():
    (rt, _), (pt, p_outer) = _tree(robs), _tree(pobs)
    assert _no_times(pt.spans) == _no_times(rt.spans)
    assert [s.depth for s in pt.spans] == [0, 1, 1, 2]
    assert [s.parent for s in pt.spans] == [None, 0, 0, 2]
    assert p_outer.attrs == {"kind": "root"}
    for s in pt.spans[1:]:  # children lie inside their parents on one timeline
        p = pt.spans[s.parent]
        assert s.dur_us >= 0 and p.ts_us <= s.ts_us
        assert s.ts_us + s.dur_us <= p.ts_us + p.dur_us + 1e-6
    assert pobs.current_tracer() is None
    pobs.set_tracer(pt)
    try:
        assert pobs.current_tracer() is pt and robs.current_tracer() is None
    finally:
        pobs.set_tracer(None)


def _fixed_spans(mod):
    """Spans with fixed times, so that both packages' exports compare whole."""
    return [
        mod.Span(name="encode", ts_us=0.0, dur_us=50.0, attrs={"algorithm": "multilevel", "K": 8}),
        mod.Span(name="round[0]", ts_us=1.0, dur_us=20.0, depth=1, parent=0,
                 attrs={"comm_round": 0, "predicted_us": 12.5, "level": np.int64(0)}),
        mod.Span(name="round[1]", ts_us=22.0, dur_us=25.5, depth=1, parent=0,
                 attrs={"comm_round": 1, "predicted_us": 30.0, "pairs": ((0, 1), (1, 0))}),
    ]


def test_chrome_and_jsonl_round_trip_across_packages(tmp_path):
    r_sp, p_sp = _fixed_spans(robs), _fixed_spans(pobs)
    assert pobs.spans_to_chrome(p_sp, process_name="t") == robs.spans_to_chrome(r_sp, process_name="t")
    files = {}
    for tag, mod, spans in (("ref", robs, r_sp), ("port", pobs, p_sp)):
        files[tag] = (mod.write_chrome_trace(spans, str(tmp_path / tag / "t.trace.json")),
                      mod.write_spans_jsonl(spans, str(tmp_path / tag / "t.jsonl")))
    for i in range(2):  # same bytes on disk, and each package reads the other's file
        assert open(files["ref"][i]).read() == open(files["port"][i]).read()
        for reader in BOTH:
            for tag in ("ref", "port"):
                assert reader.read_spans(files[tag][i]) == robs.read_spans(files["ref"][i])
    back = pobs.read_spans(files["port"][1])
    assert [s["parent"] for s in back] == [None, 0, 0]
    assert back[1]["attrs"] == {"comm_round": 0, "predicted_us": 12.5, "level": 0}
    assert pobs.default_trace_path("x").endswith("results/traces/x.jsonl")
    assert pobs.default_trace_path("x", "chrome").endswith("results/traces/x.trace.json")


def _instrument(mod):
    reg = mod.MetricsRegistry()
    reg.counter("encode.rounds").inc(3)
    reg.counter("encode.ppermutes").inc()
    reg.gauge("encode.last_us").set(123.5)
    h = reg.histogram("encode.round_us", level=1)
    for v in (5.0, 1.0, 9.0, 3.0, 7.25):
        h.observe(v)
    reg.histogram("encode.round_us", level=0).observe(2.0)
    reg.counter("x", shard=1, axis="k").inc(2.5)
    return reg


def test_metrics_snapshots_match(tmp_path):
    r_reg, p_reg = _instrument(robs), _instrument(pobs)
    snap = p_reg.snapshot()
    assert snap == r_reg.snapshot() and list(snap) == sorted(snap)
    r_reg.write_json(str(tmp_path / "r.json"))
    p_reg.write_json(str(tmp_path / "p.json"))
    assert (tmp_path / "r.json").read_text() == (tmp_path / "p.json").read_text()
    c = p_reg.counter("encode.rounds")
    assert p_reg.counter("encode.rounds") is c
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        p_reg.gauge("encode.rounds")
    p_reg.reset()
    assert p_reg.snapshot() == {}
    assert pobs.get_registry() is pobs.REGISTRY and pobs.REGISTRY is not robs.REGISTRY


def _round_dicts():
    """Traced-round span dicts: level 0 at α=1 ms, β=1 µs/elem, level 1 at
    2 ms and 2 µs/elem, plus noise and a round with no level."""
    rng = np.random.default_rng(4)
    spans, i = [], 0
    for level, (a_s, b_s) in enumerate([(1e-3, 1e-6), (2e-3, 2e-6)]):
        for elems in (10, 100, 1000, 5000):
            wall = (a_s + b_s * elems) * 1e6 * float(rng.uniform(0.9, 1.1))
            spans.append({"name": f"round[{i}]", "ts_us": float(100 * i), "dur_us": wall,
                          "depth": 1, "parent": 0,
                          "attrs": {"algorithm": "multilevel", "comm_round": i, "level": level,
                                    "msgs": 1 + level, "elems": elems, "payload_elems": 1,
                                    "predicted_us": 10.0 * (i + 1)}})
            i += 1
    spans.append({"name": "round[8]", "ts_us": 900.0, "dur_us": 5.0, "depth": 1, "parent": 0,
                  "attrs": {"comm_round": 8, "predicted_us": 5.0}})
    spans.append({"name": "local[1]", "ts_us": 950.0, "dur_us": 5.0, "depth": 1, "parent": 0,
                  "attrs": {"kind": "local"}})
    return spans


def test_feed_refit_and_drift_match():
    spans = _round_dicts()
    assert pobs.comm_round_spans(spans) == robs.comm_round_spans(spans)
    assert pobs.round_measurements(spans) == robs.round_measurements(spans)
    assert same(pobs.refit_from_spans(spans), robs.refit_from_spans(spans))
    assert same(pobs.refit_from_spans(spans, 3), robs.refit_from_spans(spans, 3))
    for th in (0.1, 0.5, 2.0):
        assert pobs.drift_rows(spans, threshold=th) == robs.drift_rows(spans, threshold=th)
    # Span objects of the port read like dicts
    objs = [pobs.Span(**s) for s in spans]
    assert pobs.round_measurements(objs) == robs.round_measurements(spans)
    with pytest.raises(ValueError):
        pobs.refit_from_spans([])


def test_persist_then_load_through_tmp_path(tmp_path):
    spans = _round_dicts()
    path = tmp_path / "cal.json"
    path.write_text(json.dumps({"K": 8, "calibration": {"note": "old"}}))
    fitted = pobs.feed_calibration(spans, str(path))
    rec = json.loads(path.read_text())
    assert rec["K"] == 8 and rec["calibration"]["note"] == "old"
    assert rec["calibration"]["source"] == "live-trace"
    assert rec["calibration"]["samples"] == robs.round_measurements(spans)
    assert tuple(p_load(str(path))) == tuple(fitted)
    assert same(r_load(str(path)), p_load(str(path)))  # the reference reads the port's record
    # the reference's writer produces the same record
    rpath = tmp_path / "ref.json"
    rpath.write_text(json.dumps({"K": 8, "calibration": {"note": "old"}}))
    robs.feed_calibration(spans, str(rpath))
    assert json.loads(rpath.read_text()) == rec
    # refit straight from a trace file
    jsonl = pobs.write_spans_jsonl(spans, str(tmp_path / "enc.jsonl"))
    assert same(pobs.fitted_costs_from_trace(jsonl), robs.fitted_costs_from_trace(jsonl))
    assert p_load(str(tmp_path / "absent.json")) is None


def test_traced_interpret_matches_reference():
    """The port's interpreter takes ``tracer=``/``topo=`` as the reference's
    does: same output, same span tree and attributes (predicted_us
    included)."""
    K = 8
    f = Field(M31)
    A = np.asarray(vandermonde(f, distinct_points(f, K, seed=0)))
    x = random_vector(f, (K,), seed=2)
    outs, trees = [], []
    for mod, plan, interp, hier in ((robs, r_plan_multilevel, r_interpret, RHierarchy),
                                     (pobs, p_plan_multilevel, p_interpret, PHierarchy)):
        ir = plan(K, 1, (2, 2, 2)).to_ir(A)
        tr = mod.Tracer()
        out, st = interp(ir, x, f, tracer=tr, topo=hier(levels=(2, 2, 2)))
        plain, _ = interp(ir, x, f)
        assert np.array_equal(out, plain)
        comm = [s for s in tr.spans if "comm_round" in s.attrs]
        assert len(comm) == ir.c1 and all("predicted_us" in s.attrs for s in comm)
        assert tr.spans[0].name == "interpret"
        outs.append(out)
        trees.append(_no_times(tr.spans))
    assert np.array_equal(outs[0], outs[1])
    assert trees[0] == trees[1]
