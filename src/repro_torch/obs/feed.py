"""Close the telemetry loop: traced round spans → fitted α/β → profiles.

``dist.collectives.ir_encode(tracer=...)`` stamps every per-round span
with the round's busiest-link calibration features (``level``, ``msgs``,
``elems`` — exactly the rows ``topo.calibrate.round_features`` derives) next
to the measured wall time and the α-β model's prediction. This module turns
those spans back into the calibration pipeline's inputs:

* :func:`round_measurements` — spans → ``fit_level_costs`` measurement
  dicts (one per traced round: its wall seconds, payload, and single
  feature row — finer-grained than the offline aggregate sweeps, which
  only see whole-encode wall times);
* :func:`refit_from_spans` — re-run the least-squares α/β fit on live
  telemetry;
* :func:`persist_fitted_costs` — write the fit into the ``calibration``
  block of ``topo.calibrate.DEFAULT_CALIBRATION_PATH`` (the port's own
  ``results/BENCH_torch_topology.json``) or any path, EXACTLY where
  ``topo.calibrate.load_fitted_costs`` reads fitted costs;
* :func:`feed_calibration` — the one-shot compose of the three above;
* :func:`drift_rows` — per-round predicted-vs-measured comparison
  (relative error, threshold flag).
"""

from __future__ import annotations

import json
import os


def _attrs(span) -> dict:
    return span.get("attrs", {}) if isinstance(span, dict) else span.attrs


def _field(span, key, default=None):
    if isinstance(span, dict):
        return span.get(key, default)
    return getattr(span, key, default)


def comm_round_spans(spans) -> list:
    """The spans that carry traced CommRound telemetry (attr ``comm_round``),
    in recorded order."""
    return [s for s in spans if "comm_round" in _attrs(s)]


def round_measurements(spans) -> list[dict]:
    """Traced round spans → :func:`topo.calibrate.fit_level_costs`
    measurement dicts: one measurement per round, whose single feature row
    is the round's busiest-link (level, msgs, elems) stamped by the traced
    executor. Spans without calibration features (e.g. traced on a flat
    topology with no ``level`` attr) are skipped."""
    out = []
    for sp in comm_round_spans(spans):
        a = _attrs(sp)
        if a.get("level") is None:
            continue
        out.append(
            {
                "algorithm": a.get("algorithm", ""),
                "round": int(a["comm_round"]),
                "wall_s": float(_field(sp, "dur_us", 0.0)) * 1e-6,
                "payload_elems": int(a.get("payload_elems", 1)),
                "rounds": [
                    {
                        "level": int(a["level"]),
                        "msgs": int(a["msgs"]),
                        "elems": int(a["elems"]),
                    }
                ],
            }
        )
    return out


def refit_from_spans(spans, n_levels: int | None = None):
    """Least-squares per-level α/β from live traced rounds (see
    ``topo.calibrate.fit_level_costs`` for the model). ``n_levels`` defaults
    to 1 + the highest level any span saw."""
    from ..topo.calibrate import fit_level_costs

    ms = round_measurements(spans)
    if not ms:
        raise ValueError("no traced comm-round spans with calibration features")
    if n_levels is None:
        n_levels = 1 + max(r["level"] for m in ms for r in m["rounds"])
    return fit_level_costs(ms, n_levels)


def persist_fitted_costs(fitted, path: str | None = None, *, samples=None) -> str:
    """Merge fitted per-level costs into the ``calibration`` block at
    ``path`` (default: ``topo.calibrate.DEFAULT_CALIBRATION_PATH``, the
    port's own record that ``topo.calibrate.load_fitted_costs`` reads), preserving every other key
    of an existing record. ``samples`` (the measurement dicts the fit came
    from) are stored under ``calibration.samples`` so the loader's
    refit-from-raw fallback keeps working."""
    from ..topo.calibrate import DEFAULT_CALIBRATION_PATH

    path = path if path is not None else DEFAULT_CALIBRATION_PATH
    record = {}
    if os.path.exists(path):
        try:
            with open(path) as fh:
                record = json.load(fh)
        except (OSError, json.JSONDecodeError):
            record = {}
    cal = record.setdefault("calibration", {})
    cal["fitted_level_costs"] = [
        {"level": j, "alpha_s": c.alpha, "beta_s_per_elem": c.beta}
        for j, c in enumerate(fitted)
    ]
    cal["source"] = "live-trace"
    if samples is not None:
        cal["samples"] = samples
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(record, fh, indent=2)
    return path


def feed_calibration(spans, path: str | None = None, n_levels: int | None = None):
    """The one-shot live loop: traced spans → measurements → α/β fit →
    persisted where ``load_fitted_costs`` reads it.
    Returns the fitted per-level :class:`~repro_torch.topo.model.LinkCost`s."""
    fitted = refit_from_spans(spans, n_levels)
    persist_fitted_costs(fitted, path, samples=round_measurements(spans))
    return fitted


def fitted_costs_from_trace(path: str, n_levels: int | None = None):
    """Refit α/β straight from a trace file (JSONL span sink or Chrome
    trace)."""
    from .export import read_spans

    return refit_from_spans(read_spans(path), n_levels)


def drift_rows(spans, threshold: float = 0.5) -> list[dict]:
    """Per traced round: predicted vs measured µs, relative error, and a
    ``flagged`` bool (|measured−predicted|/predicted > threshold), sorted by
    relative error descending. Rounds run as gathers inside one device's
    memory drift far from a link model; across real links a flagged round
    means the α-β constants — or the schedule — need a second look."""
    rows = []
    for sp in comm_round_spans(spans):
        a = _attrs(sp)
        pred = a.get("predicted_us")
        if pred is None:
            continue
        meas = float(_field(sp, "dur_us", 0.0))
        rel = abs(meas - pred) / pred if pred > 0 else float("inf")
        rows.append(
            {
                "round": int(a["comm_round"]),
                "name": _field(sp, "name", ""),
                "algorithm": a.get("algorithm", ""),
                "level": a.get("level"),
                "predicted_us": float(pred),
                "measured_us": meas,
                "rel_err": rel,
                "flagged": rel > threshold,
            }
        )
    rows.sort(key=lambda r: r["rel_err"], reverse=True)
    return rows
