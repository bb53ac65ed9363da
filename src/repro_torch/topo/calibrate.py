"""Bandwidth-measured calibration: fit per-level α/β from wall-time sweeps.

The α-β predictions in ``topo/model.py`` use the reference package's model
constants, not measured on this card; real hardware should fit its own. For a level-aligned schedule on a
:class:`~repro_torch.topo.model.Hierarchy`, each round's traffic rides exactly one
level, so a measured wall time decomposes linearly:

    wall ≈ Σ_rounds  (msgs_on_busiest_link · α_level  +
                      elems_on_busiest_link · payload · β_level)

:func:`round_features` extracts the per-round (level, msgs, elems) rows from
any lowered schedule, and :func:`fit_level_costs` least-squares the stacked
sweep (multiple algorithms × payload sizes) into one
:class:`~repro_torch.topo.model.LinkCost` per level — ready to pass as
``Hierarchy(levels, costs=fitted)`` or compare against
``default_level_costs``.

Two measurement sources feed the same fit: the offline aggregate sweep
(whole-encode wall times × analytic :func:`round_features` rows, as the
benchmark's ``calibration.samples``) and the live traced path —
``dist.collectives.ir_encode(tracer=...)`` stamps each round span with
its (level, msgs, elems) feature, and ``repro_torch.obs.feed`` turns those spans
into per-round measurements, refits, and persists exactly where
:func:`load_fitted_costs` reads.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .model import Hierarchy, LinkCost, round_link_loads

#: default location of the persisted calibration block (repo-root relative).
#: The port's own record: the reference package's ``results/BENCH_topology.json``
#: is neither read nor written here.
DEFAULT_CALIBRATION_PATH = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ),
    "results",
    "BENCH_torch_topology.json",
)


def round_features(rounds, topo: Hierarchy) -> list[dict]:
    """Per round: ``{"level": j, "msgs": a, "elems": e}`` — the busiest link
    of the round's highest occupied level (level-aligned schedules touch one
    level per round; for mixed rounds the slowest level dominates). These
    are the per-round rows the calibration fit consumes; ``elems`` is in
    schedule units (multiply by payload elements when fitting)."""
    out = []
    for msgs in rounds:
        loads = round_link_loads(topo, msgs)
        if not loads:
            continue
        top = max(link[1] for link in loads)
        cnt, elems = max(
            (v for link, v in loads.items() if link[1] == top),
            key=lambda v: (v[1], v[0]),
        )
        out.append({"level": int(top), "msgs": int(cnt), "elems": int(elems)})
    return out


def fit_level_costs(measurements, n_levels: int) -> tuple[LinkCost, ...]:
    """Least-squares (α_j, β_j) per level from measured wall times.

    ``measurements``: iterable of dicts with

    * ``"wall_s"`` — measured seconds for one (algorithm, payload) run;
    * ``"payload_elems"`` — field elements per schedule unit;
    * ``"rounds"`` — the :func:`round_features` rows of that schedule.

    Solves ``wall ≈ Σ_j A_j·α_j + E_j·β_j`` with A_j = Σ msgs over level-j
    rounds and E_j = Σ elems·payload; needs ≥ 2·n_levels independent samples
    (sweep payload sizes). Coefficients are clipped to a small positive
    floor — a physical link never has negative cost."""
    rows, y = [], []
    for m in measurements:
        feat = np.zeros(2 * n_levels)
        pay = float(m.get("payload_elems", 1))
        for r in m["rounds"]:
            j = int(r["level"])
            if not 0 <= j < n_levels:
                raise ValueError(f"round level {j} outside [0, {n_levels})")
            feat[2 * j] += r["msgs"]
            feat[2 * j + 1] += r["elems"] * pay
        rows.append(feat)
        y.append(float(m["wall_s"]))
    X = np.asarray(rows)
    y = np.asarray(y)
    if X.shape[0] < 2 * n_levels:
        raise ValueError(
            f"need ≥ {2 * n_levels} samples to fit {n_levels} levels, got {X.shape[0]}"
        )
    theta, *_ = np.linalg.lstsq(X, y, rcond=None)
    theta = np.maximum(theta, 1e-12)
    return tuple(
        LinkCost(alpha=float(theta[2 * j]), beta=float(theta[2 * j + 1]))
        for j in range(n_levels)
    )


def load_fitted_costs(path: str | None = None) -> tuple[LinkCost, ...] | None:
    """Load the fitted per-level α/β persisted under
    ``calibration.fitted_level_costs`` in :data:`DEFAULT_CALIBRATION_PATH`
    (or any file of the same shape; ``obs.feed.persist_fitted_costs`` writes
    it).

    Returns one :class:`~repro_torch.topo.model.LinkCost` per level (innermost
    first) — ready for ``Hierarchy(levels, costs=fitted)`` so the autotuner
    prices candidates with measured constants instead of the model
    defaults. Returns ``None`` when the file or
    its calibration block is absent (no benchmark has run yet); falls back
    to re-fitting from the persisted raw ``samples`` when only those exist."""
    path = path if path is not None else DEFAULT_CALIBRATION_PATH
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            record = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    cal = record.get("calibration") or {}
    rows = cal.get("fitted_level_costs")
    if rows:
        try:
            by_level = {int(r["level"]): r for r in rows}
            return tuple(
                LinkCost(
                    alpha=float(by_level[j]["alpha_s"]),
                    beta=float(by_level[j]["beta_s_per_elem"]),
                )
                for j in range(len(by_level))
            )
        except (KeyError, TypeError, ValueError):
            return None
    samples = cal.get("samples")
    if samples:
        n_levels = 1 + max(
            int(r["level"]) for m in samples for r in m.get("rounds", ())
        )
        try:
            return fit_level_costs(samples, n_levels)
        except (KeyError, ValueError):
            return None
    return None
