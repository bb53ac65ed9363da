"""Process-local metrics registry: counters, gauges, histograms.

One :class:`MetricsRegistry` per process (module-level :data:`REGISTRY`,
reachable via :func:`get_registry`) holds named instruments, optionally
labelled — ``registry.histogram("encode.round_us", level=1)`` materializes
the series ``encode.round_us{level=1}``. Instrument names the port writes:

* ``encode.rounds`` / ``encode.ppermutes`` / ``encode.bytes_on_wire`` —
  counters bumped per traced :class:`~repro_torch.core.ir.CommRound` by
  ``dist.collectives.ir_encode(tracer=...)``;
* ``encode.round_us{level=j}`` — histogram of measured per-round wall µs,
  labelled by the round's topology level (the rows ``repro_torch.obs.feed``
  refits α/β from).

The names keep the reference's (``encode.ppermutes`` counts the port's
gathers, one a port group), so that both registries read alike.

Snapshots are deterministic: keys sorted, histogram statistics derived
from the full sample list (count/sum/min/max/mean/p50/p90/p99), so two
identical runs produce byte-identical JSON.
"""

from __future__ import annotations

import json
import os


def _series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


def _quantile(sorted_vals: list, q: float) -> float:
    """Nearest-rank quantile over an already-sorted sample list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


class Histogram:
    __slots__ = ("samples",)

    def __init__(self):
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    def snapshot(self) -> dict:
        s = sorted(self.samples)
        n = len(s)
        return {
            "type": "histogram",
            "count": n,
            "sum": sum(s),
            "min": s[0] if n else 0.0,
            "max": s[-1] if n else 0.0,
            "mean": (sum(s) / n) if n else 0.0,
            "p50": _quantile(s, 0.50),
            "p90": _quantile(s, 0.90),
            "p99": _quantile(s, 0.99),
        }


class MetricsRegistry:
    """Lazily-materializing instrument registry; same (name, labels) always
    returns the same instrument, and asking for an existing series with a
    different instrument kind is an error."""

    def __init__(self):
        self._series: dict[str, object] = {}

    def _get(self, cls, name: str, labels: dict):
        key = _series_key(name, labels)
        inst = self._series.get(key)
        if inst is None:
            inst = cls()
            self._series[key] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {key!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}"
            )
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def snapshot(self) -> dict:
        """Deterministic {series_key: stats} map, keys sorted."""
        return {k: self._series[k].snapshot() for k in sorted(self._series)}

    def write_json(self, path: str) -> dict:
        snap = self.snapshot()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(snap, fh, indent=2, sort_keys=True)
        return snap

    def reset(self) -> None:
        self._series.clear()


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-local default registry instrumented layers record into."""
    return REGISTRY
