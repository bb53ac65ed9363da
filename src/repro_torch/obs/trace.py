"""Nestable span tracing for the encode pipeline.

A :class:`Tracer` records :class:`Span` records — named, attributed,
wall-clocked intervals on one monotonic timeline (``time.perf_counter``
anchored at tracer creation). Spans nest: ``with tracer.span("outer"):``
inside another span records the parent index and depth, so an export
(``repro_torch.obs.export``) can reconstruct the call tree and Perfetto renders
the nesting from the ``"X"`` complete-event containment.

The tracer is deliberately dumb — no sampling, no threads, no flushing
policy. Instrumented layers (``dist.collectives.ir_encode(tracer=...)``,
``core.simulator.interpret(tracer=...)``) open spans around their rounds and
attach the :class:`~repro_torch.core.ir.CommRound` metadata (round index,
transfer count, slots on the wire, predicted µs from the α-β model) as
span attributes; ``repro_torch.obs.feed`` then turns those attributed spans back
into calibration measurements.

A module-level default tracer (:func:`set_tracer` / :func:`current_tracer`)
lets an entry point hand one tracer to code it does not call directly.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Span:
    """One traced interval. ``ts_us``/``dur_us`` are microseconds on the
    owning tracer's monotonic timeline; ``parent`` is the index (into
    ``Tracer.spans``) of the enclosing span, or ``None`` at top level.
    ``attrs`` may be extended while the span is open (e.g. a measured
    byte count discovered mid-span)."""

    name: str
    ts_us: float
    dur_us: float = 0.0
    depth: int = 0
    parent: int | None = None
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "ts_us": self.ts_us,
            "dur_us": self.dur_us,
            "depth": self.depth,
            "parent": self.parent,
            "attrs": dict(self.attrs),
        }


class Tracer:
    """Collects spans; see module doc. Spans are appended at OPEN time so
    ``spans`` is in start order and a parent always precedes its children;
    ``dur_us`` is filled when the span closes."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._stack: list[int] = []
        self.spans: list[Span] = []

    def now_us(self) -> float:
        """Microseconds since tracer creation (monotonic)."""
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, **attrs):
        """Open a nested span; yields the :class:`Span` so callers can add
        attrs (``sp.attrs["bytes"] = n``) before it closes."""
        sp = Span(
            name=name,
            ts_us=self.now_us(),
            depth=len(self._stack),
            parent=self._stack[-1] if self._stack else None,
            attrs=dict(attrs),
        )
        idx = len(self.spans)
        self.spans.append(sp)
        self._stack.append(idx)
        try:
            yield sp
        finally:
            sp.dur_us = self.now_us() - sp.ts_us
            self._stack.pop()

    def to_dicts(self) -> list[dict]:
        return [s.to_dict() for s in self.spans]


_DEFAULT: Tracer | None = None


def set_tracer(tracer: Tracer | None) -> None:
    """Install ``tracer`` as the process-wide default (None clears it)."""
    global _DEFAULT
    _DEFAULT = tracer


def current_tracer() -> Tracer | None:
    """The tracer installed by :func:`set_tracer`, if any — consulted by
    entry points that cannot take a ``tracer=`` argument directly."""
    return _DEFAULT
