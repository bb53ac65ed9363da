"""Carrying plans and arrays across from the reference package.

The reference's plans and IR are dataclasses of ints, tuples and numpy
arrays. :func:`from_reference` reads them by attribute — this module never
imports the reference package — and rebuilds them as the port's own classes,
so the port's executors can run a schedule the reference compiled. :func:`to_tensor` and
:func:`to_numpy` move residue and Shoup-dual arrays between ``np.uint32`` and
the port's ``int32`` bit-pattern tensors (``core.field`` states the
representation).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .core.field import to_numpy, to_tensor  # noqa: F401  (re-exported)
from .core.ir import CommRound, LocalOp, ScheduleIR, Transfer
from .core.schedule import ButterflyPlan, DrawLoosePlan, PrepareShootPlan

__all__ = ["from_reference", "to_tensor", "to_numpy"]

_PLAN_CLASSES = {
    "PrepareShootPlan": PrepareShootPlan,
    "ButterflyPlan": ButterflyPlan,
    "DrawLoosePlan": DrawLoosePlan,
}


def _copy_value(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, tuple):
        return tuple(_copy_value(e) for e in v)
    if type(v).__name__ in _PLAN_CLASSES:
        return from_reference(v)
    raise TypeError(f"cannot carry a {type(v).__name__} across")


def _plan(obj):
    cls = _PLAN_CLASSES[type(obj).__name__]
    return cls(**{f.name: _copy_value(getattr(obj, f.name)) for f in dataclasses.fields(cls)})


def _step(step):
    kind = type(step).__name__
    if kind == "CommRound":
        return CommRound(
            tuple(
                Transfer(
                    src=int(t.src),
                    dst=int(t.dst),
                    port=int(t.port),
                    slots=tuple((int(a), int(b)) for a, b in t.slots),
                    coeffs=None if t.coeffs is None else tuple(int(c) for c in t.coeffs),
                    mode=str(t.mode),
                )
                for t in step.transfers
            )
        )
    if kind == "LocalOp":
        return LocalOp(
            out_slots=tuple(int(s) for s in step.out_slots),
            in_slots=tuple(int(s) for s in step.in_slots),
            coeffs=None if step.coeffs is None else np.array(step.coeffs, copy=True),
            update=bool(step.update),
            overlap=bool(step.overlap),
        )
    raise TypeError(f"unknown IR step {kind}")


def from_reference(obj):
    """A reference ``PrepareShootPlan`` / ``ButterflyPlan`` / ``DrawLoosePlan``
    / ``ScheduleIR`` (or any object with the same attributes) as the port's
    own class, deep-copied."""
    kind = type(obj).__name__
    if kind in _PLAN_CLASSES:
        return _plan(obj)
    if kind == "ScheduleIR":
        return ScheduleIR(
            algorithm=str(obj.algorithm),
            K=int(obj.K),
            p=int(obj.p),
            steps=tuple(_step(s) for s in obj.steps),
            placement=None if obj.placement is None else tuple(int(v) for v in obj.placement),
            out_slot=int(obj.out_slot),
        )
    raise TypeError(f"from_reference takes a plan or a ScheduleIR, got {kind}")
