"""Carrying plans and arrays across from the reference package.

The reference's plans, IR, topologies and link costs are dataclasses of
ints, floats, strings, tuples and numpy arrays. :func:`from_reference` reads
them by attribute — this module never imports the reference package — and
rebuilds them as the port's own classes, so the port's executors can run a
schedule the reference compiled and price it on the same topology. :func:`to_tensor` and
:func:`to_numpy` move residue and Shoup-dual arrays between ``np.uint32`` and
the port's ``int32`` bit-pattern tensors (``core.field`` states the
representation). :func:`state_from_reference` carries a whole state pytree
of the reference's arrays across as tensors, bfloat16 leaves bit for bit, so
that both packages encode the same bits; :func:`params_from_reference` does
the same for a model's parameters, checked leaf by leaf against the port's
model, and :func:`train_state_from_reference` for a train state's parameters
and optimizer state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import tree
from .coded.gradient_coding import GradCodingPlan
from .coded.lagrange_compute import LCCPlan
from .coded.rs_checkpoint import ParityPlan, leaf_tensor
from .core.field import resolve_device
from .core.field import to_numpy, to_tensor  # noqa: F401  (re-exported)
from .core.ir import CommRound, LocalOp, ScheduleIR, Transfer
from .core.schedule import ButterflyPlan, DrawLoosePlan, PrepareShootPlan
from .topo import hierarchical, model
from .train.optimizer import state_specs

__all__ = ["from_reference", "params_from_reference", "state_from_reference", "to_tensor", "to_numpy",
           "train_state_from_reference"]

_PLAN_CLASSES = {
    cls.__name__: cls
    for cls in (
        PrepareShootPlan,
        ButterflyPlan,
        DrawLoosePlan,
        hierarchical.HierarchicalPlan,
        hierarchical.MultiLevelPlan,
        hierarchical.RingPlan,
        hierarchical.TwoLevelDFTPlan,
        hierarchical.MultiLevelDFTPlan,
        model.LinkCost,
        model.FullyConnected,
        model.Ring,
        model.Torus2D,
        model.Torus3D,
        model.TwoLevel,
        model.Hierarchy,
        ParityPlan,
        LCCPlan,
        GradCodingPlan,
    )
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
    """A reference plan (``PrepareShootPlan``, ``ButterflyPlan``,
    ``DrawLoosePlan``, ``HierarchicalPlan``, ``MultiLevelPlan``, ``RingPlan``,
    ``TwoLevelDFTPlan``, ``MultiLevelDFTPlan``, and the coded layer's
    ``ParityPlan``, ``LCCPlan``, ``GradCodingPlan`` with the plans nested in
    them), topology (``FullyConnected``,
    ``Ring``, ``Torus2D``, ``Torus3D``, ``TwoLevel``, ``Hierarchy``),
    ``LinkCost`` or ``ScheduleIR`` — or any object with the same class name
    and attributes — as the port's own class, deep-copied."""
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
    raise TypeError(f"from_reference takes a plan, a topology, a LinkCost or a ScheduleIR, got {kind}")


def state_from_reference(state, device=None):
    """A pytree of the reference's arrays (numpy arrays, Python scalars, or
    anything with ``__array__``) as the same pytree of tensors on ``device``
    (``None``: the card), each leaf as the reference's ``jnp.asarray`` reads
    it: bits unchanged, but a 64-bit type (a Python ``int`` or ``float``
    too) as its 32-bit one. A bfloat16 leaf is recognised by its dtype's
    name and moved through a 16-bit integer view."""
    dev = resolve_device(device)
    return tree.map(lambda leaf: leaf_tensor(leaf).to(dev), state)


def _checked_from_reference(state, specs, what: str, dev):
    """``state`` (arrays) as tensors on ``dev``, after checking its structure,
    every shape and every dtype against ``specs`` (meta tensors)."""
    got, want = tree.structure(state), tree.structure(specs)
    if got != want:
        raise ValueError(f"{what} tree {got} is not the model's {want}")
    names = list(tree.flatten_with_names(specs))
    out = []
    for name, leaf, spec in zip(names, tree.leaves(state), tree.leaves(specs)):
        t = leaf_tensor(leaf)
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, the model has {tuple(spec.shape)} {spec.dtype}")
        out.append(t.to(dev))
    return tree.unflatten(want, out)


def params_from_reference(params, model, device=None):
    """The reference's parameter pytree of ``model``'s configuration (numpy
    arrays, or anything with ``__array__``) as the port's, on ``device``
    (``None``: the card): the same nested dicts with the stacked ``body``
    leaves, bfloat16 carried bit for bit. Raises ``ValueError`` unless the
    structure, every shape and every dtype equal ``model.param_specs()``."""
    return _checked_from_reference(params, model.param_specs(), "parameter", resolve_device(device))


def train_state_from_reference(state, model, opt_cfg, device=None):
    """The reference's train state ``{"params", "opt"}`` of ``model`` under
    ``opt_cfg`` as the port's, on ``device`` (``None``: the card), bits
    unchanged (bfloat16 moments too). Raises ``ValueError`` unless ``opt``
    has the structure, shapes and dtypes of ``state_specs(opt_cfg, ...)``."""
    dev = resolve_device(device)
    if not isinstance(state, dict) or sorted(state) != ["opt", "params"]:
        raise ValueError('a train state is {"params": ..., "opt": ...}')
    specs = state_specs(opt_cfg, model.param_specs())
    return {"params": params_from_reference(state["params"], model, dev),
            "opt": _checked_from_reference(state["opt"], specs, "optimizer state", dev)}
