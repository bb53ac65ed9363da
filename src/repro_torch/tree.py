"""Pytrees of tensors with JAX's order and leaf set.

A state the coded layer protects is a nest of ``dict``, ``list`` and
``tuple`` containers with arrays at the leaves. Its limbs, its checkpoint
names and its parity depend on the order in which the leaves are read, so
this module reads them exactly as ``jax.tree_util`` does:

* a ``dict`` or ``defaultdict`` is read in **sorted key order**
  (``{'z': 1, 'a': 2}`` gives ``[2, 1]``; ``torch.utils._pytree`` would give
  ``[1, 2]``), an ``OrderedDict`` in insertion order;
* ``list``, ``tuple`` and a namedtuple in index order;
* ``None`` is a container with no children, so it holds no leaf
  (``[None, 1]`` gives ``[1]``; ``torch.utils._pytree`` gives ``[None, 1]``);
* anything else is a leaf, a subclass of ``dict`` or ``tuple`` too.

:func:`flatten_with_names` names each leaf by its path as
``train/checkpoint.py`` of the reference does: dict keys and sequence
indices joined by ``/`` (a namedtuple's field by its name, which the
reference's checkpoint cannot name). A :class:`TreeDef` prints as JAX's
``PyTreeDef``.
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["TreeDef", "flatten", "unflatten", "flatten_with_names", "leaves", "structure", "map"]


@dataclass(frozen=True)
class TreeDef:
    """The shape of a pytree: ``kind`` is ``"leaf"``, ``"none"``, ``"dict"``,
    ``"OrderedDict"``, ``"defaultdict"``, ``"list"``, ``"tuple"`` or
    ``"namedtuple"``; ``keys`` are a mapping's keys in reading order;
    ``children`` the sub-trees in reading order; ``node`` a defaultdict's
    ``default_factory`` or a namedtuple's class."""

    kind: str
    keys: tuple = ()
    children: tuple = ()
    node: Any = None

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def _text(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = [c._text() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {v}" for k, v in zip(self.keys, inner)) + "}"
        custom = {"OrderedDict": repr(self.keys), "defaultdict": repr((self.node, self.keys)),
                  "namedtuple": getattr(self.node, "__name__", "")}
        if self.kind in custom:
            return f"CustomNode({self.kind}[{custom[self.kind]}], [{', '.join(inner)}])"
        if self.kind == "list":
            return "[" + ", ".join(inner) + "]"
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"

    def __str__(self) -> str:
        return f"PyTreeDef({self._text()})"


def _walk(tree, path: tuple, out: list) -> TreeDef:
    if tree is None:
        return TreeDef("none")
    kind = type(tree)
    if kind in (dict, defaultdict, OrderedDict):
        keys = tuple(tree) if kind is OrderedDict else tuple(sorted(tree))
        kids = tuple(_walk(tree[k], path + (k,), out) for k in keys)
        return TreeDef(kind.__name__, keys, kids, getattr(tree, "default_factory", None))
    if kind in (list, tuple):
        return TreeDef(kind.__name__, (), tuple(_walk(c, path + (i,), out) for i, c in enumerate(tree)))
    if isinstance(tree, tuple) and hasattr(kind, "_fields"):  # a namedtuple
        kids = tuple(_walk(c, path + (f,), out) for f, c in zip(kind._fields, tree))
        return TreeDef("namedtuple", (), kids, kind)
    out.append((path, tree))
    return TreeDef("leaf")


def flatten(tree) -> tuple[list, TreeDef]:
    """(leaves in JAX's order, the tree's structure)."""
    out: list = []
    treedef = _walk(tree, (), out)
    return [leaf for _, leaf in out], treedef


def flatten_with_names(tree) -> dict[str, Any]:
    """``{name: leaf}`` in JAX's order; a name is the leaf's path of dict
    keys and sequence indices joined by ``/``."""
    out: list = []
    _walk(tree, (), out)
    return {"/".join(str(p) for p in path): leaf for path, leaf in out}


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of shape ``treedef`` holding ``leaves`` in reading order."""
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"{len(leaves)} leaves for a tree of {treedef.num_leaves}")
    return _build(treedef, iter(leaves))


def _build(td: TreeDef, it) -> Any:
    # a module-level function, not a closure that calls itself: such a closure
    # is a reference cycle that would hold every leaf until Python's cyclic
    # collector ran, so a train step's gradients and its last state would
    # outlive it by a time that depends on the whole process's history
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    kids = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.keys, kids))
    if td.kind == "OrderedDict":
        return OrderedDict(zip(td.keys, kids))
    if td.kind == "defaultdict":
        return defaultdict(td.node, zip(td.keys, kids))
    if td.kind == "namedtuple":
        return td.node(*kids)
    return kids if td.kind == "list" else tuple(kids)


def leaves(tree) -> list:
    return flatten(tree)[0]


def structure(tree) -> TreeDef:
    return flatten(tree)[1]


def map(fn: Callable, tree, *rest):  # noqa: A001 - the name of jax.tree.map
    """``fn`` applied leaf by leaf across trees of one structure."""
    first, treedef = flatten(tree)
    others = []
    for r in rest:
        lv, td = flatten(r)
        if td != treedef:
            raise ValueError(f"tree structures differ: {treedef} and {td}")
        others.append(lv)
    return unflatten(treedef, [fn(*args) for args in zip(first, *others)])
