"""Logical-axis sharding rules and the divisibility-aware logical→physical
mapper: the host half of the reference's ``dist/sharding.py``.

Model, train and launch code annotate arrays with *logical* dim names
(``("batch", "seq", "d_model")``); :class:`ShardingRules` maps each logical
name to an ordered tuple of *mesh axis* names, and :func:`spec_for` lowers a
dims-tuple to a partition spec against a concrete mesh:

* mesh axes a rule names but the mesh doesn't have (e.g. ``pod`` on a
  single-pod mesh) are silently dropped — the same rules run on a laptop
  mesh and the 512-chip production mesh;
* a mesh axis is used at most once per spec;
* when the array shape is known, an axis is only applied if the dim size is
  divisible by the axis size — a non-divisible dim degrades to replicated,
  never to a crash.

Rules are immutable; :meth:`ShardingRules.override` returns a derived rule
set, which is how per-shape presets (``launch/rules.py``) and optimization
profiles (``launch/profiles.py``) compose. Boolean *flags* (``attn_heads``,
``moe_gather``, ``logits_vocab``) ride along the rules object so the model
code can branch on profile levers without a second plumbing channel; on one
device the flags are all that the model reads (``models.layers.Ctx.flag``).

A spec is a plain tuple, one entry a dim: ``None`` (replicated), an axis
name, or a tuple of axis names — what ``tuple(PartitionSpec(...))`` is in
the reference. Placing arrays by a spec (``named_sharding``, ``constrain``)
waits for the device half of the sharding substrate (ROADMAP.md queue A3).
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

__all__ = ["ShardingRules", "spec_for", "named_sharding", "constrain", "DEFAULT_RULES"]

_DEVICE_HALF = "ROADMAP.md queue A3 (the device half of the sharding substrate)"


# Default logical→mesh-axis mapping: FSDP-flavored presets over the
# production axes ("pod", "data", "model"). Per-shape presets override
# ``seq``/``d_model``/``kv_seq`` (launch/rules.py); profiles override the
# MoE and batch entries (launch/profiles.py). Unknown names → replicated.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    "kv_seq": (),
    "frames": (),
    # params: feature dims → model (tensor parallel), d_model FSDP'd only
    # when the per-shape preset asks for it
    "d_model": (),
    "d_ff": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "vocab": ("model",),
    # MoE: expert weights FSDP over data on their d_model-like dim
    "experts": (),
    "expert_d": ("data",),
    "moe_ff": ("model",),
    # SSM / conv / encoder internals stay replicated by default
    "state": (),
    "conv": (),
    "enc_out": (),
}


def _normalize(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


class ShardingRules:
    """Immutable logical-dim → mesh-axes mapping plus profile flags."""

    __slots__ = ("_map", "_flags")

    def __init__(
        self,
        mapping: Mapping[str, Sequence[str]] | None = None,
        flags: Iterable[str] = (),
    ):
        base = dict(DEFAULT_RULES)
        if mapping:
            base.update({k: _normalize(v) for k, v in mapping.items()})
        object.__setattr__(self, "_map", base)
        object.__setattr__(self, "_flags", frozenset(flags))

    # -- derivation --------------------------------------------------------
    def override(self, **axes) -> "ShardingRules":
        """New rules with the given logical dims remapped.

        Values are mesh-axis tuples; a bare string means a 1-tuple and
        ``()``/``None`` means replicated.
        """
        new = dict(self._map)
        new.update({k: _normalize(v) for k, v in axes.items()})
        return ShardingRules(new, self._flags)

    def with_flags(self, flags: Iterable[str]) -> "ShardingRules":
        return ShardingRules(self._map, self._flags | set(flags))

    # -- queries -----------------------------------------------------------
    def axes_for(self, name: str) -> tuple[str, ...]:
        return self._map.get(name, ())

    def has(self, flag: str) -> bool:
        return flag in self._flags

    @property
    def flags(self) -> frozenset[str]:
        return self._flags

    def __eq__(self, other):
        return (
            isinstance(other, ShardingRules)
            and self._map == other._map
            and self._flags == other._flags
        )

    def __hash__(self):
        return hash((tuple(sorted(self._map.items())), self._flags))

    def __repr__(self):
        non_default = {
            k: v for k, v in self._map.items() if DEFAULT_RULES.get(k, ()) != v
        }
        return f"ShardingRules({non_default}, flags={sorted(self._flags)})"


def _mesh_sizes(mesh) -> dict[str, int]:
    """Axis name → size of a mesh-like object: ``mesh.shape`` is either a
    mapping (a JAX mesh's) or a tuple in the order of ``mesh.axis_names``
    (``launch.mesh.RankMesh``'s)."""
    if isinstance(mesh.shape, Mapping):
        return {k: int(v) for k, v in mesh.shape.items()}
    return {ax: int(n) for ax, n in zip(mesh.axis_names, mesh.shape)}


def spec_for(mesh, rules: ShardingRules | None, dims, shape=None) -> tuple:
    """Lower a logical dims-tuple to a partition spec on ``mesh``.

    ``dims`` entries are logical names or ``None`` (explicitly replicated).
    ``shape`` (optional) enables the divisibility check: a mesh axis is
    applied to dim ``i`` only if ``shape[i]`` is divisible by the product of
    the axis sizes applied so far times this axis's size. Only the mesh's
    axis names and sizes are consulted, so any mesh-like object works.
    """
    if rules is None:
        rules = ShardingRules()
    mesh_sizes = _mesh_sizes(mesh)
    used: set[str] = set()
    entries = []
    for i, name in enumerate(dims):
        if name is None:
            entries.append(None)
            continue
        chosen: list[str] = []
        prod = 1
        cap = None if shape is None else int(shape[i])
        for ax in rules.axes_for(name):
            if ax not in mesh_sizes or ax in used:
                continue
            size = mesh_sizes[ax]
            if cap is not None and cap % (prod * size) != 0:
                continue
            chosen.append(ax)
            used.add(ax)
            prod *= size
        if not chosen:
            entries.append(None)
        elif len(chosen) == 1:
            entries.append(chosen[0])
        else:
            entries.append(tuple(chosen))
    return tuple(entries)


def named_sharding(mesh, rules: ShardingRules | None, dims, shape=None):
    """Placing an array by its spec across devices: not ported (one card
    holds every array whole)."""
    raise NotImplementedError(f"named_sharding waits for {_DEVICE_HALF}")


def constrain(x, mesh, rules: ShardingRules | None, dims):
    """A sharding constraint on an array across devices: not ported (one
    card holds every array whole; ``models.layers.Ctx.cons`` is the
    identity there)."""
    raise NotImplementedError(f"constrain waits for {_DEVICE_HALF}")
