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
the reference.

The device half places tensors by a spec on the ranks of a
:class:`~repro_torch.launch.mesh.RankMesh` as DTensors
(``torch.distributed.tensor``, PyTorch's form of GSPMD) over the mesh's
``DeviceMesh``. :func:`named_sharding` lowers a spec to DTensor placements,
one a mesh dim: a tensor dim that names an axis is ``Shard(dim)`` on that
axis's mesh dim, every other mesh dim ``Replicate()``. A spec entry that
names several axes (``("pod", "data")``) shards its dim over each of them;
DTensor lays such a dim out in the mesh's axis order, so a rank's block can
differ from the reference's where a spec names the axes out of mesh order
(the full tensor is the same). :func:`constrain` is the reference's
``with_sharding_constraint``: a ``redistribute`` of a DTensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

__all__ = ["ShardingRules", "NamedSharding", "spec_for", "spec_of", "placements_for", "named_sharding", "constrain",
           "DEFAULT_RULES"]


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


def is_dims(x) -> bool:
    """A leaf of a logical-dims tree: a tuple of names and ``None``s (the
    reference's ``is_leaf``); a tuple of such tuples (a Mamba state's dims)
    is a container."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


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


def placements_for(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``'s dims: ``Shard(i)`` on the
    mesh dim of every axis that tensor dim ``i`` names, ``Replicate()`` on
    the rest."""
    out: list = [Replicate()] * len(mesh.axis_names)
    for i, entry in enumerate(spec):
        for ax in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            out[mesh.axis_names.index(ax)] = Shard(i)
    return tuple(out)


def spec_of(t: DTensor, mesh) -> tuple:
    """The spec of a DTensor's placements on ``mesh`` (the inverse of
    :func:`placements_for`)."""
    entries: list[list[str]] = [[] for _ in range(t.ndim)]
    for ax, pl in zip(mesh.axis_names, t.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(ax)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh of ranks (the reference's
    ``jax.sharding.NamedSharding``): ``spec`` as :func:`spec_for` gives it,
    ``placements`` the DTensor placements it lowers to."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_for(self.mesh, self.spec)

    def place(self, t: torch.Tensor):
        """``t`` as a DTensor under this sharding, on the mesh's device.

        A plain tensor is the full tensor, the same on every rank (drawn
        from one seed): each rank keeps its own block, and nothing is sent
        (``src_data_rank=None``). A DTensor of this mesh is redistributed;
        one of another mesh of the same group goes through its full
        tensor."""
        if isinstance(t, DTensor):
            if t.device_mesh == self.mesh.device_mesh:
                pl = self.placements
                return t if tuple(t.placements) == pl else t.redistribute(self.mesh.device_mesh, pl)
            t = t.full_tensor()
        return distribute_tensor(t.to(self.mesh.device), self.mesh.device_mesh, self.placements, src_data_rank=None)


class _WholeGrad(torch.autograd.Function):
    """The identity, whose gradient leaves with no pending partial sum: a
    partial gradient summed with a split one would need a split-to-partial
    redistribution, which DTensor refuses (torch 2.11)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and any(p.is_partial() for p in g.placements):
            g = g.redistribute(g.device_mesh, [Replicate() if p.is_partial() else p for p in g.placements])
        return g


def whole_grad(x):
    """``x`` (a DTensor that takes part in a gradient) with its gradient's
    pending sums completed on the way back; anything else as it is."""
    return _WholeGrad.apply(x) if isinstance(x, DTensor) and x.requires_grad else x


def named_sharding(mesh, rules: ShardingRules | None, dims, shape=None) -> NamedSharding:
    """The :class:`NamedSharding` of a logical dims-tuple (see
    :func:`spec_for`)."""
    return NamedSharding(mesh, spec_for(mesh, rules, dims, shape))


def constrain(x, mesh, rules: ShardingRules | None, dims):
    """The reference's ``with_sharding_constraint`` against the logical dims
    of ``x``: a DTensor is redistributed to the placements of its dims on
    ``mesh``. Its own shape drives the divisibility check, so a constraint
    never fails for a shape — worst case it replicates. A plain tensor, and
    any tensor on a mesh of one rank, is returned as it is."""
    if not isinstance(x, DTensor) or mesh is None or mesh.device_mesh.size() == 1:
        return x
    if any(p.is_partial() for p in x.placements):
        # a pending sum is completed first: the gradient of a partial sum
        # reduced straight into a split dim would be a split-to-partial
        # redistribution, which DTensor refuses (torch 2.11)
        x = x.redistribute(mesh.device_mesh, [Replicate() if p.is_partial() else p for p in x.placements])
    return whole_grad(x.redistribute(mesh.device_mesh, named_sharding(mesh, rules, dims, x.shape).placements))
