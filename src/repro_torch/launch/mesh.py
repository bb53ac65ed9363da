"""A mesh of ranks, and the network topology a mesh's encode axes imply.

The counterpart of the reference's ``launch/mesh.py``. There a mesh is a
``jax.sharding.Mesh`` of devices and one program runs across it; here it is
a :class:`RankMesh` over the processes of a ``torch.distributed`` group, one
processor a process, each running its own copy of the program (the
executors of :mod:`repro_torch.dist.ranks`).

Ranks are laid out row-major over the mesh's axes, outermost first: the
group's rank ``r`` sits at the coordinates ``np.unravel_index(r, shape)``.
A processor's index over some of the axes (:meth:`RankMesh.index`) is the
row-major index of its coordinates on those axes, in the order they are
named — exactly how the reference's ``P(axes)`` flattens the packet
dimension onto a mesh.

:func:`production_topology` keeps the reference's model of the production
TPU pods' encode domain (its values are the reference's, not measured on any
GPU); ``make_production_mesh`` and the sharding rules wait for the sharding
substrate (ROADMAP A3).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from ..core.field import resolve_device
from ..topo import Hierarchy


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This process's view of a mesh of ranks.

    ``group`` is the process group whose ranks fill the mesh, ``shape`` and
    ``axis_names`` its axes outermost first, ``rank`` this process's flat
    (row-major) position in it and ``coords`` its coordinates, ``ranks``
    the global rank at each flat position, and ``device`` where this rank
    computes."""

    group: object
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: int
    coords: tuple[int, ...]
    ranks: tuple[int, ...]
    device: torch.device
    _axis_groups: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def _dims(self, axes) -> tuple[int, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for ax in axes:
            if ax not in self.axis_names:
                raise ValueError(f"axis {ax!r} is not one of the mesh's {self.axis_names}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} name an axis twice")
        return tuple(self.axis_names.index(ax) for ax in axes)

    def axis_size(self, axis: str) -> int:
        return self.shape[self._dims(axis)[0]]

    def size(self, axes) -> int:
        """Processors over ``axes``: the product of their sizes."""
        return math.prod(self.shape[d] for d in self._dims(axes))

    def index(self, axes) -> int:
        """This rank's processor index over ``axes`` (row-major, in the
        order named)."""
        dims = self._dims(axes)
        return int(np.ravel_multi_index([self.coords[d] for d in dims], [self.shape[d] for d in dims]))

    def peer(self, axes, j: int) -> int:
        """The global rank of processor ``j`` over ``axes`` among the ranks
        that share this rank's coordinates on the other axes."""
        dims = self._dims(axes)
        coords = list(self.coords)
        for d, c in zip(dims, np.unravel_index(j, [self.shape[d] for d in dims])):
            coords[d] = int(c)
        return self.ranks[int(np.ravel_multi_index(coords, self.shape))]

    def axis_group(self, axes):
        """The process group of the processors over ``axes`` that this rank
        belongs to. Every subgroup of these axes is created at the first call
        — a collective call: every rank of the mesh makes it, in the same
        order — and kept."""
        dims = self._dims(axes)
        if sorted(dims) == list(range(len(self.shape))):
            return self.group
        if dims not in self._axis_groups:
            mine = None
            others = [d for d in range(len(self.shape)) if d not in dims]
            backend = dist.get_backend(self.group)
            for rest in np.ndindex(*[self.shape[d] for d in others]):
                members = []
                for j in range(self.size(axes)):
                    coords = [0] * len(self.shape)
                    for d, c in zip(others, rest):
                        coords[d] = int(c)
                    for d, c in zip(dims, np.unravel_index(j, [self.shape[d] for d in dims])):
                        coords[d] = int(c)
                    members.append(self.ranks[int(np.ravel_multi_index(coords, self.shape))])
                g = dist.new_group(members, backend=backend)
                if all(self.coords[d] == c for d, c in zip(others, rest)):
                    mine = g
            self._axis_groups[dims] = mine
        return self._axis_groups[dims]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, group=None, device=None) -> RankMesh:
    """The mesh of ``shape`` with axis names ``axes`` over the ranks of
    ``group`` (``None``: the default group, which must be initialised), as
    seen from this process; ``device`` is where this rank computes
    (``None``: the card)."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes} name an axis twice")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    group = dist.group.WORLD if group is None else group
    n = dist.get_world_size(group)
    if math.prod(shape) != n:
        raise ValueError(f"mesh {shape} holds {math.prod(shape)} ranks, the group has {n}")
    rank = dist.get_rank(group)
    ranks = tuple(dist.get_global_rank(group, i) for i in range(n))
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    return RankMesh(group, shape, axes, rank, coords, ranks, resolve_device(device))


def production_topology(*, multi_pod: bool = False) -> Hierarchy:
    """The reference's model of the production mesh's DP-replica encode
    domain (TPU pods, not measured here): 16 replicas a pod, 4 a slice, so
    chip < slice (< pod) — ``Hierarchy(levels=(4, 4))`` for one pod (K = 16),
    ``(4, 4, 2)`` for two (K = 32)."""
    return Hierarchy(levels=(4, 4, 2) if multi_pod else (4, 4))


def mesh_encode_levels(mesh: RankMesh, axes) -> tuple[int, ...]:
    """Innermost-first level sizes of an encode domain spanning ``axes``
    (given outermost → innermost, the order ``multilevel_encode_ranks``
    takes)."""
    return tuple(mesh.axis_size(a) for a in reversed(tuple(axes)))


def topology_for_mesh(mesh: RankMesh, axes) -> Hierarchy:
    """The :class:`Hierarchy` a mesh's encode axes imply (outermost axis =
    slowest level)."""
    return Hierarchy(levels=mesh_encode_levels(mesh, axes))
