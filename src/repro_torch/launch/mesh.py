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

Each mesh also carries the ``torch.distributed.device_mesh.DeviceMesh`` of
its ranks (same axis names, shape and row-major order, on the rank's device
type): the mesh the sharding substrate places DTensors on
(:mod:`repro_torch.dist.sharding`). The rank executors and the sharding
functions take the same :class:`RankMesh`.

:func:`make_production_mesh` is the reference's production mesh over a
group of 256 (512) ranks; :func:`production_topology` keeps the reference's
model of the production TPU pods' encode domain (its values are the
reference's, not measured on any GPU).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.field import resolve_device
from ..topo import Hierarchy


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This process's view of a mesh of ranks.

    ``group`` is the process group whose ranks fill the mesh, ``shape`` and
    ``axis_names`` its axes outermost first, ``rank`` this process's flat
    (row-major) position in it and ``coords`` its coordinates, ``ranks``
    the global rank at each flat position, ``device`` where this rank
    computes and ``device_mesh`` the DeviceMesh of the same ranks (``None``
    for a mesh made by hand, with no process group)."""

    group: object
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: int
    coords: tuple[int, ...]
    ranks: tuple[int, ...]
    device: torch.device
    device_mesh: DeviceMesh | None = dataclasses.field(default=None, compare=False, repr=False)
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


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, group=None, device=None,
              device_type: str = "cuda") -> RankMesh:
    """The mesh of ``shape`` with axis names ``axes`` over the ranks of
    ``group`` (``None``: the default group, which must be initialised), as
    seen from this process; ``device`` is where this rank computes
    (``None``: the card; ``"meta"``: nowhere, the dry run's shapes-only
    mesh over ``dist.counting.fake_world``, whose ``DeviceMesh`` is of
    ``device_type``: the ranks it stands for, ``"cuda"`` cards or ``"cpu"``
    gloo ranks, on which DTensor runs a shard-to-shard step as an
    all-gather and a chunk instead of an all-to-all). Builds the mesh's
    ``DeviceMesh`` (a collective call: every rank of the group makes it),
    whose one-axis groups the mesh's :meth:`RankMesh.axis_group` then
    reuses."""
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
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device() if device.index is None else device.index)
        # a rank on an initialised device keeps it: DeviceMesh would otherwise
        # pick one from LOCAL_RANK, and every rank here shares one card
        torch.cuda.set_device(device)
        torch.cuda.init()
    # a ``meta`` mesh (the dry run's) is a mesh of the ranks' type whose
    # DTensors hold ``meta`` blocks
    dm = DeviceMesh(device_type if device.type == "meta" else device.type, torch.tensor(ranks).reshape(shape),
                    mesh_dim_names=axes)
    mesh = RankMesh(group, shape, axes, rank, coords, ranks, device, dm)
    if len(shape) > 1:
        mesh._axis_groups.update({(d,): dm.get_group(d) for d in range(len(shape))})
    return mesh


def make_production_mesh(*, multi_pod: bool = False, group=None, device=None) -> RankMesh:
    """The reference's production mesh: (data=16, model=16) over 256 ranks,
    or (pod=2, data=16, model=16) over 512. On a group of another size it
    raises ``ValueError`` naming the size it needs (as ``jax.make_mesh``
    fails for want of devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialised torch.distributed process group")
    n = dist.get_world_size(dist.group.WORLD if group is None else group)
    if n != math.prod(shape):
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs a group of {math.prod(shape)} "
                         f"ranks; this group has {n}")
    return make_mesh(shape, axes, group=group, device=device)


#: the dry run's production meshes: tag → ``multi_pod`` (the reference's tags)
PRODUCTION_MESHES = {"pod16x16": False, "pod2x16x16": True}


def production_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


@functools.cache
def dryrun_mesh(multi_pod: bool) -> RankMesh:
    """The production mesh of the dry run, built once a process: this
    process made rank 0 of a fake world of 256 (512) ranks
    (``dist.counting.fake_world``; a process in another world raises) and
    the mesh over it on the ``meta`` device, standing for cards."""
    from ..dist.counting import fake_world

    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device="meta")


#: how long a rank of a launcher's mesh waits for its peers before it fails
GROUP_TIMEOUT_S = 300


def parse_mesh(spec: str) -> tuple[int, int]:
    """``"DxM"`` → (D, M)."""
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: expected DATAxMODEL, e.g. 2x2") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec!r}: both sizes must be positive")
    return d, m


def launcher_mesh(spec: str, device) -> tuple[RankMesh | None, bool]:
    """The (data, model) mesh a launcher's ``--mesh DxM`` asks for, over
    the world ``torchrun`` starts (``RANK`` and ``WORLD_SIZE`` in the
    environment), and whether this call joined the world. ``1x1`` is no
    mesh. An already initialised default group is used as it is; otherwise
    the group is joined over the port's staging backend on a CUDA device
    (``dist.staging``) and gloo on the CPU. A mesh whose size differs from
    the world size raises ``ValueError``."""
    d, m = parse_mesh(spec)
    if d * m == 1:
        return None, False
    joined = False
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise ValueError(f"--mesh {spec} needs {d * m} ranks: run it under "
                             f"torchrun --nproc-per-node {d * m}")
        backend = "gloo"
        if device.type == "cuda":
            from ..dist.staging import BACKEND, register

            register()
            backend = BACKEND
        dist.init_process_group(backend, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        joined = True
    n = dist.get_world_size()
    if n != d * m:
        if joined:
            dist.destroy_process_group()
        raise ValueError(f"--mesh {spec} holds {d * m} ranks; the world has {n}")
    return make_mesh((d, m), ("data", "model"), device=device), joined


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
