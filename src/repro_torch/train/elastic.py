"""Failure recovery orchestration.

Two recovery tiers (DESIGN §8):

1. **Coded fast path** — ``CodedStateGuard`` keeps a Cauchy parity of the
   full training state across K logical DP replicas (one all-to-all encode,
   C2 = Θ(√K/p)); any ≤ K−1 simultaneously lost replicas are rebuilt
   bit-exactly from survivors without touching disk.
2. **Disk slow path** — ``checkpoint.save_checkpoint`` /
   ``restore_checkpoint``, which restores under other shardings too, and
   :func:`reshard_state`, which re-places a live state under new shardings
   (elastic scaling, possibly onto another mesh of the same group).

Here the "replicas" are logical: the state is sharded into K limb shards on
one device and the parity is encoded there
(``coded.rs_checkpoint.encode_parity``); on a cluster the same arrays live on
distinct hosts and the encode runs across them
(``encode_parity_collective``).

A state on a mesh of ranks (``DTensor`` leaves, as ``launch/train.py
--mesh`` holds it) is snapshotted by every rank of the mesh together: the
leaves are gathered one at a time to the mesh's first rank, which alone
builds the limbs and encodes the parity; every other rank keeps only the
snapshot's step and the limbs' layout. :meth:`CodedStateGuard.fail_and_recover`
is then a collective call too: the first rank rebuilds the whole state and
sends it to every rank, which places it back on the mesh with
:func:`reshard_state`.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..coded.rs_checkpoint import (
    ParityPlan,
    broadcast_state,
    build_parity_plan,
    encode_parity,
    encode_state,
    gather_state,
    mesh_group,
    on_root,
    recover_lost,
    state_meta,
    unshard_state_limbs,
)
from ..core.field import resolve_device, to_tensor
from .train_loop import place

#: host bytes a snapshot leaves free beside its new arrays and the last
#: snapshot's, for the rest of the process while it copies
HOST_MARGIN = 4 << 30
#: where the host's available memory is read
MEMINFO = "/proc/meminfo"


def host_holds_both(new_bytes: int) -> tuple[bool, int | None]:
    """``(keep, available)``: whether the host can make a snapshot's new
    arrays (``new_bytes``) while the last snapshot's arrays stay, read as
    ``MemAvailable`` from ``MEMINFO`` (``available``, bytes) less
    ``HOST_MARGIN``. Where it cannot be read, ``(True, None)``: the last
    snapshot is kept, as the reference keeps it."""
    try:
        with open(MEMINFO) as f:
            line = next(line for line in f if line.startswith("MemAvailable:"))
        available = int(line.split()[1]) * 1024
    except (OSError, StopIteration, ValueError, IndexError):
        return True, None
    return new_bytes <= available - HOST_MARGIN, available


@dataclass
class CodedStateGuard:
    """Parity of a state pytree across K replicas. The limbs and the parity
    are computed on ``device`` (``None``: the card; ``"cpu"`` runs the plain
    path) block of columns by block (``coded.rs_checkpoint.encode_state``)
    and each block copied to the host, where recovery runs in numpy: a
    snapshot adds one block's working set on the device. On a state
    on a mesh of ranks, ``_shards`` and ``_parity`` are held by the mesh's
    first rank alone (see the module's docstring)."""

    K: int
    p: int = 1
    plan: ParityPlan = None  # type: ignore
    device: object = None
    _shards: np.ndarray | None = None
    _parity: np.ndarray | None = None
    _meta: object = None
    step: int = -1
    #: (process group, encoding rank) of the last snapshot's mesh, or None
    _mesh: tuple | None = None
    #: whether the guard has warned that it drops the last snapshot first
    _warned: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.plan is None:
            self.plan = build_parity_plan(self.K, self.p)

    def snapshot(self, state, step: int):
        """Encode parity of the current state (call every coded_every steps).
        On a state on a mesh of ranks every rank of the mesh calls it. The
        guard takes the new snapshot once its encode has returned, so a
        snapshot that raises keeps the last one (on a mesh it raises on every
        rank, and every rank keeps it). Only where the host cannot hold the
        new host arrays beside the last ones (:func:`host_holds_both`, asked
        on the encoding rank and told to every rank) are the last ones
        dropped first, with a ``RuntimeWarning`` once a guard: a snapshot
        that raises then leaves no recovery point (``step`` -1 on every
        rank)."""
        mesh = mesh_group(state)
        meta = state_meta(state)
        root = None if mesh is None else mesh[1]
        if self.step >= 0 and not self._keep_last(meta, mesh):
            self._shards = self._parity = None
            self.step = -1

        def encode(whole):
            return encode_state(whole, self.K, self.device, lambda x: encode_parity(x, self.plan), keep_limbs=True)

        if mesh is None:
            shards, parity, meta = encode(state)
        else:
            whole = gather_state(state, keep=dist.get_rank() == root)
            done = on_root(lambda: encode(whole), mesh[0], root, what="the coded snapshot")
            del whole
            shards, parity = (None, None) if done is None else done[:2]
        self._shards, self._parity, self._meta, self._mesh, self.step = shards, parity, meta, mesh, step

    def _keep_last(self, meta, mesh) -> bool:
        """Whether the last snapshot stays while the new one is made: the
        encoding rank's :func:`host_holds_both` on the new arrays' bytes (the
        limbs and the parity, 2 × K × S ``uint32``), told to every rank of
        ``mesh``. Warns once a guard where it does not."""
        K = self.K
        need = 2 * K * (-(-meta.total // K)) * 4
        keep, available = True, None
        if mesh is None or dist.get_rank() == mesh[1]:
            keep, available = host_holds_both(need)
        if mesh is not None:
            told = torch.tensor([int(keep), -1 if available is None else available], dtype=torch.int64)
            dist.broadcast(told, src=mesh[1], group=mesh[0])
            keep, available = bool(told[0]), None if told[1] < 0 else int(told[1])
        if not keep and not self._warned:
            self._warned = True
            where = "" if available is None else f" beside {available:,} bytes available"
            warnings.warn(f"CodedStateGuard: the host cannot hold a snapshot's new {need:,} bytes{where} "
                          f"while keeping the last one: it is dropped first, and a snapshot that raises "
                          f"leaves no recovery point", RuntimeWarning, stacklevel=3)
        return keep

    def fail_and_recover(self, lost: list[int]):
        """Simulate losing `lost` replicas (their x AND parity shards) and
        rebuild the full state bit-exactly from the survivors, on the
        guard's device. Returns ``(state, step of the snapshot)``, the state
        whole: after a snapshot of a state on a mesh of ranks every rank
        calls it and gets the whole state (:func:`reshard_state` puts it
        back on the mesh)."""
        if self._mesh is not None:
            group, root = self._mesh
            whole = on_root(lambda: self._recover(lost), group, root)
            return broadcast_state(whole, self._meta, group, root, self.device), self.step
        return self._recover(lost), self.step

    def _recover(self, lost: list[int]):
        if self._shards is None:
            raise RuntimeError("no snapshot taken")
        surv_x = {k: self._shards[k] for k in range(self.K) if k not in lost}
        surv_p = {k: self._parity[k] for k in range(self.K) if k not in lost}
        rec = recover_lost(self.plan, lost, surv_x, surv_p)
        full = self._shards.copy()
        for k in lost:
            full[k] = rec[k]
        return unshard_state_limbs(to_tensor(full, self.device), self._meta)

    @property
    def overhead_elements(self) -> int:
        """Parity memory overhead per replica, in limbs (= 1/K of state)."""
        return 0 if self._parity is None else int(self._parity.shape[1])


def reshard_state(state, shardings):
    """Elastic re-placement of a state pytree under new shardings (one
    ``dist.sharding.NamedSharding`` a leaf): a DTensor leaf on the same mesh
    is redistributed, one on another mesh of the same group goes through its
    full tensor, a plain tensor is the full tensor. The values are
    unchanged, bit for bit. A collective call when a leaf moves."""
    return place(state, shardings)
