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
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..coded.rs_checkpoint import (
    ParityPlan,
    build_parity_plan,
    encode_parity,
    recover_lost,
    shard_state_limbs,
    unshard_state_limbs,
)
from ..core.field import resolve_device, to_numpy, to_tensor
from .train_loop import place


@dataclass
class CodedStateGuard:
    """Parity of a state pytree across K replicas. The limbs and the parity
    are computed on ``device`` (``None``: the card; ``"cpu"`` runs the plain
    path) and copied to the host, where recovery runs in numpy."""

    K: int
    p: int = 1
    plan: ParityPlan = None  # type: ignore
    device: object = None
    _shards: np.ndarray | None = None
    _parity: np.ndarray | None = None
    _meta: object = None
    step: int = -1

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.plan is None:
            self.plan = build_parity_plan(self.K, self.p)

    def snapshot(self, state, step: int):
        """Encode parity of the current state (call every coded_every steps)."""
        shards, meta = shard_state_limbs(state, self.K, self.device)
        parity = encode_parity(shards, self.plan)
        self._shards = to_numpy(shards)
        self._parity = to_numpy(parity)
        self._meta = meta
        self.step = step

    def fail_and_recover(self, lost: list[int]):
        """Simulate losing `lost` replicas (their x AND parity shards) and
        rebuild the full state bit-exactly from the survivors, on the
        guard's device. Returns ``(state, step of the snapshot)``."""
        if self._shards is None:
            raise RuntimeError("no snapshot taken")
        surv_x = {k: self._shards[k] for k in range(self.K) if k not in lost}
        surv_p = {k: self._parity[k] for k in range(self.K) if k not in lost}
        rec = recover_lost(self.plan, lost, surv_x, surv_p)
        full = self._shards.copy()
        for k in lost:
            full[k] = rec[k]
        return unshard_state_limbs(to_tensor(full, self.device), self._meta), self.step

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
