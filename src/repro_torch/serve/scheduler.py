"""Slot-based continuous-batching scheduler (host-side, framework-free).

The decode batch is a fixed pool of ``n_slots`` slots. Requests enter a
FIFO queue stamped with an arrival time; ``next_assignment`` hands out
(slot, request) pairs whenever a slot is free AND the head of the queue
has arrived — so a finished slot is refilled mid-decode without draining
the rest of the batch. The scheduler is pure bookkeeping (no torch): the
engine owns the device state and calls back in at retire/assign points,
which keeps this logic unit-testable without a model.

Slot lifecycle::

    FREE --assign--> OCCUPIED --retire (EOS / max-tokens)--> FREE

Prefill length bucketing lives here too: ``bucket_for(plen, buckets)``
rounds a prompt length up to the next bucket so the number of prefill
callables (compiled graphs in the reference) is bounded by
``len(buckets)`` instead of one per distinct prompt length.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

#: default prefill length buckets (right-pad the prompt to the next one)
DEFAULT_BUCKETS = (32, 64, 128, 256)


def bucket_for(plen: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket ≥ plen. Raises if the prompt outgrows every bucket
    (pick buckets that cover the workload's max prompt length)."""
    if plen < 1:
        raise ValueError(f"prompt length must be ≥ 1, got {plen}")
    for b in sorted(buckets):
        if plen <= b:
            return int(b)
    raise ValueError(
        f"prompt length {plen} exceeds largest prefill bucket {max(buckets)}"
    )


@dataclass
class Request:
    """One serving request: a prompt, a generation budget, and the time it
    arrives (seconds, relative to serve start — 0 means 'already queued')."""

    id: str
    prompt: list[int]
    max_new_tokens: int = 16
    arrival_s: float = 0.0
    #: per-request sampling stream (None derives one from ``id``), so a
    #: request's sampled tokens never depend on batch composition
    seed: int | None = None


@dataclass
class RequestResult:
    """Per-request outcome: full token sequence (prompt + generated,
    EOS-trimmed) and the two latencies the harness reports."""

    id: str
    tokens: list[int]
    prompt_len: int
    gen_len: int
    ttft_s: float
    e2e_s: float

    @property
    def length(self) -> int:
        return self.prompt_len + self.gen_len


@dataclass
class _Slot:
    request: Request
    started_s: float


class SlotScheduler:
    """Fixed pool of decode slots + FIFO arrival queue.

    The engine drives it: ``submit`` requests, then alternate
    ``next_assignment(now)`` (claims a free slot for the oldest arrived
    request) with ``retire(slot)`` (frees a slot whose sequence finished).
    ``occupied`` / ``has_work`` expose the state the serve loop needs for
    occupancy accounting and termination.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self._slots: list[_Slot | None] = [None] * n_slots
        self._queue: deque[Request] = deque()

    # -- queue side ---------------------------------------------------------
    def submit(self, request: Request) -> None:
        self._queue.append(request)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def next_arrival_s(self) -> float | None:
        """Arrival time of the queue head (None if the queue is empty)."""
        return self._queue[0].arrival_s if self._queue else None

    # -- slot side ----------------------------------------------------------
    @property
    def occupied(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    @property
    def free(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def request_in(self, slot: int) -> Request:
        s = self._slots[slot]
        assert s is not None, f"slot {slot} is free"
        return s.request

    def next_assignment(self, now_s: float) -> tuple[int, Request] | None:
        """Claim the lowest free slot for the oldest ARRIVED request; None
        if no slot is free or the queue head hasn't arrived yet."""
        if not self._queue or self._queue[0].arrival_s > now_s:
            return None
        free = self.free
        if not free:
            return None
        req = self._queue.popleft()
        slot = free[0]
        self._slots[slot] = _Slot(request=req, started_s=now_s)
        return slot, req

    def retire(self, slot: int) -> Request:
        s = self._slots[slot]
        assert s is not None, f"retiring free slot {slot}"
        self._slots[slot] = None
        return s.request
