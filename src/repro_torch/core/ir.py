"""Unified ScheduleIR: ONE round-schedule representation for every encode
algorithm.

The paper's central observation is that a single universal round structure
computes any generator matrix by only varying intermediate coefficients.
This module makes that structure a first-class compiler artifact: every
schedule plan (prepare-shoot, butterfly, draw-loose, allgather, ring,
hierarchical, multilevel, two-level/multi-level DFT) **compiles to** the same
IR via a per-family ``plan.to_ir()`` lowering, and everything downstream —
simulation (``core.simulator.interpret``), message-map lowering and α-β
pricing (by a topology model), and execution
(``repro_torch.dist.collectives.ir_encode``) — consumes the IR generically. Adding an
algorithm is now ONE compile function instead of four implementations.

The IR is a straight-line program over ``K`` processors, each holding a
slot-indexed buffer of field elements. Processor ``k`` starts with its packet
in slot ``INPUT_SLOT`` and must end with its encode output in slot
``ScheduleIR.out_slot``. Two step kinds alternate freely:

* :class:`CommRound` — one synchronous p-port communication round: a set of
  :class:`Transfer` records. A transfer ships the source slots of its
  ``slots`` selector from ``src`` to ``dst``; the receiver multiplies each
  element by the matching ``coeffs`` entry (1 when absent) and either
  accumulates into (``mode="add"``) or overwrites (``mode="store"``) the
  destination slot. All sends read the pre-round buffer (synchronous
  semantics). ``port`` tags which of the sender's p ports carries the
  message — transfers sharing (port, slots, mode) form one uniform
  permutation, the unit a mesh executor turns into one ``ppermute``.
* :class:`LocalOp` — a per-processor linear contraction (no communication):
  the buffer is REPLACED by ``{out_slots[i]: Σ_j coeffs[k, i, j] ·
  buf[in_slots[j]]}``. This is where the generator-matrix coefficients live
  (w-variable initialization, butterfly twiddle combines, draw-phase scales);
  ``coeffs=None`` marks a structure-only IR (message maps derivable,
  interpretation not).

Rewrite passes operate on the IR: :func:`fuse_trivial_rounds` here (drop
empty rounds / no-op transfers / identity local ops — exactness is immediate
because every removed step is semantically the identity), and the
topology-aware relabelling passes built on :func:`relabel` (they arrive with
the topology layer of the port).

Paper-notation glossary: ``K`` processors, ``p`` ports per round, ``C1`` =
round count = number of CommRounds, ``C2`` = Σ over rounds of the largest
transfer's element count — both read off the IR by ``ir_messages``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .field import M31, Field
from .schedule import (
    ButterflyPlan,
    DrawLoosePlan,
    PrepareShootPlan,
    butterfly_group_perms,
    gather_rounds,
)

INPUT_SLOT = 0


@dataclass(frozen=True)
class Transfer:
    """One message of a communication round (see module doc)."""

    src: int
    dst: int
    port: int  # which of the sender's p ports carries this message
    slots: tuple[tuple[int, int], ...]  # (src_slot, dst_slot) pairs, wire order
    coeffs: tuple[int, ...] | None = None  # per-slot receive coefficient (None = 1s)
    mode: str = "add"  # "add": dst += c·v   |   "store": dst = c·v

    @property
    def elems(self) -> int:
        return len(self.slots)


@dataclass(frozen=True)
class CommRound:
    transfers: tuple[Transfer, ...]


@dataclass(frozen=True, eq=False)
class LocalOp:
    """buffer := {out_slots[i]: Σ_j coeffs[k, i, j] · buf[in_slots[j]]}
    (REPLACES the buffer; missing input slots read as 0).

    ``update=True`` switches to read-modify-write semantics: the op writes
    only its out_slots and every other live slot survives untouched — the
    form a software-pipelining rewrite needs for its combine
    steps (``o ← o + τ(o)``), which must not clobber in-flight slots.
    ``overlap=True`` marks an op whose inputs are independent of the NEXT
    comm round, i.e. the executor may run it concurrently with (or fused
    into the same dispatch as) that round's ppermute; it never changes the
    op's value semantics, only scheduling/pricing."""

    out_slots: tuple[int, ...]
    in_slots: tuple[int, ...]
    coeffs: np.ndarray | None  # (K, n_out, n_in) field elements; None = structure-only
    update: bool = False
    overlap: bool = False


@dataclass(frozen=True, eq=False)
class ScheduleIR:
    """A compiled round schedule (see module doc). ``placement`` maps logical
    processor k → executing device (None = identity); passes that relabel the
    machine (e.g. ``remap_digits``) compose it so inputs/outputs stay in
    logical order through :func:`~repro_torch.core.simulator.interpret`."""

    algorithm: str
    K: int
    p: int
    steps: tuple  # CommRound | LocalOp
    placement: tuple[int, ...] | None = None
    out_slot: int = 0

    def rounds(self):
        return [s for s in self.steps if isinstance(s, CommRound)]

    @property
    def c1(self) -> int:
        return len(self.rounds())

    @property
    def c2(self) -> int:
        return sum(
            max(t.elems for t in r.transfers) for r in self.rounds() if r.transfers
        )


def ir_messages(ir: ScheduleIR) -> list[dict]:
    """Per-round ``{(src, dst): elements}`` message maps — the SAME shape the
    cost-exact simulator records in ``SimStats.round_messages`` and
    a topology model prices."""
    out = []
    for r in ir.rounds():
        validate_round(r)
        out.append({(t.src, t.dst): t.elems for t in r.transfers})
    return out


def validate_round(rnd: CommRound) -> None:
    """The shared per-round well-formedness check (used by both the message
    deriver and the interpreter): no empty rounds (the §I model never
    schedules one — run fuse_trivial_rounds first) and at most one message
    per ordered (src, dst) pair."""
    if not rnd.transfers:
        raise ValueError(
            "empty communication round (the §I model never schedules one) "
            "— run fuse_trivial_rounds first"
        )
    seen = set()
    for t in rnd.transfers:
        if (t.src, t.dst) in seen:
            raise ValueError(
                f"two transfers share pair ({t.src}, {t.dst}) in one round"
            )
        seen.add((t.src, t.dst))


# ---------------------------------------------------------------------------
# port groups — the ppermute decomposition of a round
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class PortGroup:
    """Transfers of one round sharing (port, slots, mode): a (partial)
    permutation with uniform slot structure — exactly one ``ppermute``."""

    port: int
    slots: tuple[tuple[int, int], ...]
    mode: str
    pairs: tuple[tuple[int, int], ...]  # (src, dst)
    coeffs_by_dst: dict | None  # dst → per-slot coeff tuple (None = all 1)


def round_port_groups(rnd: CommRound) -> list[PortGroup]:
    grouped: dict = {}
    order = []
    for t in rnd.transfers:
        key = (t.port, t.slots, t.mode)
        if key not in grouped:
            grouped[key] = []
            order.append(key)
        grouped[key].append(t)
    out = []
    for key in order:
        ts = grouped[key]
        srcs = [t.src for t in ts]
        dsts = [t.dst for t in ts]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"port group {key[0]} is not a permutation")
        coeffs = None
        if any(t.coeffs is not None for t in ts):
            coeffs = {t.dst: t.coeffs for t in ts}
        out.append(
            PortGroup(
                port=key[0],
                slots=key[1],
                mode=key[2],
                pairs=tuple((t.src, t.dst) for t in ts),
                coeffs_by_dst=coeffs,
            )
        )
    return out


def ir_permute_count(ir: ScheduleIR) -> int:
    """Number of ppermutes a mesh executor needs: one per port group."""
    return sum(len(round_port_groups(r)) for r in ir.rounds())


# ---------------------------------------------------------------------------
# rewrite passes (topology-free)
# ---------------------------------------------------------------------------


def fuse_trivial_rounds(ir: ScheduleIR) -> ScheduleIR:
    """Drop no-op structure: transfers with no slots, rounds with no
    transfers (trivial levels lower to nothing), and identity LocalOps
    (out == in with an identity coefficient matrix — e.g. the all-ones
    twiddle of a trivial DFT level). A LocalOp REPLACES the buffer, so an
    identity op is only a no-op when every possibly-live slot is among its
    out_slots (otherwise it also truncates) — the pass tracks live slots
    and removes only provably-identity steps, keeping it exact by
    construction for ANY IR (asserted in tests/test_ir.py)."""
    steps = []
    live = {INPUT_SLOT}
    for step in ir.steps:
        if isinstance(step, CommRound):
            ts = tuple(t for t in step.transfers if t.slots)
            if ts:
                live |= {ds for t in ts for _, ds in t.slots}
                steps.append(CommRound(ts) if len(ts) != len(step.transfers) else step)
            continue
        if (
            step.coeffs is not None
            and step.out_slots == step.in_slots
            and (step.update or live <= set(step.out_slots))
            and np.array_equal(
                np.asarray(step.coeffs),
                np.broadcast_to(
                    np.eye(len(step.out_slots), dtype=np.uint64),
                    np.asarray(step.coeffs).shape,
                ),
            )
        ):
            continue  # identity contraction over every live slot
        live = live | set(step.out_slots) if step.update else set(step.out_slots)
        steps.append(step)
    return replace(ir, steps=tuple(steps))


def relabel(ir: ScheduleIR, perm) -> ScheduleIR:
    """Relabel the machine: processor k's program runs on device ``perm[k]``.
    Transfers move with their endpoints, LocalOp coefficient rows move with
    their processor, and ``placement`` composes so logical inputs/outputs are
    unchanged. The workhorse of layout passes."""
    perm = np.asarray(perm, dtype=np.int64)
    K = ir.K
    if sorted(perm.tolist()) != list(range(K)):
        raise ValueError("perm must be a permutation of range(K)")
    inv = np.empty(K, dtype=np.int64)
    inv[perm] = np.arange(K)
    steps = []
    for step in ir.steps:
        if isinstance(step, CommRound):
            steps.append(
                CommRound(
                    tuple(
                        replace(t, src=int(perm[t.src]), dst=int(perm[t.dst]))
                        for t in step.transfers
                    )
                )
            )
        else:
            coeffs = step.coeffs[inv] if step.coeffs is not None else None
            steps.append(replace(step, coeffs=coeffs))
    old = (
        np.asarray(ir.placement, dtype=np.int64)
        if ir.placement is not None
        else np.arange(K)
    )
    return replace(ir, steps=tuple(steps), placement=tuple(int(v) for v in perm[old]))


def round_writes(rnd: CommRound) -> set:
    """(processor, slot) pairs a round's deliveries write."""
    return {(t.dst, ds) for t in rnd.transfers for _, ds in t.slots}


def round_reads(rnd: CommRound) -> set:
    """(processor, slot) pairs a round's sends read."""
    return {(t.src, ss) for t in rnd.transfers for ss, _ in t.slots}


def round_hazard_free(rnd: CommRound) -> bool:
    """True when no transfer reads a (processor, slot) that any delivery of
    the same round writes. Synchronous semantics make the round's result
    order-independent across sub-round boundaries exactly in this case, so a
    hazard-free round may be split into sub-rounds (each send still reads the
    value it read before) without changing the computed function."""
    return not (round_writes(rnd) & round_reads(rnd))


def merge_comm_rounds(a: CommRound, b: CommRound, p: int) -> CommRound | None:
    """Merge two adjacent rounds into one, or return None when the merge
    would change semantics or break the p-port model. Legal iff:

    * no RAW hazard — nothing ``b`` sends reads a slot ``a`` delivers into
      at the sender (in the merged round b's sends read the PRE-round buffer,
      while originally they read the post-``a`` buffer);
    * no (src, dst) pair repeats across the two rounds;
    * per-processor send and receive counts of the union stay ≤ p.

    ``b``'s ports are retagged past ``a``'s so port groups (and hence the
    executor's ppermute count) are preserved; delivery order (a's transfers
    first) matches the original two-round order, so store/add overwrite
    semantics at shared destination slots are unchanged."""
    if round_reads(b) & round_writes(a):
        return None
    pairs = [(t.src, t.dst) for t in a.transfers] + [
        (t.src, t.dst) for t in b.transfers
    ]
    if len(set(pairs)) != len(pairs):
        return None
    sends: dict = {}
    recvs: dict = {}
    for s, d in pairs:
        sends[s] = sends.get(s, 0) + 1
        recvs[d] = recvs.get(d, 0) + 1
    if max(sends.values()) > p or max(recvs.values()) > p:
        return None
    off = max(t.port for t in a.transfers)
    retagged = tuple(replace(t, port=t.port + off) for t in b.transfers)
    return CommRound(a.transfers + retagged)


# ---------------------------------------------------------------------------
# subgroup embedding (draw-loose, two-level/multi-level DFT stages)
# ---------------------------------------------------------------------------


def embed_parallel(sub: ScheduleIR, K: int, maps) -> list:
    """Embed disjoint parallel copies of ``sub`` (one per index map in
    ``maps``: local index → global processor) into a K-processor step list,
    merged round-by-round — parallel subgroups share rounds, exactly the
    paper's §V-B composition. LocalOps must cover every processor (the maps
    partition range(K))."""
    maps = [np.asarray(m, dtype=np.int64) for m in maps]
    seen = np.concatenate(maps) if maps else np.empty(0, np.int64)
    if sorted(seen.tolist()) != list(range(K)):
        raise ValueError("maps must partition range(K)")
    if sub.placement is not None:
        raise ValueError("cannot embed an already-placed IR")
    steps: list = []
    for step in sub.steps:
        if isinstance(step, CommRound):
            transfers = []
            for gmap in maps:
                for t in step.transfers:
                    transfers.append(
                        replace(t, src=int(gmap[t.src]), dst=int(gmap[t.dst]))
                    )
            steps.append(CommRound(tuple(transfers)))
        else:
            coeffs = None
            if step.coeffs is not None:
                coeffs = np.zeros(
                    (K,) + step.coeffs.shape[1:], dtype=step.coeffs.dtype
                )
                for gmap in maps:
                    coeffs[gmap] = step.coeffs
            steps.append(replace(step, coeffs=coeffs))
    return steps


# ---------------------------------------------------------------------------
# per-family compilers (core plans)
# ---------------------------------------------------------------------------


def to_ir(plan, **kw) -> ScheduleIR:
    """Generic dispatch: every schedule plan carries its own ``to_ir``."""
    fn = getattr(plan, "to_ir", None)
    if fn is None:
        raise TypeError(f"{type(plan).__name__} does not compile to ScheduleIR")
    return fn(**kw)


def ir_prepare_shoot(
    plan: PrepareShootPlan, A=None, *, q: int = M31
) -> ScheduleIR:
    """§IV Algorithm 1. Mirrors the message-passing semantics exactly,
    including the small-K edge cases (self-sends skipped, duplicate
    destinations collapsed, dead slots never shipped): prepare rounds store
    the whole residue buffer, one LocalOp forms the w variables with the
    first-coverage mask, shoot rounds add the live digit-t slices."""
    from .schedule import digit_reduction_slots, live_slots

    K, p, m, n = plan.K, plan.p, plan.m, plan.n
    field = Field(q)
    steps: list = []
    # ---- prepare: residue offsets held are identical at every k -----------
    offsets = {0}
    for shifts in plan.prepare_shifts:
        held = tuple(sorted(offsets))
        transfers = []
        pairs_seen = set()
        for k in range(K):
            for rho, s in enumerate(shifts, start=1):
                dst = (k + s) % K
                if dst == k or (k, dst) in pairs_seen:
                    continue  # self-send / duplicate destination (K ≤ m regime)
                pairs_seen.add((k, dst))
                transfers.append(
                    Transfer(
                        src=k,
                        dst=dst,
                        port=rho,
                        slots=tuple((u, (u + s) % K) for u in held),
                        mode="store",
                    )
                )
        steps.append(CommRound(tuple(transfers)))
        base = set(offsets)
        for s in shifts:
            if s % K:
                offsets |= {(o + s) % K for o in base}
    # ---- w-init: first-coverage contraction over the residue buffer -------
    n_off = min(m, K)
    in_slots = tuple(range(n_off))
    coeffs = None
    if A is not None:
        A = field.asarray(A)
        coeffs = np.zeros((K, n, n_off), dtype=np.uint64)
        k_idx = np.arange(K)
        for off in range(m):  # offsets ≥ K alias offset off % K (same residue)
            j = off % K
            for l in range(n):
                if l * m + off < K:  # first-coverage mask
                    rows = (k_idx - off) % K
                    cols = (k_idx + l * m) % K
                    coeffs[:, l, j] = field.add(coeffs[:, l, j], A[rows, cols])
    steps.append(LocalOp(out_slots=tuple(range(n)), in_slots=in_slots, coeffs=coeffs))
    # ---- shoot: digit-reduction toward slot 0, live slots only ------------
    n_live = live_slots(plan)
    for t, shifts in enumerate(plan.shoot_shifts, start=1):
        transfers = []
        for rho, s in enumerate(shifts, start=1):
            dst_slots, src_slots = digit_reduction_slots(n, p, t, rho)
            pairs = [
                (int(ld), int(ls))
                for ld, ls in zip(dst_slots, src_slots)
                if ls < n_live
            ]
            if not pairs:
                continue
            for k in range(K):
                transfers.append(
                    Transfer(
                        src=k,
                        dst=(k + s) % K,
                        port=rho,
                        slots=tuple((ls, ld) for ld, ls in pairs),
                        mode="add",
                    )
                )
        steps.append(CommRound(tuple(transfers)))
    return ScheduleIR("prepare-shoot", K, p, tuple(steps))


def ir_butterfly(plan: ButterflyPlan, inverse: bool = False) -> ScheduleIR:
    """§V-A radix-(p+1) butterfly: round t ships the single Q value to the p
    digit-t partners (receive coefficient = the sender-digit twiddle), then a
    LocalOp folds the own-digit term into the accumulator."""
    K, p, radix = plan.K, plan.p, plan.radix
    ACC = 1
    steps: list = []
    order = range(plan.H - 1, -1, -1) if inverse else range(plan.H)
    k_idx = np.arange(K)
    for t in order:
        tw = plan.inv_twiddles[t] if inverse else plan.twiddles[t]
        step_sz = radix**t
        digit = (k_idx // step_sz) % radix
        transfers = []
        for d, dst_map in enumerate(butterfly_group_perms(K, radix, t), start=1):
            for src in range(K):
                dst = int(dst_map[src])
                transfers.append(
                    Transfer(
                        src=src,
                        dst=dst,
                        port=d,
                        slots=((0, ACC),),
                        coeffs=(int(tw[dst, digit[src]]),),
                        mode="add",
                    )
                )
        steps.append(CommRound(tuple(transfers)))
        own = np.zeros((K, 1, 2), dtype=np.uint64)
        own[:, 0, 0] = tw[k_idx, digit]
        own[:, 0, 1] = 1
        steps.append(LocalOp(out_slots=(0,), in_slots=(0, ACC), coeffs=own))
    return ScheduleIR("butterfly", K, p, tuple(steps))


def ir_draw_loose(plan: DrawLoosePlan) -> ScheduleIR:
    """§V-B: Z parallel M-point prepare-and-shoots over stride-Z subgroups
    (merged round-by-round), the local α^rev scale, then M parallel Z-point
    butterflies over contiguous groups."""
    K, M, Z = plan.K, plan.M, plan.Z
    steps: list = []
    if plan.draw_plan is not None:
        sub = ir_prepare_shoot(plan.draw_plan, plan.draw_matrix, q=plan.q)
        steps += embed_parallel(sub, K, [j + Z * np.arange(M) for j in range(Z)])
    scale = np.zeros((K, 1, 1), dtype=np.uint64)
    scale[:, 0, 0] = plan.local_scale
    steps.append(LocalOp(out_slots=(0,), in_slots=(0,), coeffs=scale))
    if plan.loose_plan is not None:
        sub = ir_butterfly(plan.loose_plan)
        steps += embed_parallel(sub, K, [Z * i + np.arange(Z) for i in range(M)])
    return ScheduleIR("draw-loose", K, plan.p, tuple(steps))


def ir_allgather(K: int, p: int, A=None, *, q: int = M31) -> ScheduleIR:
    """The (p+1)-ary doubling all-gather baseline + one local contraction —
    C1 = ⌈log_{p+1}K⌉ but C2 = Θ(K/p), the cost-model foil."""
    steps: list = []
    for ports in gather_rounds(K, p):
        transfers = []
        for rho, (s, cnt) in enumerate(ports, start=1):
            for k in range(K):
                transfers.append(
                    Transfer(
                        src=k,
                        dst=(k + s) % K,
                        port=rho,
                        slots=tuple((u, s + u) for u in range(cnt)),
                        mode="store",
                    )
                )
        steps.append(CommRound(tuple(transfers)))
    steps.append(LocalOp(tuple([0]), tuple(range(K)), _combine_coeffs(K, A, q)))
    return ScheduleIR("allgather", K, p, tuple(steps))


def _combine_coeffs(K: int, A, q: int):
    """coeffs[k, 0, d] = A[(k-d) % K, k] — the full local combine of a
    gather-everything schedule (allgather, ring) over offset-d slots."""
    if A is None:
        return None
    field = Field(q)
    A = field.asarray(A)
    k = np.arange(K)
    coeffs = np.zeros((K, 1, K), dtype=np.uint64)
    for d in range(K):
        coeffs[:, 0, d] = A[(k - d) % K, k]
    return coeffs
