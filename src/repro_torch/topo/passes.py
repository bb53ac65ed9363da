"""Topology-aware ScheduleIR rewrite passes + the :class:`PassPipeline`
optimizer.

PR 4 unified every encode algorithm on one ScheduleIR; this module turns the
rewrite layer into a real optimizer. A :class:`Pass` is a named
``(ScheduleIR, Topology) -> ScheduleIR`` rewrite with an applicability
predicate; a :class:`PassPipeline` is a named composition of passes. The
autotuner (``topo.autotune``) enumerates every applicable pipeline per
compiled IR, prices the rewritten IR with the α-β estimator (fitted α/β when
calibration exists — see ``topo.calibrate.load_fitted_costs``), and records
the winning (algorithm, pipeline) pair.

Every pass is **exact**: the rewritten IR computes the same encode function,
proven against the oracle interpreter for every registered pipeline × every
algorithm family in ``tests/test_ir.py``. Exactness comes from construction:

* :func:`remap_digits` / :func:`align_subgroups` only relabel the machine
  (:func:`repro_torch.core.ir.relabel` composes ``placement`` so logical
  inputs/outputs stay put);
* :func:`split_contended` only splits rounds proven hazard-free
  (:func:`repro_torch.core.ir.round_hazard_free`) along port-group boundaries —
  every send still reads the value it read before, and the executor's
  ppermute count is preserved;
* :func:`fuse_rounds` only merges adjacent rounds when
  :func:`repro_torch.core.ir.merge_comm_rounds` proves no read-after-write hazard,
  no duplicate (src, dst) pair, and the p-port budget holds.

Price-guarded passes (split, fuse, align) return the input IR unchanged when
no rewrite strictly improves the α-β price — under the default ``gamma = 0``
link model splitting can never win (max is subadditive), so
``split_contended`` only fires on fabrics whose :class:`~repro_torch.topo.model.LinkCost`
carries a contention-degradation ``gamma > 0``.

:func:`remap_digits` is the torus-native butterfly from the ROADMAP: the
radix-(p+1) butterfly's digit-t partners sit at stride (p+1)^t, so on a torus
the plain schedule pays multi-hop routes and link contention. The pass picks
a digit→mesh-dimension assignment and a per-dimension cyclic Gray relabeling
so partner exchanges run between torus neighbors. Why Gray codes: a ring of
size radix² admits a cyclic radix-ary Gray labeling in which incrementing
EITHER digit moves to a ring neighbor (for radix 2 the classic reflected
Gray code on the 4-cycle). Rings of size radix are trivially
neighbor-complete for radix ≤ 3. Hence for p = 1 every torus whose
dimensions are 2 or 4 (e.g. 2×4 for K = 8, 4×4 for K = 16, 2×2×2 for K = 8
on a 3D torus) gets a hop-count-1 embedding for EVERY round — asserted in
tests/test_ir.py. For larger dimensions no dilation-1 embedding exists (a
d-cube has d·2^{d-1} edges, a 2^d-ring only 2^d), so the pass minimizes
total hops and lets the α-β price decide whether it wins. When the torus
dims are powers of 2 but not powers of the radix (and the radix itself is a
power of 2), the pass re-expresses the radix-(p+1) digits as binary digits
first — a radix-4 butterfly then embeds on a binary torus at ≤ 2 hops per
partner instead of not at all.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from itertools import combinations
from math import comb
from typing import Callable

import numpy as np

from ..core.ir import (
    INPUT_SLOT,
    CommRound,
    LocalOp,
    ScheduleIR,
    ir_messages,
    merge_comm_rounds,
    relabel,
    round_hazard_free,
)

from .model import (
    MAC_SECONDS,
    Hierarchy,
    Topology,
    Torus2D,
    Torus3D,
    TwoLevel,
    local_op_unit_work,
    schedule_time,
)


def ir_compute_time(ir: ScheduleIR, topo: Topology, payload_elems: int = 1) -> float:
    """Seconds of local arithmetic on the IR's critical path, with the
    overlap credit: an ``overlap=True`` LocalOp runs concurrently with the
    NEXT comm round, so it only costs the part that does not hide under that
    round's wire time (``max(comm, work) − comm``). Comm time itself is NOT
    included — this is exactly the term :func:`ir_time` adds on top of
    :func:`~repro_torch.topo.model.schedule_time`."""
    per_round = schedule_time(topo, ir_messages(ir), payload_elems).per_round
    total = 0.0
    pending = 0.0  # overlap-tagged work waiting for the next comm round
    ri = 0
    for step in ir.steps:
        if isinstance(step, CommRound):
            total += max(0.0, pending - per_round[ri])
            pending = 0.0
            ri += 1
            continue
        work = local_op_unit_work(step) * payload_elems * MAC_SECONDS
        if step.overlap:
            pending += work
        else:
            total += work
    return total + pending  # trailing overlap op has nothing to hide under


def ir_time(
    ir: ScheduleIR,
    topo: Topology,
    payload_elems: int = 1,
    *,
    include_compute: bool = True,
) -> float:
    """α-β + compute price of an IR on a topology (seconds) — the objective
    every price-guarded pass and the autotuner optimize. Comm is
    :func:`~repro_torch.topo.model.schedule_time` over the message maps; local
    arithmetic adds :func:`ir_compute_time` (MAC-priced LocalOps, with
    ``overlap=True`` ops credited against the round they hide under)."""
    comm = schedule_time(topo, ir_messages(ir), payload_elems).total
    if not include_compute:
        return comm
    return comm + ir_compute_time(ir, topo, payload_elems)


# ---------------------------------------------------------------------------
# remap_digits: Gray-coded digit→dimension embedding for tori
# ---------------------------------------------------------------------------


def _gray_positions(n_digits: int, radix: int) -> np.ndarray:
    """pos_of_label for a ring of radix**n_digits positions: label ℓ (radix-
    ary digits) → ring position, cyclic-Gray for radix 2, identity otherwise
    (identity is neighbor-complete for a single digit when radix ≤ 3)."""
    size = radix**n_digits
    if radix == 2:
        pos_of_label = np.empty(size, dtype=np.int64)
        for pos in range(size):
            pos_of_label[pos ^ (pos >> 1)] = pos  # BRGC: label(pos) = pos ^ pos>>1
        return pos_of_label
    return np.arange(size, dtype=np.int64)


def _digit_values(K: int, radix: int, digits) -> np.ndarray:
    """(K,) integer formed by the given digit positions of each k (given
    order: first listed digit is least significant)."""
    k = np.arange(K, dtype=np.int64)
    out = np.zeros(K, dtype=np.int64)
    mult = 1
    for t in digits:
        out += ((k // radix**t) % radix) * mult
        mult *= radix
    return out


def _torus_dims(topo) -> tuple[int, ...]:
    """Torus dimension sizes, outermost → innermost, matching the device
    index k = Horner(dims): Torus2D k = r·cols + c, Torus3D k = (z·rows +
    r)·cols + c."""
    if isinstance(topo, Torus3D):
        return (topo.depth, topo.rows, topo.cols)
    if isinstance(topo, Torus2D):
        return (topo.rows, topo.cols)
    raise TypeError("remap_digits targets Torus2D / Torus3D topologies")


def _remap_radix(ir: ScheduleIR, topo) -> tuple[int, int] | None:
    """(radix, H) to run the digit embedding in, or None when the torus dims
    don't decompose. Prefers the butterfly's own radix p+1; falls back to
    binary digits when every dim is a power of 2 and so is the radix."""

    def log_b(n, b):
        h = 0
        while b**h < n:
            h += 1
        return h if b**h == n else None

    dims = _torus_dims(topo)
    for radix in dict.fromkeys([ir.p + 1, 2]):
        if radix < 2:
            continue
        if radix != ir.p + 1 and log_b(ir.p + 1, 2) is None:
            continue  # binary re-expression needs the radix to be a 2-power
        per_dim = [log_b(d, radix) for d in dims]
        if any(h is None for h in per_dim):
            continue
        H = sum(per_dim)
        if radix**H == ir.K:
            return radix, H
    return None


def _embedding(K: int, radix: int, assignment, dims) -> np.ndarray:
    """π: logical index → torus device, Gray-relabeled per dimension.
    ``assignment`` lists the digit positions owned by each dim (outermost →
    innermost, matching ``dims``)."""
    dev = np.zeros(K, dtype=np.int64)
    for digits, size in zip(assignment, dims):
        pos = _gray_positions(len(digits), radix)[_digit_values(K, radix, digits)]
        dev = dev * size + pos
    return dev


def _total_hops(ir: ScheduleIR, topo, perm: np.ndarray) -> int:
    total = 0
    for r in ir.rounds():
        for t in r.transfers:
            total += topo.hops(int(perm[t.src]), int(perm[t.dst]))
    return total


def _assignments(H: int, sizes):
    """All ways to partition digit positions 0..H−1 into per-dim groups of
    the given sizes (outermost dim first)."""

    def rec(remaining, sizes):
        if not sizes:
            yield ()
            return
        for chosen in combinations(remaining, sizes[0]):
            rest = tuple(x for x in remaining if x not in chosen)
            for tail in rec(rest, sizes[1:]):
                yield (chosen,) + tail

    yield from rec(tuple(range(H)), sizes)


def _assignment_count(H: int, sizes) -> int:
    out, rest = 1, H
    for s in sizes:
        out *= comb(rest, s)
        rest -= s
    return out


def remap_digits(ir: ScheduleIR, topo, exhaustive_limit: int = 4096) -> ScheduleIR:
    """Rewrite a digit-structured IR for a 2D/3D torus: assign each radix
    digit to a torus dimension (minimizing total hops) and Gray-relabel each
    dimension's ring so digit increments land on neighbors. Returns the
    relabeled IR (``placement`` set); exactness is :func:`relabel`'s — the
    same program on renamed processors. When the assignment space exceeds
    ``exhaustive_limit``, falls back to a greedy swap search from the
    contiguous assignment and warns that the search was bounded."""
    dims = _torus_dims(topo)
    K = ir.K
    if topo.n != K:
        raise ValueError(f"topology has {topo.n} processors, IR has {K}")
    picked = _remap_radix(ir, topo)
    if picked is None:
        raise ValueError(
            f"torus dims {dims} are not powers of radix {ir.p + 1} "
            "(nor uniformly binary)"
        )
    radix, H = picked

    def log_r(n):
        h = 0
        while radix**h < n:
            h += 1
        return h

    sizes = tuple(log_r(d) for d in dims)

    def hops_of(assignment):
        return _total_hops(ir, topo, _embedding(K, radix, assignment, dims))

    if _assignment_count(H, sizes) <= exhaustive_limit:
        best = min(_assignments(H, sizes), key=hops_of)
    else:
        # Greedy fallback: contiguous start (innermost dim owns the lowest
        # digits), then pairwise digit swaps across dims until no improvement.
        warnings.warn(
            f"remap_digits: {_assignment_count(H, sizes)} digit assignments "
            f"exceed exhaustive_limit={exhaustive_limit}; using greedy swap "
            "search — the embedding may be suboptimal",
            RuntimeWarning,
            stacklevel=2,
        )
        groups = []
        nxt = 0
        for s in reversed(sizes):  # innermost gets lowest digits
            groups.append(list(range(nxt, nxt + s)))
            nxt += s
        groups = list(reversed(groups))
        cur = hops_of(tuple(tuple(g) for g in groups))
        improved = True
        while improved:
            improved = False
            for i in range(len(groups)):
                for j in range(i + 1, len(groups)):
                    for a in range(len(groups[i])):
                        for b in range(len(groups[j])):
                            groups[i][a], groups[j][b] = groups[j][b], groups[i][a]
                            h = hops_of(tuple(tuple(g) for g in groups))
                            if h < cur:
                                cur = h
                                improved = True
                            else:
                                groups[i][a], groups[j][b] = (
                                    groups[j][b],
                                    groups[i][a],
                                )
        best = tuple(tuple(g) for g in groups)
    perm = _embedding(K, radix, best, dims)
    if np.array_equal(perm, np.arange(K)):
        return ir  # identity embedding — nothing to rewrite
    return relabel(ir, perm)


def max_round_hops(ir: ScheduleIR, topo) -> int:
    """Worst route length (links) of any transfer in any round — the
    hop-count-1 acceptance check for :func:`remap_digits`."""
    return max(
        (topo.hops(t.src, t.dst) for r in ir.rounds() for t in r.transfers),
        default=0,
    )


# ---------------------------------------------------------------------------
# split_contended: stagger a round's port groups when contention is priced
# ---------------------------------------------------------------------------


def _topo_gammas(topo: Topology) -> list[float]:
    costs = []
    for attr in ("cost", "intra", "inter"):
        c = getattr(topo, attr, None)
        if c is not None:
            costs.append(c.gamma)
    if isinstance(topo, Hierarchy):
        costs += [topo.level_cost(j).gamma for j in range(len(topo.levels))]
    return costs


def split_contended(
    ir: ScheduleIR, topo: Topology, payload_elems: int = 1
) -> ScheduleIR:
    """Break a contended round into staggered sub-rounds when the α-β price
    says the split wins. Splits ONLY along port-group boundaries (each group
    is one ppermute, so the executor's ppermute count is preserved) and ONLY
    rounds proven hazard-free, so every send still reads the value it read
    before — exact by construction. Per round, a dynamic program over
    contiguous group partitions picks the cheapest staggering; with the
    default ``gamma = 0`` link model the single-segment partition is always
    cheapest (max is subadditive) and the pass is a no-op."""
    steps = []
    changed = False
    for step in ir.steps:
        if not isinstance(step, CommRound):
            steps.append(step)
            continue
        order: list = []
        by_key: dict = {}
        for t in step.transfers:
            key = (t.port, t.slots, t.mode)
            if key not in by_key:
                by_key[key] = []
                order.append(key)
            by_key[key].append(t)
        parts = [tuple(by_key[k]) for k in order]
        g = len(parts)
        if g < 2 or not round_hazard_free(step):
            steps.append(step)
            continue

        def seg_cost(i, j):
            msgs = {(t.src, t.dst): t.elems for part in parts[i:j] for t in part}
            return schedule_time(topo, [msgs], payload_elems).total

        best = [0.0] * (g + 1)
        cut = [0] * (g + 1)
        for j in range(1, g + 1):
            best[j], cut[j] = min(
                (best[i] + seg_cost(i, j), i) for i in range(j)
            )
        whole = seg_cost(0, g)
        if best[g] >= whole * (1 - 1e-12):
            steps.append(step)
            continue
        bounds = []
        j = g
        while j > 0:
            bounds.append((cut[j], j))
            j = cut[j]
        for i, j in reversed(bounds):
            steps.append(
                CommRound(tuple(t for part in parts[i:j] for t in part))
            )
        changed = True
    if not changed:
        return ir
    from dataclasses import replace as _replace

    return _replace(ir, steps=tuple(steps))


# ---------------------------------------------------------------------------
# fuse_rounds: merge adjacent rounds within the p-port budget
# ---------------------------------------------------------------------------


def fuse_rounds(ir: ScheduleIR, topo: Topology, payload_elems: int = 1) -> ScheduleIR:
    """Merge adjacent CommRounds (no LocalOp between) when
    :func:`repro_torch.core.ir.merge_comm_rounds` proves the merge legal (no RAW
    hazard, no duplicate pair, p-port budget holds) and the α-β price does
    not regress — cutting C1 by one α-charge per merge. Natural family IRs
    are mostly data-dependent round-to-round (each gather/reduction reads
    what the previous round delivered), so this pass chiefly re-packs the
    output of :func:`split_contended` and hand-built schedules."""
    out: list = []
    changed = False
    for step in ir.steps:
        if isinstance(step, CommRound) and out and isinstance(out[-1], CommRound):
            merged = merge_comm_rounds(out[-1], step, ir.p)
            if merged is not None:
                t_merged = schedule_time(
                    topo, ir_messages_of_rounds([merged]), payload_elems
                ).total
                t_split = schedule_time(
                    topo, ir_messages_of_rounds([out[-1], step]), payload_elems
                ).total
                if t_merged <= t_split * (1 + 1e-12):
                    out[-1] = merged
                    changed = True
                    continue
        out.append(step)
    if not changed:
        return ir
    from dataclasses import replace as _replace

    return _replace(ir, steps=tuple(out))


def ir_messages_of_rounds(rounds) -> list[dict]:
    """{(src, dst): elems} maps for bare CommRounds (no IR wrapper)."""
    return [{(t.src, t.dst): t.elems for t in r.transfers} for r in rounds]


# ---------------------------------------------------------------------------
# align_subgroups: level-aligned stride relabeling for hierarchies
# ---------------------------------------------------------------------------


def align_subgroups(
    ir: ScheduleIR, topo: Topology, payload_elems: int = 1
) -> ScheduleIR:
    """Relabel the machine by the stride↔block transpose that minimizes the
    α-β price on a hierarchical fabric. The draw-loose plan's heavy draw
    phase runs in stride-Z subgroups {j, j+Z, …} that a transpose
    π(j + Z·a) = j·M + a turns into CONTIGUOUS groups — i.e. intra-domain on
    a TwoLevel/Hierarchy — while the light loose butterflies move to the
    slow trunks. This is the ROADMAP's hierarchical draw-loose collapsed
    into a pipeline stage: same IR, level-aligned layout. The pass tries
    every divisor transpose of K (both directions arise as Z ↔ M) plus
    identity, prices each, and relabels only on strict improvement —
    exactness is :func:`relabel`'s."""
    K = ir.K
    base = ir_messages(ir)
    best_t = schedule_time(topo, base, payload_elems).total
    best_perm = None
    for Z in range(2, K):
        if K % Z:
            continue
        M = K // Z
        perm = np.empty(K, dtype=np.int64)
        for j in range(Z):
            for a in range(M):
                perm[j + Z * a] = j * M + a
        msgs = [
            {(int(perm[s]), int(perm[d])): e for (s, d), e in rnd.items()}
            for rnd in base
        ]
        t = schedule_time(topo, msgs, payload_elems).total
        if t < best_t * (1 - 1e-12):
            best_t, best_perm = t, perm
    if best_perm is None:
        return ir
    return relabel(ir, best_perm)


def _ir_slots(ir: ScheduleIR) -> set[int]:
    slots = {INPUT_SLOT, ir.out_slot}
    for step in ir.steps:
        if isinstance(step, CommRound):
            for t in step.transfers:
                for ss, ds in t.slots:
                    slots.add(ss)
                    slots.add(ds)
        else:
            slots.update(step.out_slots)
            slots.update(step.in_slots)
    return slots


def _observed_slots(steps, out_slot: int) -> set[int]:
    """Slots whose current value is observed by ``steps``: comm sources,
    add-mode destinations (the add reads what it lands on), LocalOp inputs,
    and the IR's final output slot."""
    obs = {out_slot}
    for st in steps:
        if isinstance(st, CommRound):
            for t in st.transfers:
                for ss, ds in t.slots:
                    obs.add(ss)
                    if t.mode == "add":
                        obs.add(ds)
        else:
            obs.update(st.in_slots)
    return obs


def _pipeline_split(L: LocalOp, comms, read_after, alloc, K: int):
    """Split one REPLACE-mode LocalOp followed by comm rounds ``comms`` into
    the software-pipelined form, or return None when there is nothing to
    defer. See :func:`pipeline_rounds` for the schedule produced."""
    R = len(comms)
    if R == 0 or not L.in_slots or not L.out_slots:
        return None
    reads = [{ss for t in c.transfers for ss, _ in t.slots} for c in comms]
    stores = [
        {ds for t in c.transfers if t.mode == "store" for _, ds in t.slots}
        for c in comms
    ]
    stage = {}
    for o in L.out_slots:
        s = R + 1
        for r in range(R):
            if o in reads[r]:
                s = r + 1
                break
        for r in range(s - 1):
            if o in stores[r]:  # clobbered before first read: don't defer
                s = 1
                break
        stage[o] = s
    if all(s == 1 for s in stage.values()):
        return None
    row_of = {o: i for i, o in enumerate(L.out_slots)}
    stage1 = tuple(o for o in L.out_slots if stage[o] == 1)
    deferred = tuple(o for o in L.out_slots if stage[o] > 1)
    sigma = {b: alloc() for b in L.in_slots}
    tau = {o: alloc() for o in deferred}
    n_in = len(L.in_slots)
    # A: shadow-copy every input to σ and zero what the original REPLACE
    # killed — deferred outputs (so in-flight adds land on zeros until the
    # combine) plus every later-observed slot outside the out set (REPLACE
    # semantics: those read as 0 after the original op). Coefficients are
    # known (identity block + zero rows) even on structure-only IRs, so the
    # α-β+compute model prices them as adds/free — not dense MACs.
    zeroed = tuple(
        dict.fromkeys(
            deferred
            + tuple(
                s
                for s in sorted(read_after)
                if s not in L.out_slots and s not in sigma.values()
            )
        )
    )
    n_a = n_in + len(zeroed)
    ca = np.zeros((K, n_a, n_in), dtype=np.uint64)
    for j in range(n_in):
        ca[:, j, j] = 1
    steps = [
        LocalOp(
            out_slots=tuple(sigma[b] for b in L.in_slots) + zeroed,
            in_slots=L.in_slots,
            coeffs=ca,
            update=True,
        )
    ]
    sig = tuple(sigma[b] for b in L.in_slots)
    if stage1:
        c1 = L.coeffs[:, [row_of[o] for o in stage1], :] if L.coeffs is not None else None
        steps.append(LocalOp(out_slots=stage1, in_slots=sig, coeffs=c1, update=True))
    for r in range(R):
        rows_r = tuple(o for o in deferred if stage[o] == r + 2)
        if rows_r:
            cp = (
                L.coeffs[:, [row_of[o] for o in rows_r], :]
                if L.coeffs is not None
                else None
            )
            steps.append(
                LocalOp(
                    out_slots=tuple(tau[o] for o in rows_r),
                    in_slots=sig,
                    coeffs=cp,
                    update=True,
                    overlap=True,
                )
            )
        steps.append(comms[r])
        if rows_r:
            fin = tuple(s for o in rows_r for s in (o, tau[o]))
            cf = np.zeros((K, len(rows_r), 2 * len(rows_r)), dtype=np.uint64)
            for i in range(len(rows_r)):
                cf[:, i, 2 * i] = 1
                cf[:, i, 2 * i + 1] = 1
            steps.append(
                LocalOp(out_slots=rows_r, in_slots=fin, coeffs=cf, update=True)
            )
    return steps


def pipeline_rounds(ir: ScheduleIR, topo: Topology, payload_elems: int = 1) -> ScheduleIR:
    """Software-pipeline a REPLACE-mode LocalOp across the comm rounds that
    follow it, so each round's ppermute overlaps the contraction producing
    the NEXT round's operands (the ROADMAP's comm/compute-overlap item).

    For a prologue contraction L whose output slot ``o`` is first read in
    comm round ``r`` (its *stage*), the heavy row for ``o`` need not run
    before round 1 — deferring it past earlier ADD-mode deliveries is exact
    because modular adds commute. The pass emits:

    * ``A`` (update): shadow-copy L's inputs to fresh σ slots (the double
      buffer) and zero the slots L's REPLACE would have killed, so in-flight
      adds land on zeros;
    * ``B`` (update): the stage-1 rows, computed from σ;
    * per round r: ``P_r`` (update, **overlap**) computing stage-(r+1) rows
      into fresh τ slots from σ — independent of round r, so the executor
      issues it concurrently with the ppermute — then the untouched comm
      round, then ``F_r`` (update) combining ``o ← o + τ(o)``.

    Comm rounds are emitted byte-identical, so the ppermute budget is
    preserved by construction. The pass is price-guarded against
    :func:`ir_time` (which credits ``overlap=True`` work against the round
    it hides under): the rewrite is kept only when strictly cheaper; the
    shadow copies and combines are uniform-0/1 rows the model prices as
    adds, while the deferred dense rows hide under the wire time."""
    from dataclasses import replace as _replace

    steps = list(ir.steps)
    counter = [max(_ir_slots(ir)) + 1]

    def alloc():
        v = counter[0]
        counter[0] += 1
        return v

    out_steps = []
    changed = False
    i = 0
    while i < len(steps):
        st = steps[i]
        if not (isinstance(st, LocalOp) and not st.update):
            out_steps.append(st)
            i += 1
            continue
        j = i + 1
        comms = []
        while j < len(steps) and isinstance(steps[j], CommRound):
            comms.append(steps[j])
            j += 1
        repl = _pipeline_split(
            st, comms, _observed_slots(steps[i + 1 :], ir.out_slot), alloc, ir.K
        )
        if repl is None:
            out_steps.append(st)
            i += 1
            continue
        out_steps.extend(repl)
        changed = True
        i = j
    if not changed:
        return ir
    cand = _replace(ir, steps=tuple(out_steps))
    if ir_time(cand, topo, payload_elems) < ir_time(ir, topo, payload_elems) * (
        1 - 1e-12
    ):
        return cand
    return ir


# ---------------------------------------------------------------------------
# Pass / PassPipeline registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Pass:
    """A named, exact ScheduleIR rewrite with an applicability predicate.
    ``fn(ir, topo, payload_elems)`` returns the rewritten IR (the SAME object
    when nothing changed); ``applies(ir, topo)`` is a cheap structural check
    the autotuner uses to skip hopeless candidates."""

    name: str
    fn: Callable[[ScheduleIR, Topology, int], ScheduleIR]
    applies: Callable[[ScheduleIR, Topology], bool]
    doc: str = ""

    def __call__(self, ir, topo, payload_elems: int = 1) -> ScheduleIR:
        return self.fn(ir, topo, payload_elems)


@dataclass(frozen=True)
class PassPipeline:
    """A named composition of passes, applied left to right. A pipeline is
    applicable when every member pass is; applying it to an applicable IR is
    exact because every member is."""

    name: str
    passes: tuple[Pass, ...]
    doc: str = ""

    def applicable(self, ir: ScheduleIR, topo: Topology) -> bool:
        return all(p.applies(ir, topo) for p in self.passes)

    def apply(self, ir: ScheduleIR, topo: Topology, payload_elems: int = 1):
        for p in self.passes:
            ir = p.fn(ir, topo, payload_elems)
        return ir


def _remap_applies(ir, topo) -> bool:
    return (
        isinstance(topo, (Torus2D, Torus3D))
        and topo.n == ir.K
        and _remap_radix(ir, topo) is not None
    )


def _split_applies(ir, topo) -> bool:
    if not any(g > 0 for g in _topo_gammas(topo)):
        return False  # additive model: splitting can never strictly win
    return any(
        len({(t.port, t.slots, t.mode) for t in r.transfers}) > 1
        and round_hazard_free(r)
        for r in ir.rounds()
    )


def _fuse_applies(ir, topo) -> bool:
    prev_comm = False
    for step in ir.steps:
        if isinstance(step, CommRound):
            if prev_comm:
                return True
            prev_comm = True
        else:
            prev_comm = False
    return False


def _align_applies(ir, topo) -> bool:
    # Scoped to the draw-loose family: its draw phase runs in stride-Z
    # subgroups that the transpose makes level-aligned (the ROADMAP's
    # hierarchical draw-loose). Other families are either already
    # level-aligned (hierarchical/multilevel compile FROM the hierarchy) or
    # have no subgroup structure a transpose could exploit.
    return (
        isinstance(topo, (TwoLevel, Hierarchy))
        and topo.n == ir.K
        and ir.K > 3
        and "draw-loose" in ir.algorithm
    )


def _pipeline_rounds_applies(ir, topo) -> bool:
    # A REPLACE-mode LocalOp directly followed by a comm round that does NOT
    # read all its outputs — i.e. at least one row is deferrable.
    steps = ir.steps
    for i, st in enumerate(steps[:-1]):
        if not (
            isinstance(st, LocalOp) and not st.update and st.in_slots and st.out_slots
        ):
            continue
        nxt = steps[i + 1]
        if not isinstance(nxt, CommRound):
            continue
        first_reads = {ss for t in nxt.transfers for ss, _ in t.slots}
        if any(o not in first_reads for o in st.out_slots):
            return True
    return False


PASSES: dict[str, Pass] = {
    p.name: p
    for p in [
        Pass(
            "remap-digits",
            lambda ir, topo, pe=1: remap_digits(ir, topo),
            _remap_applies,
            doc="Gray-coded digit→torus-dimension relabeling (2D/3D, radix→2 fallback)",
        ),
        Pass(
            "split-contended",
            split_contended,
            _split_applies,
            doc="stagger a hazard-free round's port groups when γ-priced contention loses",
        ),
        Pass(
            "fuse-rounds",
            fuse_rounds,
            _fuse_applies,
            doc="merge adjacent hazard-free rounds within the p-port budget (cuts C1)",
        ),
        Pass(
            "align-subgroups",
            align_subgroups,
            _align_applies,
            doc="stride↔block transpose putting heavy subgroups on fast intra links",
        ),
        Pass(
            "pipeline-rounds",
            pipeline_rounds,
            _pipeline_rounds_applies,
            doc="double-buffer a prologue contraction so each ppermute overlaps "
            "the contraction feeding the next round",
        ),
    ]
}

PIPELINES: dict[str, PassPipeline] = {
    pl.name: pl
    for pl in [
        PassPipeline("remap-digits", (PASSES["remap-digits"],)),
        PassPipeline("split-contended", (PASSES["split-contended"],)),
        PassPipeline("fuse-rounds", (PASSES["fuse-rounds"],)),
        PassPipeline("align-subgroups", (PASSES["align-subgroups"],)),
        PassPipeline(
            "split+fuse",
            (PASSES["split-contended"], PASSES["fuse-rounds"]),
            doc="stagger contended rounds, then re-pack what still fits",
        ),
        PassPipeline(
            "pipeline",
            (PASSES["pipeline-rounds"],),
            doc="software-pipelined rounds: comm overlaps the next round's contraction",
        ),
    ]
}


def pipelines_for(ir: ScheduleIR, topo: Topology) -> list[PassPipeline]:
    """Every registered pipeline whose passes all apply to (ir, topo) — the
    candidate set the autotuner prices."""
    return [pl for pl in PIPELINES.values() if pl.applicable(ir, topo)]
