"""Two-level (hierarchical) all-to-all encode schedules.

K = K_inter × K_intra processors, k = g·K_intra + i: group ``g`` is the fast
domain (the links inside a node), crossing groups is slow (the links between
nodes). The flat
prepare-and-shoot schedule shifts by ±m/(p+1)^t regardless of group
boundaries, so on a two-level network most of its messages pile onto the
inter-group trunks. The schedules here keep each phase inside one level:

* **hierarchical prepare-and-shoot** (universal, any matrix A):

  1. *intra gather* — (p+1)-ary doubling all-gather inside each group
     (⌈log_{p+1}K_intra⌉ rounds, fast links only);
  2. *local contraction* — device (g, i) forms partial sums
     ``z[l] = Σ_u x_{g, i-u} · A[(g, i-u), ((g+l)%G, i)]`` for every target
     group offset l (no communication);
  3. *inter shoot* — the paper's §IV digit-reduction over the group axis
     (⌈log_{p+1}K_inter⌉ rounds, one slow message per port per round).

  C1 = ⌈log I⌉ + ⌈log G⌉ (≤ ⌈log K⌉ + 1), C2 = Θ((I + G)/p) — the flat
  √K·2/p when I ≈ G ≈ √K, but with every gather element on fast links.

* **two-level DFT** (Cooley–Tukey): when A is the DFT matrix and
  K_intra, K_inter are powers of p+1 dividing q−1, the multiplicative
  structure β^{nk} = ω_I^{n1·k1} · β^{n2·k1} · ω_G^{n2·k2} splits the encode
  into an intra butterfly, a local twiddle, and an inter butterfly —
  C2 = log I + log G elements total, no intermediate inflation. Inputs and
  outputs are relabeled ("up to permutation", exactly as draw-and-loose):
  device (g, i) holds source coefficient G·rev_I(i) + rev_G(g) and finishes
  with X[i + I·g]; :func:`two_level_dft_matrix` is the effective generator.

* **ring schedule** (per the ring-networks line of work): on a ring the
  optimal universal strategy is neighbor-only traffic — a bidirectional
  store-and-forward all-gather (⌈(K−1)/2⌉ rounds of 1-element messages to
  k±1) followed by a local combine. No multi-hop messages, so zero link
  contention.

* **recursive multi-level encode** (universal, any matrix, any K = Π K_j):
  the generalization of the two-level schedule to an arbitrary hierarchy
  ``levels = (K_0, …, K_{L−1})`` (innermost/fastest first). Phases:

  1. *intra gather* over the level-0 domain (size K_0, fastest links);
  2. *local contraction* — device with coordinates (c, i) forms one partial
     sum per **per-level offset vector** l = (l_1, …, l_{L−1}), destined for
     the device at ((c_1+l_1) mod K_1, …, (c_{L−1}+l_{L−1}) mod K_{L−1}, i).
     Component-wise modular offsets (instead of the two-level (g+l) mod G)
     are what keep every later shift inside ONE level — no mixed-radix
     carries ever cross a level boundary;
  3. *per-level digit-reduction shoot*, innermost outer level first: level j
     runs ⌈log_{p+1}K_j⌉ §IV digit-reduction rounds over the l_j component,
     every message traveling on level-j links only. Reducing cheap levels
     first matters: the level-j messages still carry Π_{j″>j} K_{j″} live
     outer combinations, so the bulky reductions ride the fast links.

  C1 = ⌈log K_0⌉ + Σ_{j≥1} ⌈log K_j⌉; Σ_j (K_j−1)/p ≤ C2 with the level-j
  term scaled by the live outer combinations Π_{j″>j} K_{j″} — exactly the
  two-level formulas when L = 2, and ``plan_multilevel(K, p, (I, G))``
  lowers to the SAME rounds as ``plan_hierarchical(K, p, I)`` (trivial
  K_j = 1 levels contribute zero rounds, zero slots).

Everything is validated on the cost-exact :class:`SyncSimulator`: the
``simulate_*`` functions here run the schedules message-by-message under the
p-port constraints and return bit-exact outputs plus measured C1/C2 and
per-round message maps (which ``topo.lower`` cross-checks analytically).

Paper-notation glossary: ``K`` processors, ``p`` ports/round, ``C1`` rounds,
``C2`` max-elements-per-port summed over rounds; ``I = k_intra`` / ``G =
k_inter`` the two-level split; *digit-reduction slots* — the §IV shoot keeps
one buffer slot per (p+1)-ary numeral of the remaining target offset and
each round zeroes one digit by shipping the slots with digit_t = ρ to port
ρ's partner (see ``core.schedule.digit_reduction_slots``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.bounds import ceil_log
from ..core.field import M31, Field
from ..core.matrices import digit_reversal_permutation
from ..core.schedule import (
    digit_reduction_message_size,
    digit_reduction_slots,
    gather_rounds,  # noqa: F401  (re-export; the IR compilers share it)
    plan_butterfly,
)
from ..core.simulator import SimStats, interpret


# (p+1)-ary doubling all-gather rounds now live in core.schedule (the IR
# compilers in core/ir.py share them); re-exported here for compatibility.


# ---------------------------------------------------------------------------
# hierarchical prepare-and-shoot plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HierarchicalPlan:
    """Static schedule for the two-level universal encode (see module doc)."""

    K: int
    p: int
    k_intra: int  # I — fast-domain size
    k_inter: int  # G — slow-domain size
    intra_rounds: tuple  # gather_rounds(k_intra, p)
    inter_shifts: tuple[tuple[int, ...], ...]  # group-unit shifts per round
    n_inter: int  # (p+1)^Ts slot count, Ts = ⌈log_{p+1} G⌉

    @property
    def c1(self) -> int:
        return len(self.intra_rounds) + len(self.inter_shifts)

    @property
    def c2(self) -> int:
        c = sum(max((cnt for _, cnt in ports), default=0) for ports in self.intra_rounds)
        for t in range(1, len(self.inter_shifts) + 1):
            c += max(
                hier_shoot_message_size(self, t, rho) for rho in range(1, self.p + 1)
            )
        return c

    @property
    def algorithm(self) -> str:
        return "hierarchical"

    def to_ir(self, A=None, *, q: int = M31):
        """The two-level schedule is exactly the depth-2 case of the
        recursive one (asserted round-for-round in tests), so it compiles
        through the same multilevel IR builder."""
        from dataclasses import replace

        ml = plan_multilevel(self.K, self.p, (self.k_intra, self.k_inter))
        return replace(ml.to_ir(A, q=q), algorithm="hierarchical")


def plan_hierarchical(K: int, p: int, k_intra: int) -> HierarchicalPlan:
    if k_intra < 1 or K % k_intra:
        raise ValueError(f"k_intra={k_intra} must divide K={K}")
    G = K // k_intra
    Ts = ceil_log(G, p + 1)
    inter_shifts = tuple(
        tuple(rho * (p + 1) ** (t - 1) for rho in range(1, p + 1))
        for t in range(1, Ts + 1)
    )
    return HierarchicalPlan(
        K=K,
        p=p,
        k_intra=k_intra,
        k_inter=G,
        intra_rounds=gather_rounds(k_intra, p),
        inter_shifts=inter_shifts,
        n_inter=(p + 1) ** Ts,
    )


def hier_shoot_slots(n: int, p: int, t: int, rho: int):
    """(dst_slots, src_slots) for inter-shoot round ``t`` (1-based), port
    ``rho`` over ``n`` slots — delegates to the §IV digit-reduction."""
    return digit_reduction_slots(n, p, t, rho)


def hier_shoot_message_size(plan: HierarchicalPlan, t: int, rho: int) -> int:
    """Live elements shipped on port rho in inter round t: slots with
    digit_t = rho, lower digits 0, below the live count G (slots l ≥ G are
    identically zero — they are never worth sending)."""
    return digit_reduction_message_size(
        plan.n_inter, plan.k_inter, plan.p, t, rho
    )


def hierarchical_coeff_tensor(plan: HierarchicalPlan, A: np.ndarray) -> np.ndarray:
    """coef[k, u, l] = A[g·I + (i−u)%I, ((g+l)%G)·I + i] masked to live
    target-group offsets l < G; k = g·I + i. The local-contraction analogue
    of ``schedule.shoot_coeff_tensor`` (built host-side, baked into jit)."""
    K, I, G, n = plan.K, plan.k_intra, plan.k_inter, plan.n_inter
    k = np.arange(K)
    g, i = k // I, k % I
    u = np.arange(I)
    l = np.arange(n)
    rows = g[:, None] * I + (i[:, None] - u[None, :]) % I  # (K, I)
    cols = ((g[:, None] + l[None, :]) % G) * I + i[:, None]  # (K, n)
    coef = np.asarray(A)[rows[:, :, None], cols[:, None, :]]  # (K, I, n)
    return coef * (l < G)[None, None, :]


def simulate_hierarchical(
    x: np.ndarray, A: np.ndarray, plan: HierarchicalPlan, field: Field
) -> tuple[np.ndarray, SimStats]:
    """Message-passing execution under the p-port constraints (generic IR
    interpreter); bit-exact ``x @ A`` for ANY matrix A. Returns (x̃, stats)."""
    out, stats = interpret(plan.to_ir(A, q=field.q), x, field)
    np.testing.assert_array_equal(out, field.matmul(field.asarray(x), A))
    return out, stats


# ---------------------------------------------------------------------------
# recursive multi-level plan (K = Π K_j, see module doc)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MultiLevelPlan:
    """Static schedule for the recursive K = Π K_j universal encode:
    intra gather over level 0, local contraction into one slot per per-level
    offset vector, then one digit-reduction shoot per outer level (innermost
    first). ``levels`` is innermost → outermost; ``slot_bases[j-1]`` is the
    (p+1)^⌈log K_j⌉ padded slot space of outer level j."""

    K: int
    p: int
    levels: tuple[int, ...]
    intra_rounds: tuple  # gather_rounds(levels[0], p)
    level_shifts: tuple  # [j-1][t-1][rho-1] → shift in level-j coordinate units
    slot_bases: tuple[int, ...]  # per outer level j: n_j = (p+1)^Ts_j
    n_slots: int  # Π slot_bases

    @property
    def c1(self) -> int:
        return len(self.intra_rounds) + sum(len(ts) for ts in self.level_shifts)

    @property
    def c2(self) -> int:
        c = sum(max((cnt for _, cnt in ports), default=0) for ports in self.intra_rounds)
        for j in range(1, len(self.levels)):
            for t in range(1, len(self.level_shifts[j - 1]) + 1):
                c += max(
                    multilevel_message_size(self, j, t, rho)
                    for rho in range(1, self.p + 1)
                )
        return c

    @property
    def algorithm(self) -> str:
        return "multilevel"

    def to_ir(self, A=None, *, q: int = M31):
        return _multilevel_ir(self, A, q=q)


def plan_multilevel(K: int, p: int, levels) -> MultiLevelPlan:
    levels = tuple(int(k) for k in levels)
    prod = 1
    for k in levels:
        prod *= k
    if not levels or prod != K or any(k < 1 for k in levels):
        raise ValueError(f"levels must be positive with Π levels = K: {levels}, K={K}")
    radix = p + 1
    level_shifts = []
    slot_bases = []
    n_slots = 1
    for kj in levels[1:]:
        ts = ceil_log(kj, radix)
        level_shifts.append(
            tuple(
                tuple(rho * radix ** (t - 1) for rho in range(1, p + 1))
                for t in range(1, ts + 1)
            )
        )
        slot_bases.append(radix**ts)
        n_slots *= radix**ts
    return MultiLevelPlan(
        K=K,
        p=p,
        levels=levels,
        intra_rounds=gather_rounds(levels[0], p),
        level_shifts=tuple(level_shifts),
        slot_bases=tuple(slot_bases),
        n_slots=n_slots,
    )


def _slot_digits(plan: MultiLevelPlan) -> np.ndarray:
    """(n_slots, L−1) per-outer-level digits of each slot index (level 1
    least significant, base ``slot_bases[j-1]``)."""
    L1 = len(plan.levels) - 1
    out = np.zeros((plan.n_slots, L1), dtype=np.int64)
    l = np.arange(plan.n_slots)
    for j in range(L1):
        out[:, j] = l % plan.slot_bases[j]
        l = l // plan.slot_bases[j]
    return out


def multilevel_live_mask(plan: MultiLevelPlan) -> np.ndarray:
    """(n_slots,) bool: slot live iff every per-level digit < K_j (dead
    slots are identically zero and never shipped)."""
    digits = _slot_digits(plan)
    outer = np.asarray(plan.levels[1:], dtype=np.int64)
    return np.all(digits < outer[None, :], axis=1) if outer.size else np.ones(
        plan.n_slots, dtype=bool
    )


def multilevel_level_slots(plan: MultiLevelPlan, j: int, t: int, rho: int):
    """(dst_slots, src_slots) global slot indices of outer level ``j``
    (1-based), reduction round ``t`` (1-based), port ``rho``. Senders: the
    level-j digit has digit_t = ρ with lower digits 0 and is a live
    coordinate (< K_j); levels below j are already fully reduced (digit 0);
    levels above j still hold any live coordinate. Receiver slot: the same
    index with the level-j digit lowered by ρ·(p+1)^{t-1}."""
    radix = plan.p + 1
    stride = radix ** (t - 1)
    digits = _slot_digits(plan)
    dj = digits[:, j - 1]
    ok = (dj // stride) % radix == rho
    ok &= dj % stride == 0
    ok &= dj < plan.levels[j]
    for j2 in range(1, j):
        ok &= digits[:, j2 - 1] == 0
    for j2 in range(j + 1, len(plan.levels)):
        ok &= digits[:, j2 - 1] < plan.levels[j2]
    src = np.nonzero(ok)[0]
    slot_stride = 1
    for j2 in range(1, j):
        slot_stride *= plan.slot_bases[j2 - 1]
    dst = src - rho * stride * slot_stride
    return dst, src


def multilevel_message_size(plan: MultiLevelPlan, j: int, t: int, rho: int) -> int:
    """Live elements shipped on port ρ in level-j reduction round t."""
    return int(multilevel_level_slots(plan, j, t, rho)[1].size)


def _outer_coords(plan: MultiLevelPlan) -> np.ndarray:
    """(K, L−1) outer coordinates of every device (level 1 first)."""
    L1 = len(plan.levels) - 1
    out = np.zeros((plan.K, L1), dtype=np.int64)
    c = np.arange(plan.K) // plan.levels[0]
    for j in range(L1):
        out[:, j] = c % plan.levels[j + 1]
        c = c // plan.levels[j + 1]
    return out


def multilevel_dev_shift(plan: MultiLevelPlan, k: int, j: int, s: int) -> int:
    """Device id after shifting the level-j coordinate of device k by s."""
    stride = 1
    for kj in plan.levels[:j]:
        stride *= kj
    cj = (k // stride) % plan.levels[j]
    return k + (((cj + s) % plan.levels[j]) - cj) * stride


def multilevel_coeff_tensor(plan: MultiLevelPlan, A: np.ndarray) -> np.ndarray:
    """coef[k, u, l] = A[row, col] with row = device (same outer coords,
    (i−u) mod K_0) and col = device (outer coords shifted component-wise by
    slot l's per-level digits, same i), masked to live slots — the
    multi-level analogue of :func:`hierarchical_coeff_tensor`."""
    K, K0, n = plan.K, plan.levels[0], plan.n_slots
    k = np.arange(K)
    i = k % K0
    u = np.arange(K0)
    rows = ((k // K0) * K0)[:, None] + (i[:, None] - u[None, :]) % K0  # (K, K0)
    oc = _outer_coords(plan)  # (K, L-1)
    digits = _slot_digits(plan)  # (n, L-1)
    t_outer = np.zeros((K, n), dtype=np.int64)
    mult = 1
    for j, kj in enumerate(plan.levels[1:]):
        t_outer += ((oc[:, j][:, None] + digits[:, j][None, :]) % kj) * mult
        mult *= kj
    cols = t_outer * K0 + i[:, None]  # (K, n)
    coef = np.asarray(A)[rows[:, :, None], cols[:, None, :]]  # (K, K0, n)
    return coef * multilevel_live_mask(plan)[None, None, :]


def _multilevel_ir(plan: MultiLevelPlan, A=None, *, q: int = M31):
    """Compile the recursive schedule to ScheduleIR: level-0 doubling gather
    (store mode, contiguous offsets), one LocalOp contraction into the
    per-level offset slots (live-masked coefficients), then one §IV
    digit-reduction CommRound per (outer level, round), innermost first."""
    from ..core.ir import CommRound, LocalOp, ScheduleIR, Transfer

    K, p, K0 = plan.K, plan.p, plan.levels[0]
    steps: list = []
    for ports in plan.intra_rounds:
        transfers = []
        for rho, (s, cnt) in enumerate(ports, start=1):
            for k in range(K):
                g, i = divmod(k, K0)
                transfers.append(
                    Transfer(
                        src=k,
                        dst=g * K0 + (i + s) % K0,
                        port=rho,
                        slots=tuple((u, s + u) for u in range(cnt)),
                        mode="store",
                    )
                )
        steps.append(CommRound(tuple(transfers)))
    coeffs = None
    if A is not None:
        coef = multilevel_coeff_tensor(plan, Field(q).asarray(A))  # (K, K0, n)
        coeffs = np.ascontiguousarray(np.swapaxes(coef, 1, 2))  # (K, n, K0)
    steps.append(
        LocalOp(tuple(range(plan.n_slots)), tuple(range(K0)), coeffs)
    )
    for j in range(1, len(plan.levels)):
        for t, shifts in enumerate(plan.level_shifts[j - 1], start=1):
            transfers = []
            for rho, s in enumerate(shifts, start=1):
                dst_slots, src_slots = multilevel_level_slots(plan, j, t, rho)
                if src_slots.size == 0:
                    continue
                slots = tuple(
                    (int(ls), int(ld)) for ld, ls in zip(dst_slots, src_slots)
                )
                for k in range(K):
                    transfers.append(
                        Transfer(
                            src=k,
                            dst=multilevel_dev_shift(plan, k, j, s),
                            port=rho,
                            slots=slots,
                            mode="add",
                        )
                    )
            steps.append(CommRound(tuple(transfers)))
    return ScheduleIR("multilevel", K, p, tuple(steps))


def simulate_multilevel(
    x: np.ndarray, A: np.ndarray, plan: MultiLevelPlan, field: Field
) -> tuple[np.ndarray, SimStats]:
    """Message-passing execution of the recursive schedule under the p-port
    constraints (generic IR interpreter); bit-exact ``x @ A`` for ANY matrix
    A and ANY factorization. Returns (x̃, stats)."""
    out, stats = interpret(plan.to_ir(A, q=field.q), x, field)
    np.testing.assert_array_equal(out, field.matmul(field.asarray(x), A))
    return out, stats


# ---------------------------------------------------------------------------
# ring-optimized universal schedule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RingPlan:
    """Neighbor-only all-gather + local combine: the bandwidth-optimal
    universal schedule on a ring (1 hop per message, zero contention)."""

    K: int
    p: int  # p ≥ 2 → bidirectional (⌈(K−1)/2⌉ rounds); p = 1 → K−1 rounds

    @property
    def c1(self) -> int:
        if self.K <= 1:
            return 0
        return self.K - 1 if self.p == 1 else -(-(self.K - 1) // 2)

    @property
    def c2(self) -> int:
        return self.c1  # one element per port per round

    @property
    def algorithm(self) -> str:
        return "ring"

    def to_ir(self, A=None, *, q: int = M31):
        return _ring_ir(self, A, q=q)


def plan_ring(K: int, p: int) -> RingPlan:
    return RingPlan(K=K, p=p)


def _ring_ir(plan: RingPlan, A=None, *, q: int = M31):
    """Compile the neighbor-only schedule: round j's forward stream carries
    the offset-(j−1) packet to k+1 (stored at offset j), the backward stream
    the offset-(K−j+1) packet to k−1 (stored at offset K−j); one final
    LocalOp combines all K offsets against the receiver's column of A."""
    from ..core.ir import CommRound, LocalOp, ScheduleIR, Transfer, _combine_coeffs

    K = plan.K
    steps: list = []

    def fwd(j):
        return [
            Transfer(k, (k + 1) % K, port=1, slots=((j - 1, j),), mode="store")
            for k in range(K)
        ]

    def bwd(j):
        return [
            Transfer(
                k,
                (k - 1) % K,
                port=2,
                slots=(((K - j + 1) % K, K - j),),
                mode="store",
            )
            for k in range(K)
        ]

    if K > 1:
        if plan.p == 1:
            for j in range(1, K):
                steps.append(CommRound(tuple(fwd(j))))
        else:
            r = -(-(K - 1) // 2)
            for j in range(1, r + 1):
                ts = fwd(j)
                if not (j == r and (K - 1) % 2 == 1):  # odd remainder: fwd only
                    ts += bwd(j)
                steps.append(CommRound(tuple(ts)))
    steps.append(LocalOp((0,), tuple(range(K)), _combine_coeffs(K, A, q)))
    return ScheduleIR("ring", K, plan.p, tuple(steps))


def ring_rounds(plan: RingPlan) -> list[dict]:
    """Per-round message maps {(src, dst): elements} of the ring schedule
    (the lowering format of topo.lower / SimStats.round_messages)."""
    from ..core.ir import ir_messages

    return ir_messages(plan.to_ir())


def simulate_ring_encode(
    x: np.ndarray, A: np.ndarray, plan: RingPlan, field: Field
) -> tuple[np.ndarray, SimStats]:
    """Store-and-forward execution of the ring schedule; exact for any A."""
    out, stats = interpret(plan.to_ir(A, q=field.q), x, field)
    np.testing.assert_array_equal(out, field.matmul(field.asarray(x), A))
    return out, stats


# ---------------------------------------------------------------------------
# two-level Cooley–Tukey DFT
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TwoLevelDFTPlan:
    """β^{nk} factorization for K = I·G (see module doc): intra butterfly →
    local twiddle → inter butterfly. Relabelings: device (g, i) holds source
    coefficient ``input_coeff[k]`` and finishes with X[``output_index[k]``]."""

    K: int
    p: int
    k_intra: int
    k_inter: int
    q: int
    input_coeff: np.ndarray  # (K,) n = G·rev_I(i) + rev_G(g)
    output_index: np.ndarray  # (K,) i + I·g
    twiddle: np.ndarray  # (K,) β^{rev_G(g)·i} applied between the stages

    @property
    def c1(self) -> int:
        return ceil_log(self.k_intra, self.p + 1) + ceil_log(self.k_inter, self.p + 1)

    @property
    def c2(self) -> int:
        return self.c1  # both stages are butterflies: 1 element per round

    @property
    def algorithm(self) -> str:
        return "hierarchical-dft"

    def to_ir(self):
        from ..core.ir import LocalOp, ScheduleIR, embed_parallel, ir_butterfly

        I, G, K = self.k_intra, self.k_inter, self.K
        steps: list = []
        if I > 1:
            sub = ir_butterfly(plan_butterfly(I, self.p, self.q))
            steps += embed_parallel(
                sub, K, [g * I + np.arange(I) for g in range(G)]
            )
        tw = np.zeros((K, 1, 1), dtype=np.uint64)
        tw[:, 0, 0] = self.twiddle
        steps.append(LocalOp((0,), (0,), tw))
        if G > 1:
            sub = ir_butterfly(plan_butterfly(G, self.p, self.q))
            steps += embed_parallel(
                sub, K, [np.arange(G) * I + i for i in range(I)]
            )
        return ScheduleIR("hierarchical-dft", K, self.p, tuple(steps))


def plan_two_level_dft(K: int, p: int, q: int, k_intra: int) -> TwoLevelDFTPlan:
    """Requires K | q−1 and k_intra, K/k_intra powers of p+1 (each stage is a
    radix-(p+1) butterfly)."""
    if K % k_intra:
        raise ValueError(f"k_intra={k_intra} must divide K={K}")
    I, G = k_intra, K // k_intra
    radix = p + 1
    for sz in (I, G):
        if radix ** ceil_log(sz, radix) != sz:
            raise ValueError(f"stage size {sz} is not a power of {radix}")
    if (q - 1) % K:
        raise ValueError(f"K={K} must divide q-1={q - 1}")
    f = Field(q)
    beta = f.root_of_unity(K)
    rev_i = digit_reversal_permutation(I, radix) if I > 1 else np.zeros(1, np.int64)
    rev_g = digit_reversal_permutation(G, radix) if G > 1 else np.zeros(1, np.int64)
    k = np.arange(K)
    g, i = k // I, k % I
    input_coeff = G * rev_i[i] + rev_g[g]
    output_index = i + I * g
    twiddle = f.pow(np.full(K, beta, dtype=np.uint64), rev_g[g] * i)
    return TwoLevelDFTPlan(
        K=K,
        p=p,
        k_intra=I,
        k_inter=G,
        q=q,
        input_coeff=input_coeff,
        output_index=output_index,
        twiddle=twiddle,
    )


def two_level_dft_matrix(plan: TwoLevelDFTPlan) -> np.ndarray:
    """The effective generator: M[k, k'] = D_K[input_coeff[k],
    output_index[k']] — a row/col permutation of the DFT matrix (still MDS),
    so ``simulate_two_level_dft(x) == x @ M`` bit-exactly."""
    from ..core.matrices import dft_matrix

    D = dft_matrix(Field(plan.q), plan.K)
    return D[plan.input_coeff][:, plan.output_index]


def simulate_two_level_dft(
    x: np.ndarray, plan: TwoLevelDFTPlan, field: Field
) -> tuple[np.ndarray, SimStats]:
    """Both butterfly stages message-by-message on one interpreter: every
    group's (resp. stride-column's) butterfly shares rounds, so C1 = C2 =
    log I + log G is measured globally under the p-port constraints."""
    return interpret(plan.to_ir(), x, field)


# ---------------------------------------------------------------------------
# recursive multi-level Cooley–Tukey DFT (K = Π K_level)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MultiLevelDFTPlan:
    """Recursive Cooley–Tukey factorization over ``levels`` (innermost
    first, each a power of p+1, Π = K): one radix-(p+1) butterfly stage per
    level over that level's coordinate, with a diagonal twiddle applied
    before each stage — C1 = C2 = Σ_j log_{p+1} K_j = log_{p+1} K, the
    structured analogue of :class:`MultiLevelPlan`.

    Built by iterating the verified two-level identity β^{nk} = ω_I^{n1·k1} ·
    β^{n2·k1} · ω_G^{n2·k2}: the inter factor DFT_G is itself factored over
    ``levels[1:]`` (the field's canonical roots nest exactly —
    ``root_of_unity(G) = root_of_unity(K)^I``). Relabelings compose "up to
    permutation" exactly as in the two-level case: device k holds source
    coefficient ``input_coeff[k]`` and finishes with X[``output_index[k]``];
    :func:`multilevel_dft_matrix` is the effective generator.

    This plan has NO bespoke simulator/lowering/executor: it compiles
    straight to ScheduleIR (``to_ir``), so simulation is
    ``core.simulator.interpret``, pricing is ``topo.lower.lower``, and
    execution is ``dist.collectives.ir_encode``."""

    K: int
    p: int
    q: int
    levels: tuple[int, ...]
    input_coeff: np.ndarray  # (K,)
    output_index: np.ndarray  # (K,)
    stage_twiddles: tuple  # per level: (K,) uint64 diagonal applied pre-stage

    @property
    def c1(self) -> int:
        return sum(ceil_log(v, self.p + 1) for v in self.levels)

    @property
    def c2(self) -> int:
        return self.c1  # every stage is a butterfly: 1 element per round

    @property
    def algorithm(self) -> str:
        return "multilevel-dft"

    def to_ir(self):
        from ..core.ir import LocalOp, ScheduleIR, embed_parallel, ir_butterfly

        K, p, q = self.K, self.p, self.q
        steps: list = []
        stride = 1
        for j, nj in enumerate(self.levels):
            tw = np.zeros((K, 1, 1), dtype=np.uint64)
            tw[:, 0, 0] = self.stage_twiddles[j]
            steps.append(LocalOp((0,), (0,), tw))
            if nj > 1:
                sub = ir_butterfly(plan_butterfly(nj, p, q))
                maps = []
                for hi in range(K // (stride * nj)):
                    for lo in range(stride):
                        maps.append(hi * stride * nj + lo + np.arange(nj) * stride)
                steps += embed_parallel(sub, K, maps)
            stride *= nj
        return ScheduleIR("multilevel-dft", K, p, tuple(steps))


def plan_multilevel_dft(K: int, p: int, q: int, levels) -> MultiLevelDFTPlan:
    """Requires K | q−1 and every level a power of p+1 (trivial levels of
    size 1 are allowed — their stage has zero rounds and an all-ones twiddle
    that ``fuse_trivial_rounds`` removes)."""
    levels = tuple(int(v) for v in levels)
    radix = p + 1
    prod = 1
    for v in levels:
        prod *= v
    if not levels or prod != K or any(v < 1 for v in levels):
        raise ValueError(f"levels must be positive with Π levels = K: {levels}, K={K}")
    for v in levels:
        if radix ** ceil_log(v, radix) != v:
            raise ValueError(f"level size {v} is not a power of {radix}")
    if K > 1 and (q - 1) % K:
        raise ValueError(f"K={K} must divide q-1={q - 1}")
    f = Field(q)

    def build(lvls):
        n = 1
        for v in lvls:
            n *= v
        if len(lvls) == 1:
            I = lvls[0]
            rev = (
                digit_reversal_permutation(I, radix)
                if I > 1
                else np.zeros(1, dtype=np.int64)
            )
            return (
                rev.astype(np.int64),
                np.arange(I, dtype=np.int64),
                [np.ones(I, dtype=np.uint64)],
            )
        I = lvls[0]
        G = n // I
        sub_in, sub_out, sub_tw = build(lvls[1:])
        rev_i = (
            digit_reversal_permutation(I, radix)
            if I > 1
            else np.zeros(1, dtype=np.int64)
        )
        k = np.arange(n)
        g, i = k // I, k % I
        input_coeff = G * rev_i[i] + sub_in[g]
        output_index = i + I * sub_out[g]
        if n > 1:
            beta = f.root_of_unity(n)
            cross = f.pow(np.full(n, beta, dtype=np.uint64), sub_in[g] * i)
        else:
            cross = np.ones(n, dtype=np.uint64)
        tws = [np.ones(n, dtype=np.uint64), f.mul(cross, sub_tw[0][g])]
        for j in range(1, len(sub_tw)):
            tws.append(sub_tw[j][g].astype(np.uint64))
        return input_coeff, output_index, tws

    input_coeff, output_index, tws = build(levels)
    return MultiLevelDFTPlan(
        K=K,
        p=p,
        q=q,
        levels=levels,
        input_coeff=np.asarray(input_coeff, dtype=np.int64),
        output_index=np.asarray(output_index, dtype=np.int64),
        stage_twiddles=tuple(np.asarray(t, dtype=np.uint64) for t in tws),
    )


def multilevel_dft_matrix(plan: MultiLevelDFTPlan) -> np.ndarray:
    """The effective generator: M[k, k'] = D_K[input_coeff[k],
    output_index[k']] — a row/col permutation of the DFT matrix (still MDS),
    so ``interpret(plan.to_ir(), x, f) == x @ M`` bit-exactly."""
    from ..core.matrices import dft_matrix

    D = dft_matrix(Field(plan.q), plan.K)
    return D[plan.input_coeff][:, plan.output_index]
