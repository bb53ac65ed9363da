"""Lower round schedules onto topologies: message maps, hops, contention.

ONE deriver: every plan compiles to :class:`~repro_torch.core.ir.ScheduleIR`
(``plan.to_ir()``) and :func:`repro_torch.core.ir.ir_messages` expands the IR into
the explicit per-round message maps ``{(src, dst): elements}`` — the SAME
shape the cost-exact interpreter records in ``SimStats.round_messages``, so
every lowering is cross-checkable message-for-message against the exact
simulation (see tests/test_topo.py and tests/test_ir.py). A
:class:`LoweredSchedule` then prices itself on any
:class:`~repro_torch.topo.model.Topology` via the α-β estimator: per-round hop
counts, per-link contention, and estimated wall time.

The legacy per-family ``rounds_*`` helpers are thin wrappers over
``ir_messages(plan.to_ir())`` — the IR compilers mirror the simulators
exactly, including the small-K edge cases (self-sends skipped, duplicate
destinations deduplicated, dead slots never shipped): an analytically
recomputed schedule that disagrees with the simulation by even one message
is a bug, not an approximation.

Paper-notation glossary: ``K`` processors, ``p`` ports per round, ``C1`` =
round count, ``C2`` = Σ over rounds of the largest per-port message (field
elements); ``I``/``G`` the two-level k_intra × k_inter split; *digit-
reduction slots* — the §IV shoot's buffer layout, one slot per (p+1)-ary
numeral of the remaining target offset, round t zeroing digit t (see
``core.schedule.digit_reduction_slots``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.ir import ScheduleIR, ir_allgather, ir_messages
from ..core.schedule import ButterflyPlan, DrawLoosePlan, PrepareShootPlan

from .hierarchical import (
    HierarchicalPlan,
    MultiLevelPlan,
    RingPlan,
    TwoLevelDFTPlan,
    ring_rounds,  # noqa: F401  (compat re-export; itself IR-derived now)
)
from .model import TimeEstimate, Topology, round_link_loads, schedule_time


@dataclass(frozen=True)
class LoweredSchedule:
    """An algorithm's communication pattern, ready to price on a topology."""

    algorithm: str
    K: int
    p: int
    rounds: tuple  # per round: {(src, dst): elements}

    @property
    def c1(self) -> int:
        return len(self.rounds)

    @property
    def c2(self) -> int:
        return sum(max(r.values()) for r in self.rounds if r)

    def link_loads(self, topo: Topology) -> list[dict]:
        """Per round: {link: (n_messages, elements)} — the contention map."""
        return [round_link_loads(topo, r) for r in self.rounds]

    def round_hops(self, topo: Topology) -> list[int]:
        """Per round: the longest route (in links) any message takes."""
        return [
            max((topo.hops(s, d) for (s, d) in r), default=0) for r in self.rounds
        ]

    def time(self, topo: Topology, payload_elems: int = 1) -> TimeEstimate:
        return schedule_time(topo, list(self.rounds), payload_elems)


def lower_ir(ir: ScheduleIR) -> LoweredSchedule:
    """Any ScheduleIR → its priced message-map form (the ONE deriver)."""
    return LoweredSchedule(ir.algorithm, ir.K, ir.p, tuple(ir_messages(ir)))


def lower(plan, inverse: bool = False) -> LoweredSchedule:
    """Lower any schedule plan to its explicit round message maps by
    compiling it to ScheduleIR. Works for every plan with a ``to_ir`` —
    including new algorithms that never register a bespoke lowering."""
    if isinstance(plan, ButterflyPlan):
        return lower_ir(plan.to_ir(inverse=inverse))
    if not hasattr(plan, "to_ir"):
        raise TypeError(f"cannot lower {type(plan).__name__}")
    return lower_ir(plan.to_ir())


def lower_allgather(K: int, p: int) -> LoweredSchedule:
    return lower_ir(ir_allgather(K, p))


# ---------------------------------------------------------------------------
# per-algorithm compatibility wrappers (all route through the IR)
# ---------------------------------------------------------------------------


def rounds_prepare_shoot(plan: PrepareShootPlan) -> list[dict]:
    """§IV prepare-and-shoot (prepare forwards the whole residue buffer,
    shoot ships the live digit-t slices)."""
    return ir_messages(plan.to_ir())


def rounds_butterfly(plan: ButterflyPlan, inverse: bool = False) -> list[dict]:
    """§V-A butterfly: round t broadcasts 1 element to the p digit-t
    partners (the inverse runs the same pattern in reverse round order)."""
    return ir_messages(plan.to_ir(inverse=inverse))


def rounds_draw_loose(plan: DrawLoosePlan) -> list[dict]:
    """§V-B: Z parallel M-point prepare-and-shoots over stride-Z subgroups
    (merged round-by-round), then M parallel Z-point butterflies."""
    return ir_messages(plan.to_ir())


def rounds_allgather(K: int, p: int) -> list[dict]:
    """The optimal flat p-port all-gather baseline ((p+1)-ary doubling)."""
    return ir_messages(ir_allgather(K, p))


def rounds_hierarchical(plan: HierarchicalPlan) -> list[dict]:
    """Two-level universal encode: intra doubling gather inside each group,
    then the inter digit-reduction shoot across groups (live slots only)."""
    return ir_messages(plan.to_ir())


def rounds_multilevel(plan: MultiLevelPlan) -> list[dict]:
    """Recursive K = Π K_j encode: level-0 doubling gather, then one §IV
    digit-reduction shoot per outer level (innermost first)."""
    return ir_messages(plan.to_ir())


def rounds_two_level_dft(plan: TwoLevelDFTPlan) -> list[dict]:
    """Cooley–Tukey: intra butterfly within contiguous groups, then inter
    butterfly over stride-I columns (1 element per message throughout)."""
    return ir_messages(plan.to_ir())
