"""Algorithm autotuner: pick the fastest encode schedule for a scenario.

Given (K, p, payload bytes, topology, generator kind) the tuner **enumerates
ScheduleIRs**: every applicable plan is compiled with ``plan.to_ir()``,
cleaned by ``fuse_trivial_rounds``, optionally rewritten by topology-aware
passes (``remap_digits`` on a 2D torus), and priced on the topology through
its IR message maps with the α-β estimator. The cheapest wins. Because
candidates are IRs rather than hand-registered callables, a new algorithm
participates the moment its plan compiles — no per-family lowering or
simulator registration. Related work shows the winner genuinely flips with
topology (ring networks favor neighbor-only schedules; two-level meshes
favor level-aligned ones), which is exactly what the estimator captures
through per-link contention.

Applicability matrix (the "universal promise" vs. structured generators):

* ``general``      — prepare-shoot, hierarchical, multilevel, allgather, ring
* ``vandermonde``  — the above + draw-loose
* ``dft``          — all of the above + butterfly + two-level and
  multi-level DFT

A candidate is an **(algorithm, pipeline)** pair: beyond the un-rewritten
compile of every applicable plan, the tuner asks the pass registry
(``topo.passes.pipelines_for``) which :class:`~repro_torch.topo.passes.PassPipeline`
applies to each compiled IR, applies it, prices the rewritten IR, and ranks
everything together. A pipelined candidate is named
``"<algorithm>+<pipeline>"`` (e.g. ``"butterfly+remap-digits"`` on a torus,
``"draw-loose+align-subgroups"`` on a hierarchy — hierarchical
draw-loose is exactly that pipeline stage, not a separate algorithm
family) and records the pipeline name in ``Candidate.pipeline``.

The ``multilevel`` / ``multilevel-dft`` candidates appear when the topology
is a :class:`~repro_torch.topo.model.Hierarchy` whose level product matches K: the
plan factorization is taken from the topology itself, so the schedule's
phases align with the hardware's levels by construction.

A ``measured`` override hook replaces predicted times with wall-clock
numbers (e.g. from traced encodes) without changing the
selection logic; ``topo.calibrate.fit_level_costs`` turns the same sweeps
into fitted per-level α/β.

Paper-notation glossary: ``K`` processors, ``p`` ports, ``C1`` rounds,
``C2`` per-port elements (paper §I); ``I``/``G`` the two-level k_intra ×
k_inter split; ``digit-reduction slots`` the §IV shoot buffer layout (one
slot per (p+1)-ary numeral of the remaining target offset).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..core.field import M31
from ..core.ir import ScheduleIR, fuse_trivial_rounds, ir_allgather
from ..core.schedule import plan_butterfly, plan_draw_loose, plan_prepare_shoot

from .hierarchical import (
    plan_hierarchical,
    plan_multilevel,
    plan_multilevel_dft,
    plan_ring,
    plan_two_level_dft,
)
from .lower import LoweredSchedule, lower_ir
from .model import Hierarchy, TimeEstimate, Topology, Torus2D, TwoLevel

GENERATOR_KINDS = ("general", "vandermonde", "dft")

# deterministic tie-break: structured algorithms first (they generalize
# less), flat-canonical schedules before their topology-rewritten or
# multi-level equivalents
_PREFERENCE = (
    "butterfly",
    "hierarchical-dft",
    "multilevel-dft",
    "draw-loose",
    "prepare-shoot",
    "hierarchical",
    "multilevel",
    "ring",
    "allgather",
)


def _preference_rank(base_algorithm: str) -> int:
    """Tie-break rank; unknown names (plugins, renamed families) sort last
    instead of raising — the historical ``_PREFERENCE.index`` blew up with
    ValueError on any name outside the hardcoded tuple."""
    try:
        return _PREFERENCE.index(base_algorithm)
    except ValueError:
        return len(_PREFERENCE)


@dataclass(frozen=True)
class Candidate:
    algorithm: str  # full name: "<base>" or "<base>+<pipeline>"
    plan: object  # schedule plan (None for the plan-less allgather baseline)
    ir: ScheduleIR  # the compiled (and pass-rewritten) schedule
    lowered: LoweredSchedule
    estimate: TimeEstimate
    measured_time: float | None = None
    pipeline: str = ""  # PassPipeline name; "" = un-rewritten compile
    base_algorithm: str = ""  # plan family name without the pipeline suffix

    @property
    def c1(self) -> int:
        return self.lowered.c1

    @property
    def c2(self) -> int:
        return self.lowered.c2

    @property
    def predicted_time(self) -> float:
        return self.estimate.total

    @property
    def time(self) -> float:
        return self.measured_time if self.measured_time is not None else self.estimate.total


@dataclass(frozen=True)
class TuneResult:
    chosen: Candidate
    candidates: tuple[Candidate, ...]  # sorted fastest-first

    @property
    def algorithm(self) -> str:
        return self.chosen.algorithm


def _split_for(topo: Topology, K: int) -> int:
    """k_intra for the two-level hierarchical schedules: the topology's own
    fast-domain size when it has one (for a Hierarchy, everything below the
    outermost level), else the most balanced divisor."""
    if isinstance(topo, TwoLevel) and K % topo.k_intra == 0:
        return topo.k_intra
    if isinstance(topo, Hierarchy) and topo.n == K and K % topo.levels[-1] == 0:
        return K // topo.levels[-1]
    from .model import _near_square

    return _near_square(K)


def _levels_for(topo: Topology, K: int) -> tuple[int, ...] | None:
    """Factorization for the multi-level candidates: the Hierarchy's own
    levels when they multiply to K and at least two are non-trivial."""
    if isinstance(topo, Hierarchy) and topo.n == K:
        if sum(1 for k in topo.levels if k > 1) >= 2:
            return topo.levels
    return None


def _priced(ir: ScheduleIR, low: LoweredSchedule, topo: Topology, payload_elems: int):
    """Comm estimate from the lowered schedule plus the MAC-priced local
    compute (with ``pipeline_rounds``' overlap credit) — ``total`` carries
    both terms, ``per_round`` stays comm-only (the round-count contracts the
    tests pin)."""
    from .passes import ir_compute_time

    est = low.time(topo, payload_elems)
    extra = ir_compute_time(ir, topo, payload_elems)
    return replace(est, total=est.total + extra) if extra else est


def candidates_for(
    K: int,
    p: int,
    topo: Topology,
    *,
    q: int = M31,
    payload_elems: int = 1,
    generator: str = "general",
    seed: int = 0,
    pipelines: bool = True,
) -> list[Candidate]:
    if generator not in GENERATOR_KINDS:
        raise ValueError(f"generator must be one of {GENERATOR_KINDS}")

    def cand(plan, ir=None):
        ir = fuse_trivial_rounds(ir if ir is not None else plan.to_ir())
        low = lower_ir(ir)
        return Candidate(
            algorithm=low.algorithm,
            plan=plan,
            ir=ir,
            lowered=low,
            estimate=_priced(ir, low, topo, payload_elems),
            base_algorithm=low.algorithm,
        )

    out = [
        cand(plan_prepare_shoot(K, p)),
        cand(None, ir=ir_allgather(K, p)),
        cand(plan_ring(K, p)),
    ]
    k_intra = _split_for(topo, K)
    if 1 < k_intra < K:
        out.append(cand(plan_hierarchical(K, p, k_intra)))
    levels = _levels_for(topo, K)
    if levels is not None:
        out.append(cand(plan_multilevel(K, p, levels)))
    if generator in ("vandermonde", "dft"):
        try:
            out.append(cand(plan_draw_loose(K, p, q, seed=seed)))
        except (ValueError, RuntimeError):
            pass  # field too small / no valid phi — not applicable
    if generator == "dft":
        try:
            out.append(cand(plan_butterfly(K, p, q)))
        except ValueError:
            pass  # K not a power of p+1 or K ∤ q-1
        for ki in dict.fromkeys((k_intra, _dft_split(K, p))):
            if ki is None or not (1 < ki < K):
                continue
            try:
                out.append(cand(plan_two_level_dft(K, p, q, ki)))
                break
            except ValueError:
                continue
        if levels is not None:
            try:
                out.append(cand(plan_multilevel_dft(K, p, q, levels)))
            except ValueError:
                pass  # levels not powers of p+1 or K ∤ q-1
    if pipelines:
        out += _pipeline_candidates(out, topo, payload_elems)
    return out


def _pipeline_candidates(
    base: list[Candidate], topo: Topology, payload_elems: int
) -> list[Candidate]:
    """One extra candidate per (base candidate, applicable pipeline) whose
    rewrite actually changed the IR — the (algorithm, pipeline) half of the
    search space. The base plan is kept so downstream consumers (profiles,
    executors) can recompile ``plan.to_ir(A)`` and re-apply the named
    pipeline with coefficients baked in."""
    from .passes import pipelines_for

    out = []
    for c in base:
        for pl in pipelines_for(c.ir, topo):
            try:
                rewritten = pl.apply(c.ir, topo, payload_elems)
            except ValueError:
                continue  # predicate passed but the rewrite found no embedding
            if rewritten is c.ir:
                continue  # no-op on this IR — pricing it would duplicate base
            rewritten = replace(
                rewritten, algorithm=f"{c.base_algorithm}+{pl.name}"
            )
            low = lower_ir(rewritten)
            out.append(
                Candidate(
                    algorithm=rewritten.algorithm,
                    plan=c.plan,
                    ir=rewritten,
                    lowered=low,
                    estimate=_priced(rewritten, low, topo, payload_elems),
                    pipeline=pl.name,
                    base_algorithm=c.base_algorithm,
                )
            )
    return out


def _dft_split(K: int, p: int) -> int | None:
    """Balanced K = I·G with both factors powers of p+1 (needs K a power)."""
    from ..core.bounds import ceil_log

    radix = p + 1
    H = ceil_log(K, radix)
    if radix**H != K or H < 2:
        return None
    return radix ** (H // 2)


def autotune(
    K: int,
    p: int,
    payload_bytes: int,
    topo: Topology,
    *,
    q: int = M31,
    generator: str = "general",
    measured: dict[str, float] | None = None,
    seed: int = 0,
    pipelines: bool = True,
) -> TuneResult:
    """Pick the cheapest applicable (algorithm, pipeline) pair for this
    scenario. ``measured`` maps full candidate name → measured seconds,
    overriding the α-β prediction."""
    payload_elems = max(1, payload_bytes // 4)
    cands = candidates_for(
        K,
        p,
        topo,
        q=q,
        payload_elems=payload_elems,
        generator=generator,
        seed=seed,
        pipelines=pipelines,
    )
    if measured:
        cands = [
            replace(c, measured_time=measured.get(c.algorithm, c.measured_time))
            for c in cands
        ]
    # ties: any un-rewritten compile before any pipelined rewrite (a pipeline
    # must strictly win on price to be chosen), then the preferred family
    ranked = sorted(
        cands,
        key=lambda c: (
            c.time,
            c.pipeline != "",
            _preference_rank(c.base_algorithm or c.algorithm),
            c.pipeline,
        ),
    )
    return TuneResult(chosen=ranked[0], candidates=tuple(ranked))
