"""Differential tests of the port's host side — plans, the schedule IR and the
simulator — against the reference package.

Both planners get the same (K, p, q, seed); plans and IRs must be equal field
by field (arrays by shape, dtype and value), and the two interpreters must
give the same output and the same message statistics on the same seeded
input. Equality is exact (tolerance 0). Everything runs on the CPU.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import ir as rir
from repro.core import schedule as rsch
from repro.core import bounds as rbounds
from repro.core import matrices as rmat
from repro.core.field import M31, NTT, Field as RField
from repro.core.simulator import interpret as rinterpret
from repro_torch import convert
from repro_torch.core import bounds as pbounds
from repro_torch.core import ir as pir
from repro_torch.core import matrices as pmat
from repro_torch.core import schedule as psch
from repro_torch.core.field import Field as PField
from repro_torch.core.simulator import interpret as pinterpret

KS = (8, 12, 16)
PS = (1, 2)


def _values_equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and bool(np.array_equal(a, b))
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(_values_equal(x, y) for x, y in zip(a, b))
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return plans_equal(a, b)
    return a == b


def plans_equal(a, b) -> bool:
    """Field-by-field equality of two plans, IRs or IR steps, of either
    package (class names and every field must agree; arrays compare by
    shape, dtype and value)."""
    if type(a).__name__ != type(b).__name__:
        return False
    fa = [f.name for f in dataclasses.fields(a)]
    if fa != [f.name for f in dataclasses.fields(b)]:
        return False
    return all(_values_equal(getattr(a, n), getattr(b, n)) for n in fa)


def _A(K, q, seed):
    a = rmat.random_matrix(RField(q), K, seed=seed)
    assert np.array_equal(a, pmat.random_matrix(PField(q), K, seed=seed))
    return a


def _families():
    """(label, build(mod_sched, mod_ir, A) → (plan or None, ir), q, needs A)."""
    fams = []
    for K in KS:
        for p in PS:
            for q in (M31, NTT):
                fams.append((f"ps-{K}-{p}-{q & 0xffff:x}", K, p, q, "ps"))
            fams.append((f"allgather-{K}-{p}", K, p, M31, "allgather"))
            fams.append((f"draw-loose-{K}-{p}", K, p, NTT, "draw-loose"))
    for K, p, q in [(8, 1, NTT), (16, 1, NTT), (9, 2, M31)]:  # 9 | M31 - 1, not NTT - 1
        fams.append((f"butterfly-{K}-{p}", K, p, q, "butterfly"))
        fams.append((f"butterfly-inv-{K}-{p}", K, p, q, "butterfly-inv"))
    return fams


FAMILIES = _families()


def _build(sch, irm, K, p, q, kind, A):
    if kind == "ps":
        plan = sch.plan_prepare_shoot(K, p)
        return plan, plan.to_ir(A, q=q)
    if kind == "allgather":
        return None, irm.ir_allgather(K, p, A, q=q)
    if kind == "draw-loose":
        plan = sch.plan_draw_loose(K, p, q, seed=1)
        return plan, plan.to_ir()
    plan = sch.plan_butterfly(K, p, q)
    return plan, plan.to_ir(inverse=kind == "butterfly-inv")


@pytest.mark.parametrize("label,K,p,q,kind", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_plan_and_ir_equal_reference(label, K, p, q, kind):
    A = _A(K, q, seed=K + p)
    rplan, r_ir = _build(rsch, rir, K, p, q, kind, A)
    pplan, p_ir = _build(psch, pir, K, p, q, kind, A)
    if rplan is not None:
        assert plans_equal(pplan, rplan), "plans differ"
        assert (pplan.c1, pplan.c2) == (rplan.c1, rplan.c2)
        # carried across, the reference's plan is the port's own class and equal
        carried = convert.from_reference(rplan)
        assert type(carried) is type(pplan)
        assert plans_equal(carried, pplan)
        assert plans_equal(carried.to_ir(**({"A": A, "q": q} if kind == "ps" else
                                                    {"inverse": True} if kind == "butterfly-inv" else {})), p_ir)
    assert plans_equal(p_ir, r_ir), "IR steps/coefficients differ"
    assert pir.ir_messages(p_ir) == rir.ir_messages(r_ir)
    assert pir.ir_permute_count(p_ir) == rir.ir_permute_count(r_ir)
    assert (p_ir.c1, p_ir.c2) == (r_ir.c1, r_ir.c2)
    # the generic dispatch
    if kind == "ps":
        assert plans_equal(pir.to_ir(pplan, A=A, q=q), p_ir)
    # IR carried across round-trips and is the port's own class
    carried_ir = convert.from_reference(r_ir)
    assert isinstance(carried_ir, pir.ScheduleIR)
    assert all(isinstance(s, (pir.CommRound, pir.LocalOp)) for s in carried_ir.steps)
    assert plans_equal(carried_ir, p_ir)
    # rewrite passes agree too
    assert plans_equal(pir.fuse_trivial_rounds(p_ir), rir.fuse_trivial_rounds(r_ir))
    perm = np.random.default_rng(K).permutation(K)
    assert plans_equal(pir.relabel(p_ir, perm), rir.relabel(r_ir, perm))


@pytest.mark.parametrize("label,K,p,q,kind", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_interpret_equals_reference_interpret(label, K, p, q, kind):
    A = _A(K, q, seed=K + p)
    _, r_ir = _build(rsch, rir, K, p, q, kind, A)
    _, p_ir = _build(psch, pir, K, p, q, kind, A)
    x = rmat.random_vector(RField(q), K, seed=len(label))
    want, rstats = rinterpret(r_ir, x, RField(q))
    got, pstats = pinterpret(p_ir, x, PField(q))
    assert np.array_equal(got, want)
    assert dataclasses.asdict(pstats) == dataclasses.asdict(rstats)
    # and the port's interpreter on the reference's IR, carried across
    got2, _ = pinterpret(convert.from_reference(r_ir), x, PField(q))
    assert np.array_equal(got2, want)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("p", PS)
def test_schedule_helpers_equal_reference(K, p):
    rplan, pplan = rsch.plan_prepare_shoot(K, p), psch.plan_prepare_shoot(K, p)
    A = _A(K, M31, seed=3)
    assert np.array_equal(psch.coeff_mask(pplan), rsch.coeff_mask(rplan))
    assert np.array_equal(psch.shoot_coeff_tensor(pplan, A), rsch.shoot_coeff_tensor(rplan, A))
    for a, b in zip(psch.shoot_coeff_indices(pplan), rsch.shoot_coeff_indices(rplan)):
        assert np.array_equal(a, b)
    for t in range(1, pplan.Ts + 1):
        for rho in range(1, p + 1):
            for a, b in zip(psch.digit_reduction_slots(pplan.n, p, t, rho),
                            rsch.digit_reduction_slots(rplan.n, p, t, rho)):
                assert np.array_equal(a, b)
    assert psch.counted_c2(pplan) == rsch.counted_c2(rplan)
    assert psch.gather_rounds(K, p) == rsch.gather_rounds(K, p)


@pytest.mark.parametrize("K,radix", [(8, 2), (16, 2), (9, 3)])
def test_butterfly_group_perms_equal_reference(K, radix):
    H = {8: 3, 16: 4, 9: 2}[K]
    for t in range(H):
        for a, b in zip(psch.butterfly_group_perms(K, radix, t), rsch.butterfly_group_perms(K, radix, t)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("K", KS + (64, 65))
@pytest.mark.parametrize("p", PS)
def test_bounds_equal_reference(K, p):
    for name in ("ps_params", "lemma1_c1_lower", "lemma2_c2_lower", "theorem1_c1", "theorem1_c2",
                 "theorem1_c2_as_printed", "allgather_baseline_c1_c2", "direct_baseline_c1_c2"):
        assert getattr(pbounds, name)(K, p) == getattr(rbounds, name)(K, p), name
    assert pbounds.ceil_log(K, p + 1) == rbounds.ceil_log(K, p + 1)
    Kt = 3 * (p + 1) ** 2
    assert pbounds.theorem3_c1_c2(Kt, p, 3, 2) == rbounds.theorem3_c1_c2(Kt, p, 3, 2)
    assert pbounds.theorem4_c1_c2(Kt, p, 3, 2) == rbounds.theorem4_c1_c2(Kt, p, 3, 2)
    assert pbounds.CostModel().time(5, 9, 100) == rbounds.CostModel().time(5, 9, 100)


@pytest.mark.parametrize("q", [M31, NTT])
def test_matrices_equal_reference(q):
    fr, fp = RField(q), PField(q)
    pts = rmat.distinct_points(fr, 8, seed=2)
    assert np.array_equal(pts, pmat.distinct_points(fp, 8, seed=2))
    alphas = rmat.distinct_points(fr, 8, seed=3)
    assert np.array_equal(pmat.vandermonde(fp, pts), rmat.vandermonde(fr, pts))
    assert np.array_equal(pmat.lagrange_matrix(fp, alphas, pts), rmat.lagrange_matrix(fr, alphas, pts))
    assert np.array_equal(pmat.cauchy_matrix(fp, 6, seed=1), rmat.cauchy_matrix(fr, 6, seed=1))
    assert np.array_equal(pmat.random_vector(fp, (8, 3), seed=4), rmat.random_vector(fr, (8, 3), seed=4))
    assert np.array_equal(pmat.digit_reversal_permutation(27, 3), rmat.digit_reversal_permutation(27, 3))
    if q == NTT:
        assert np.array_equal(pmat.dft_matrix(fp, 16), rmat.dft_matrix(fr, 16))
        assert np.array_equal(pmat.butterfly_target_matrix(fp, 16, 2), rmat.butterfly_target_matrix(fr, 16, 2))
        rp, pp = rsch.plan_draw_loose(12, 1, q, seed=1), psch.plan_draw_loose(12, 1, q, seed=1)
        assert np.array_equal(psch.draw_loose_target_matrix(pp), rsch.draw_loose_target_matrix(rp))


def test_from_reference_rejects_what_it_does_not_know():
    with pytest.raises(TypeError):
        convert.from_reference(object())
    plan = psch.plan_prepare_shoot(8, 1)
    other = psch.plan_prepare_shoot(8, 2)
    assert not plans_equal(plan, other)
    assert not plans_equal(plan, psch.plan_butterfly(8, 1, NTT))
