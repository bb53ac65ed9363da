"""Differential tests of the port's topology layer (``repro_torch.topo``)
against the reference's (``repro.topo``), on the CPU.

Both packages get the same arguments over the grids of ``tests/test_topo.py``
and must agree: routes and link costs for every topology, α-β prices, every
``plan_*`` (field by field, also through ``convert.from_reference``) and its
``to_ir`` step by step with coefficients, every ``simulate_*`` output and
statistic, every registered pass pipeline applied to the same IR on the same
topology, ``lower_ir`` message maps, ``fit_level_costs`` on the same
measurements and the autotuner's candidate tables. Integers are identical;
floats come from the same numpy code in the same order and are compared with
``==`` (no tolerance).
"""

import dataclasses
import functools
import importlib
import json

import numpy as np
import pytest

from repro.core.field import M31, NTT, Field
from repro.core.matrices import random_matrix, random_vector
from repro.core.schedule import plan_butterfly as r_plan_butterfly
from repro.core.schedule import plan_draw_loose as r_plan_draw_loose
from repro.core.schedule import plan_prepare_shoot as r_plan_prepare_shoot
from repro.core.ir import ir_allgather as r_ir_allgather
from repro import topo as rt
from repro.topo import calibrate as rcal
from repro.topo import hierarchical as rh
from repro.topo import passes as rpass
from repro_torch import topo as pt
from repro_torch.convert import from_reference
from repro_torch.core.field import Field as PField
from repro_torch.core.ir import ir_allgather as p_ir_allgather
from repro_torch.core.schedule import plan_butterfly as p_plan_butterfly
from repro_torch.core.schedule import plan_draw_loose as p_plan_draw_loose
from repro_torch.core.schedule import plan_prepare_shoot as p_plan_prepare_shoot
from repro_torch.topo import calibrate as pcal
from repro_torch.topo import hierarchical as ph
from repro_torch.topo import passes as ppass
from test_torch_plans import _values_equal as same

# the modules (each package's ``topo`` exports a function of the same name)
rlow = importlib.import_module("repro.topo.lower")
plow = importlib.import_module("repro_torch.topo.lower")

F = Field(M31)


def _topologies(mod):
    """The same topologies built from either package's ``model``."""
    return {
        "flat": mod.FullyConnected(8),
        "flat-16": mod.FullyConnected(16, cost=mod.LinkCost(alpha=1e-6, beta=1e-9)),
        "ring": mod.Ring(8),
        "ring-gamma": mod.Ring(16, cost=mod.LinkCost(1e-6, 4.0 / 50e9, gamma=0.5)),
        "torus2d": mod.Torus2D(4, 4),
        "torus3d": mod.Torus3D(depth=2, rows=2, cols=4),
        "two-level": mod.TwoLevel(k_intra=4, k_inter=2),
        "two-level-16": mod.TwoLevel(k_intra=4, k_inter=4),
        "hier-2": mod.Hierarchy(levels=(4, 2), costs=(mod.ICI, mod.DCI)),
        "hier-3": mod.Hierarchy(levels=(2, 2, 2)),
        "hier-16": mod.Hierarchy(levels=(4, 2, 2)),
        "hier-12": mod.Hierarchy(levels=(4, 3)),
    }


R_TOPOS, P_TOPOS = _topologies(rt), _topologies(pt)


# ---------------------------------------------------------------------------
# topology model: routes, link costs, prices
# ---------------------------------------------------------------------------


def test_model_constants_and_exports_match():
    assert pt.ICI == from_reference(rt.ICI) and pt.DCI == from_reference(rt.DCI)
    assert same(pt.ICI, rt.ICI) and same(pt.DCI, rt.DCI)
    from repro.topo import model as rm
    from repro_torch.topo import model as pm

    assert (pm.MAC_SECONDS, pm.ADD_WEIGHT) == (rm.MAC_SECONDS, rm.ADD_WEIGHT)
    import repro.topo as rpkg
    import repro_torch.topo as ppkg

    ref_names = {n for n in dir(rpkg) if not n.startswith("_")} - {
        "autotune", "calibrate", "hierarchical", "lower", "model", "passes"
    }
    assert ref_names <= set(dir(ppkg))
    for n in range(1, 5):
        assert same(pt.default_level_costs(n), rt.default_level_costs(n))
    for K in (2, 4, 6, 7, 8, 12, 16, 30):
        assert pt.default_levels(K) == rt.default_levels(K)
    for name, kw in [("flat", {}), ("ring", {}), ("two-level", {"k_intra": 4}),
                     ("torus", {"k_intra": 3}), ("hierarchy", {})]:
        K = 12 if name == "torus" else 8
        assert same(pt.make_topology(name, K, **kw), rt.make_topology(name, K, **kw))
    assert same(pt.make_topology("torus3d", 16, levels=(4, 2, 2)),
                       rt.make_topology("torus3d", 16, levels=(4, 2, 2)))


@pytest.mark.parametrize("name", list(R_TOPOS))
def test_routing_link_costs_and_prices_match(name):
    rtop, ptop = R_TOPOS[name], P_TOPOS[name]
    assert same(from_reference(rtop), ptop)
    assert ptop.n == rtop.n
    K = ptop.n
    for s in range(K):
        for d in range(K):
            route = ptop.route(s, d)
            assert route == rtop.route(s, d)
            assert ptop.hops(s, d) == rtop.hops(s, d)
            for link in route:
                assert same(ptop.link_cost(link), rtop.link_cost(link))
    # prices of a few compiled schedules on this topology
    scheds = [(r_plan_prepare_shoot(K, 1), p_plan_prepare_shoot(K, 1)),
              (r_ir_allgather(K, 2), p_ir_allgather(K, 2))]
    if K % 4 == 0:
        scheds.append((rh.plan_hierarchical(K, 1, 4), ph.plan_hierarchical(K, 1, 4)))
    for r_obj, p_obj in scheds:
        r_low = rlow.lower_ir(r_obj) if hasattr(r_obj, "steps") else rlow.lower(r_obj)
        p_low = plow.lower_ir(p_obj) if hasattr(p_obj, "steps") else plow.lower(p_obj)
        assert p_low.rounds == r_low.rounds
        assert p_low.link_loads(ptop) == r_low.link_loads(rtop)
        assert p_low.round_hops(ptop) == r_low.round_hops(rtop)
        for pay in (1, 7, 1 << 16):
            assert same(p_low.time(ptop, pay), r_low.time(rtop, pay))
            assert same(pt.schedule_time(ptop, list(p_low.rounds), pay),
                               rt.schedule_time(rtop, list(r_low.rounds), pay))


def test_hierarchy_and_topology_validation_match():
    for mod in (rt, pt):
        with pytest.raises(ValueError):
            mod.Hierarchy(levels=(4, 0))
        with pytest.raises(ValueError):
            mod.Hierarchy(levels=(4, 2), costs=(mod.ICI,))
        with pytest.raises(ValueError):
            mod.make_topology("hierarchy", 8, levels=(2, 2))
        with pytest.raises(ValueError):
            mod.make_topology("moebius", 8)


# ---------------------------------------------------------------------------
# plans, coefficient tensors, message sizes, IRs
# ---------------------------------------------------------------------------

HIER = [(8, 2, 1), (8, 4, 1), (12, 3, 1), (12, 4, 2), (16, 4, 1), (15, 3, 2), (8, 4, 2), (16, 4, 2)]
MULTI = [(8, (2, 2, 2), 1), (8, (2, 2, 2), 2), (12, (3, 2, 2), 1), (16, (2, 2, 2, 2), 1),
         (16, (4, 2, 2), 2), (24, (2, 3, 4), 1), (30, (5, 3, 2), 2), (24, (2, 3, 4), 2),
         (16, (4, 4), 1), (16, (4, 4, 1), 1), (12, (3, 1, 4), 1)]
RING = [(8, 2), (9, 2), (8, 1), (5, 3)]
TLDFT = [(8, 2, 1, NTT), (8, 4, 1, NTT), (16, 4, 1, NTT), (9, 3, 2, M31)]
MLDFT = [(8, (2, 2, 2), 1, NTT), (16, (2, 2, 4), 1, NTT), (16, (4, 4), 1, NTT), (9, (3, 3), 2, M31)]


def _check_ir(p_ir, r_ir):
    assert same(from_reference(r_ir), p_ir)
    assert len(p_ir.steps) == len(r_ir.steps)
    for a, b in zip(p_ir.steps, r_ir.steps):  # step by step, coefficients included
        assert same(a, b)


@pytest.mark.parametrize("K,I,p", HIER)
def test_hierarchical_plan_ir_and_coefficients_match(K, I, p):
    r_plan, p_plan = rh.plan_hierarchical(K, p, I), ph.plan_hierarchical(K, p, I)
    assert same(p_plan, r_plan) and same(from_reference(r_plan), p_plan)
    assert (p_plan.c1, p_plan.c2, p_plan.algorithm) == (r_plan.c1, r_plan.c2, r_plan.algorithm)
    for t in range(1, len(p_plan.inter_shifts) + 1):
        for rho in range(1, p + 1):
            assert ph.hier_shoot_message_size(p_plan, t, rho) == rh.hier_shoot_message_size(r_plan, t, rho)
            for a, b in zip(ph.hier_shoot_slots(p_plan.n_inter, p, t, rho),
                            rh.hier_shoot_slots(r_plan.n_inter, p, t, rho)):
                assert np.array_equal(a, b)
    for q in (M31, NTT):
        A = random_matrix(Field(q), K, seed=K + I)
        assert np.array_equal(ph.hierarchical_coeff_tensor(p_plan, A), rh.hierarchical_coeff_tensor(r_plan, A))
        _check_ir(p_plan.to_ir(A, q=q), r_plan.to_ir(A, q=q))
    _check_ir(p_plan.to_ir(), r_plan.to_ir())  # structure only


@pytest.mark.parametrize("K,levels,p", MULTI)
def test_multilevel_plan_ir_and_coefficients_match(K, levels, p):
    r_plan, p_plan = rh.plan_multilevel(K, p, levels), ph.plan_multilevel(K, p, levels)
    assert same(p_plan, r_plan) and same(from_reference(r_plan), p_plan)
    assert (p_plan.c1, p_plan.c2) == (r_plan.c1, r_plan.c2)
    assert np.array_equal(ph.multilevel_live_mask(p_plan), rh.multilevel_live_mask(r_plan))
    for j in range(1, len(levels)):
        for t in range(1, len(p_plan.level_shifts[j - 1]) + 1):
            for rho in range(1, p + 1):
                assert ph.multilevel_message_size(p_plan, j, t, rho) == rh.multilevel_message_size(r_plan, j, t, rho)
                for a, b in zip(ph.multilevel_level_slots(p_plan, j, t, rho),
                                rh.multilevel_level_slots(r_plan, j, t, rho)):
                    assert np.array_equal(a, b)
    A = random_matrix(F, K, seed=K + levels[0])
    assert np.array_equal(ph.multilevel_coeff_tensor(p_plan, A), rh.multilevel_coeff_tensor(r_plan, A))
    _check_ir(p_plan.to_ir(A), r_plan.to_ir(A))


@pytest.mark.parametrize("K,p", RING)
def test_ring_plan_ir_and_rounds_match(K, p):
    r_plan, p_plan = rh.plan_ring(K, p), ph.plan_ring(K, p)
    assert same(p_plan, r_plan) and same(from_reference(r_plan), p_plan)
    assert ph.ring_rounds(p_plan) == rh.ring_rounds(r_plan)
    A = random_matrix(F, K, seed=K)
    _check_ir(p_plan.to_ir(A), r_plan.to_ir(A))


@pytest.mark.parametrize("K,I,p,q", TLDFT)
def test_two_level_dft_plan_ir_and_matrix_match(K, I, p, q):
    r_plan, p_plan = rh.plan_two_level_dft(K, p, q, I), ph.plan_two_level_dft(K, p, q, I)
    assert same(p_plan, r_plan) and same(from_reference(r_plan), p_plan)
    assert np.array_equal(ph.two_level_dft_matrix(p_plan), rh.two_level_dft_matrix(r_plan))
    _check_ir(p_plan.to_ir(), r_plan.to_ir())


@pytest.mark.parametrize("K,levels,p,q", MLDFT)
def test_multilevel_dft_plan_ir_and_matrix_match(K, levels, p, q):
    r_plan, p_plan = rh.plan_multilevel_dft(K, p, q, levels), ph.plan_multilevel_dft(K, p, q, levels)
    assert same(p_plan, r_plan) and same(from_reference(r_plan), p_plan)
    assert np.array_equal(ph.multilevel_dft_matrix(p_plan), rh.multilevel_dft_matrix(r_plan))
    _check_ir(p_plan.to_ir(), r_plan.to_ir())


# ---------------------------------------------------------------------------
# the simulators
# ---------------------------------------------------------------------------


def _sims():
    cases = []
    for K, I, p in HIER:
        cases.append((f"hier-{K}-{I}-{p}", "hierarchical", (K, p, I), M31))
    for K, levels, p in MULTI:
        cases.append((f"multi-{K}-{levels}-{p}", "multilevel", (K, p, levels), M31))
    for K, p in RING:
        cases.append((f"ring-{K}-{p}", "ring", (K, p), M31))
    for K, I, p, q in TLDFT:
        cases.append((f"tldft-{K}-{I}-{p}", "two_level_dft", (K, p, q, I), q))
    return cases


SIMS = _sims()


def _simulate(mod, kind, args, x, A, f):
    if kind == "hierarchical":
        return mod.simulate_hierarchical(x, A, mod.plan_hierarchical(*args), f)
    if kind == "multilevel":
        return mod.simulate_multilevel(x, A, mod.plan_multilevel(*args), f)
    if kind == "ring":
        return mod.simulate_ring_encode(x, A, mod.plan_ring(*args), f)
    return mod.simulate_two_level_dft(x, mod.plan_two_level_dft(*args), f)


@pytest.mark.parametrize("idx", range(len(SIMS)), ids=[c[0] for c in SIMS])
def test_simulators_match(idx):
    label, kind, args, q = SIMS[idx]
    f = Field(q)
    K = args[0]
    A = random_matrix(f, K, seed=K + 3)
    x = random_vector(f, K, seed=len(label))
    r_out, r_st = _simulate(rh, kind, args, x, A, f)
    p_out, p_st = _simulate(ph, kind, args, x, A, PField(q))
    assert p_out.dtype == r_out.dtype and np.array_equal(p_out, r_out)
    assert (p_st.C1, p_st.C2) == (r_st.C1, r_st.C2)
    assert p_st.round_messages == r_st.round_messages


# ---------------------------------------------------------------------------
# lowering and the pass pipelines
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _family_irs(rpkg: bool, K: int):
    """Compiled IRs of every family at K (coefficients where a matrix is
    needed), built with one package's planners."""
    h = rh if rpkg else ph
    ps = r_plan_prepare_shoot if rpkg else p_plan_prepare_shoot
    bf = r_plan_butterfly if rpkg else p_plan_butterfly
    dl = r_plan_draw_loose if rpkg else p_plan_draw_loose
    ag = r_ir_allgather if rpkg else p_ir_allgather
    A = random_matrix(F, K, seed=K)
    irs = {
        "prepare-shoot": ps(K, 1).to_ir(A),
        "prepare-shoot-p2": ps(K, 2).to_ir(A),
        "prepare-shoot-structure": ps(K, 1).to_ir(),
        "allgather": ag(K, 1, A),
        "draw-loose": dl(K, 1, NTT, seed=1).to_ir(),
        "ring": h.plan_ring(K, 2).to_ir(A),
    }
    if K & (K - 1) == 0:
        irs["butterfly"] = bf(K, 1, NTT).to_ir()
        irs["butterfly-inverse"] = bf(K, 1, NTT).to_ir(inverse=True)
        irs["two-level-dft"] = h.plan_two_level_dft(K, 1, NTT, 4).to_ir()
        irs["multilevel-dft"] = h.plan_multilevel_dft(K, 1, NTT, (2, 2, K // 4)).to_ir()
    if K % 4 == 0:
        irs["hierarchical"] = h.plan_hierarchical(K, 1, 4).to_ir(A)
        irs["multilevel"] = h.plan_multilevel(K, 1, (4, 2, K // 8) if K % 8 == 0 else (4, K // 4)).to_ir(A)
    return irs


PASS_CASES = [(K, name, topo) for K, topos in ((8, ("flat", "ring", "two-level", "hier-3")),
                                               (12, ("hier-12",)),
                                               (16, ("flat-16", "ring-gamma", "torus2d", "torus3d",
                                                     "two-level-16", "hier-16")))
              for topo in topos for name in _family_irs(True, K)]


@pytest.mark.parametrize("K,family,topo_name", PASS_CASES)
def test_every_pipeline_rewrites_the_same_ir_alike(K, family, topo_name):
    r_ir, p_ir = _family_irs(True, K)[family], _family_irs(False, K)[family]
    _check_ir(p_ir, r_ir)
    rtop, ptop = R_TOPOS[topo_name], P_TOPOS[topo_name]
    r_low, p_low = rlow.lower_ir(r_ir), plow.lower_ir(p_ir)
    assert p_low.rounds == r_low.rounds and (p_low.c1, p_low.c2) == (r_low.c1, r_low.c2)
    pay = 1 << 16
    assert ppass.ir_time(p_ir, ptop, pay) == rpass.ir_time(r_ir, rtop, pay)
    assert ppass.ir_compute_time(p_ir, ptop, pay) == rpass.ir_compute_time(r_ir, rtop, pay)
    assert [pl.name for pl in ppass.pipelines_for(p_ir, ptop)] == [
        pl.name for pl in rpass.pipelines_for(r_ir, rtop)
    ]
    assert list(ppass.PIPELINES) == list(rpass.PIPELINES)
    assert list(ppass.PASSES) == list(rpass.PASSES)
    for name, pl in ppass.PIPELINES.items():
        rpl = rpass.PIPELINES[name]
        assert pl.applicable(p_ir, ptop) == rpl.applicable(r_ir, rtop)
        if not pl.applicable(p_ir, ptop):
            continue
        for payload in (1, pay):
            r_new = rpl.apply(r_ir, rtop, payload)
            p_new = pl.apply(p_ir, ptop, payload)
            _check_ir(p_new, r_new)
            assert (p_new is p_ir) == (r_new is r_ir)


@pytest.mark.parametrize("K", [8, 12, 16])
def test_lower_ir_message_maps_match(K):
    for family, r_ir in _family_irs(True, K).items():
        p_ir = _family_irs(False, K)[family]
        assert plow.lower_ir(p_ir).rounds == rlow.lower_ir(r_ir).rounds, family
    assert plow.lower_allgather(K, 2).rounds == rlow.lower_allgather(K, 2).rounds
    for r_plan, p_plan in [(r_plan_prepare_shoot(K, 1), p_plan_prepare_shoot(K, 1)),
                           (rh.plan_ring(K, 1), ph.plan_ring(K, 1))]:
        assert plow.lower(p_plan).rounds == rlow.lower(r_plan).rounds
    from repro.topo.lower import rounds_hierarchical as r_rh, rounds_multilevel as r_rm
    from repro_torch.topo.lower import rounds_hierarchical as p_rh, rounds_multilevel as p_rm

    assert p_rh(ph.plan_hierarchical(K, 1, 4)) == r_rh(rh.plan_hierarchical(K, 1, 4))
    assert p_rm(ph.plan_multilevel(K, 2, (2, 2, K // 4))) == r_rm(rh.plan_multilevel(K, 2, (2, 2, K // 4)))


# ---------------------------------------------------------------------------
# calibration fit and the autotuner
# ---------------------------------------------------------------------------


def _measurements(topo_mod, cal_mod, levels, seed):
    rng = np.random.default_rng(seed)
    topo = topo_mod.Hierarchy(levels=levels)
    K = int(np.prod(levels))
    A = random_matrix(F, K, seed=seed)
    plans = [rh.plan_multilevel if topo_mod is rt else ph.plan_multilevel,
             rh.plan_hierarchical if topo_mod is rt else ph.plan_hierarchical]
    ms = []
    for payload in (64, 1024, 16384):
        for mk in plans:
            plan = mk(K, 1, levels) if mk.__name__ == "plan_multilevel" else mk(K, 1, levels[0])
            low = (rlow if topo_mod is rt else plow).lower_ir(plan.to_ir(A))
            ms.append({"wall_s": float(rng.uniform(1e-4, 1e-2)), "payload_elems": payload,
                       "rounds": cal_mod.round_features(list(low.rounds), topo)})
    return ms


@pytest.mark.parametrize("levels", [(2, 2, 2), (4, 2), (4, 2, 2)])
def test_round_features_and_fit_level_costs_match(levels, tmp_path):
    r_ms = _measurements(rt, rcal, levels, seed=len(levels))
    p_ms = _measurements(pt, pcal, levels, seed=len(levels))
    assert p_ms == r_ms
    n = len(levels)
    r_fit, p_fit = rcal.fit_level_costs(r_ms, n), pcal.fit_level_costs(p_ms, n)
    assert same(p_fit, r_fit)  # floats equal with ==
    with pytest.raises(ValueError):
        pcal.fit_level_costs(p_ms[: 2 * n - 1], n)
    # the same record read by both loaders
    path = tmp_path / "cal.json"
    path.write_text(json.dumps({"calibration": {"samples": r_ms}}))
    assert same(pcal.load_fitted_costs(str(path)), rcal.load_fitted_costs(str(path)))
    assert pcal.load_fitted_costs(str(tmp_path / "absent.json")) is None


def test_port_calibration_default_is_its_own_record():
    assert pcal.DEFAULT_CALIBRATION_PATH.endswith("results/BENCH_torch_topology.json")
    assert pcal.DEFAULT_CALIBRATION_PATH != rcal.DEFAULT_CALIBRATION_PATH


def _table(res):
    return [(c.algorithm, c.base_algorithm, c.pipeline, c.c1, c.c2, c.predicted_time, c.time)
            for c in res.candidates]


AUTOTUNE_CASES = [
    (16, 1, 4096, "flat-16", NTT, "dft"),
    (16, 1, 4096, "ring-gamma", NTT, "dft"),
    (16, 1, 4096, "two-level-16", NTT, "dft"),
    (16, 1, 4096, "hier-16", NTT, "dft"),
    (16, 1, 65536, "two-level-16", M31, "general"),
    (16, 1, 65536, "torus2d", NTT, "dft"),
    (16, 1, 65536, "torus3d", NTT, "dft"),
    (12, 1, 65536, "hier-12", NTT, "vandermonde"),
    (16, 2, 1 << 20, "ring-gamma", M31, "general"),
    (8, 1, 4096, "flat", M31, "general"),
]


@pytest.mark.parametrize("K,p,payload,topo_name,q,generator", AUTOTUNE_CASES)
def test_autotune_candidate_tables_match(K, p, payload, topo_name, q, generator):
    r = rt.autotune(K, p, payload, R_TOPOS[topo_name], q=q, generator=generator)
    t = pt.autotune(K, p, payload, P_TOPOS[topo_name], q=q, generator=generator)
    assert _table(t) == _table(r)
    assert t.algorithm == r.algorithm
    for a, b in zip(t.candidates, r.candidates):
        _check_ir(a.ir, b.ir)
    measured = {c.algorithm: 1.0 for c in r.candidates if c.algorithm != "allgather"}
    r2 = rt.autotune(K, p, payload, R_TOPOS[topo_name], q=q, generator=generator, measured=measured)
    t2 = pt.autotune(K, p, payload, P_TOPOS[topo_name], q=q, generator=generator, measured=measured)
    assert _table(t2) == _table(r2)
    off_r = rt.autotune(K, p, payload, R_TOPOS[topo_name], q=q, generator=generator, pipelines=False)
    off_t = pt.autotune(K, p, payload, P_TOPOS[topo_name], q=q, generator=generator, pipelines=False)
    assert _table(off_t) == _table(off_r)


def test_autotune_fitted_costs_price_alike():
    """A Hierarchy priced with fitted costs (both packages fit the same
    measurements) gives the same candidate table."""
    levels = (4, 2, 2)
    r_fit = rcal.fit_level_costs(_measurements(rt, rcal, levels, seed=9), 3)
    p_fit = pcal.fit_level_costs(_measurements(pt, pcal, levels, seed=9), 3)
    r = rt.autotune(16, 1, 65536, rt.Hierarchy(levels, costs=r_fit), generator="general")
    t = pt.autotune(16, 1, 65536, pt.Hierarchy(levels, costs=p_fit), generator="general")
    assert _table(t) == _table(r)
    assert dataclasses.asdict(p_fit[0]) == dataclasses.asdict(r_fit[0])
