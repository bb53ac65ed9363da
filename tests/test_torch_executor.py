"""Differential tests of the port's IR executor
(``repro_torch.dist.collectives``) on the CPU.

``ir_encode`` in modes ``"torch"`` and ``"fused"`` runs every core schedule
family at K ∈ {8, 12, 16} on seeded inputs and must equal the matrix oracle,
the reference's ``interpret`` on the reference's own IR, and itself when fed
the reference's IR carried across. One subprocess forces 8 host devices and
runs the reference's mesh executors with ``kernels="pallas"`` (interpret mode
on the CPU); the port's CPU run on the same seeded input must produce the same
bytes. Equality is exact (``np.array_equal``, tolerance 0).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch

from repro.core import ir as rir
from repro.core import schedule as rsch
from repro.core.field import M31, NTT, Field
from repro.core.matrices import (
    butterfly_target_matrix,
    distinct_points,
    lagrange_matrix,
    random_matrix,
    random_vector,
    vandermonde,
)
from repro.core.prepare_shoot import encode_oracle
from repro.core.simulator import interpret as ref_interpret
from repro_torch.convert import from_reference, to_numpy, to_tensor
from repro_torch.core import ir as pir
from repro_torch.core import schedule as psch
from repro_torch.dist.collectives import (
    KERNEL_MODES,
    allgather_encode,
    butterfly,
    expected_permute_count,
    ir_encode,
    ps_encode,
    shoot_round_slots,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_MODES = ("torch", "fused")


def _gen(field, kind, K, seed):
    if kind == "random":
        return random_matrix(field, K, seed=seed)
    if kind == "vandermonde":
        return vandermonde(field, distinct_points(field, K, seed=seed))
    omegas = distinct_points(field, K, seed=seed)
    alphas = distinct_points(field, K, seed=seed + 1)
    return lagrange_matrix(field, alphas, omegas)


def _cases():
    """(label, build(sched, ir_mod) → (ir, target, q)): the core families of
    the reference's fused-executor harness — prepare-shoot × field ×
    generator kind, prepare-shoot p=2, allgather, draw-loose, butterfly."""
    cases = []
    for K in (8, 12, 16):
        for q in (M31, NTT):
            for gk in ("random", "vandermonde", "lagrange"):
                def mk_ps(sch, irm, K=K, q=q, gk=gk):
                    A = _gen(Field(q), gk, K, seed=K + len(gk))
                    return sch.plan_prepare_shoot(K, 1).to_ir(A, q=q), A, q

                cases.append((f"ps-{K}-{q & 0xffff:x}-{gk}", mk_ps))

        def mk_ps2(sch, irm, K=K):
            A = _gen(Field(M31), "random", K, seed=K * 5)
            return sch.plan_prepare_shoot(K, 2).to_ir(A), A, M31

        cases.append((f"ps-{K}-p2", mk_ps2))

        def mk_ag(sch, irm, K=K):
            A = _gen(Field(M31), "lagrange", K, seed=K)
            return irm.ir_allgather(K, 1, A), A, M31

        cases.append((f"allgather-{K}", mk_ag))

        def mk_dl(sch, irm, K=K):
            plan = sch.plan_draw_loose(K, 1, NTT, seed=1)
            return plan.to_ir(), sch.draw_loose_target_matrix(plan), NTT

        cases.append((f"draw-loose-{K}", mk_dl))
    for K in (8, 16):
        def mk_bf(sch, irm, K=K):
            return sch.plan_butterfly(K, 1, NTT).to_ir(), butterfly_target_matrix(Field(NTT), K, 2), NTT

        cases.append((f"butterfly-{K}", mk_bf))
    return cases


CASES = _cases()


@pytest.mark.parametrize("mode", CPU_MODES)
@pytest.mark.parametrize("idx", range(len(CASES)), ids=[c[0] for c in CASES])
def test_ir_encode_every_family_bit_exact(idx, mode):
    label, build = CASES[idx]
    r_ir, target, q = build(rsch, rir)
    p_ir, _, _ = build(psch, pir)
    f = Field(q)
    x = random_vector(f, (p_ir.K, 3, 5), seed=len(label))  # odd payload
    want = encode_oracle(x, target, q)
    fn = ir_encode(p_ir, q=q, device="cpu", kernels=mode)
    assert fn.kernels == mode
    got = fn(x.astype(np.uint32))
    assert got.dtype == torch.int32 and tuple(got.shape) == x.shape
    assert np.array_equal(to_numpy(got).astype(np.uint64), want)
    # one gather per port group, no more
    assert fn.permutes_run == fn.permute_count == pir.ir_permute_count(p_ir) == rir.ir_permute_count(r_ir)
    # the reference's interpreter on the reference's IR, column by column
    flat = x.reshape(p_ir.K, -1)
    for c in (0, flat.shape[1] - 1):
        ref_out, _ = ref_interpret(r_ir, flat[:, c], f)
        assert np.array_equal(to_numpy(got).reshape(p_ir.K, -1)[:, c].astype(np.uint64), ref_out)
    # the reference's IR, carried across, through the port's executor
    got2 = ir_encode(from_reference(r_ir), q=q, device="cpu", kernels=mode)(to_tensor(x, "cpu"))
    assert torch.equal(got, got2)


@pytest.mark.parametrize("mode", CPU_MODES)
@pytest.mark.parametrize("K,p", [(8, 1), (8, 2), (12, 1), (16, 1), (16, 3), (27, 2), (64, 1)])
def test_ps_encode_permutation_count(K, p, mode):
    f = Field(M31)
    A = random_matrix(f, K, seed=K)
    x = random_vector(f, (K, 4), seed=p)
    fn, plan = ps_encode(np.asarray(A), p=p, device="cpu", kernels=mode)
    got = fn(x.astype(np.uint32))
    assert np.array_equal(to_numpy(got).astype(np.uint64), encode_oracle(x, A))
    assert fn.permutes_run == expected_permute_count(plan)
    rplan = rsch.plan_prepare_shoot(K, p)
    from repro.dist.collectives import expected_permute_count as ref_expected
    from repro.dist.collectives import shoot_round_slots as ref_slots

    assert expected_permute_count(plan) == ref_expected(rplan)
    for t in range(1, plan.Ts + 1):
        for rho in range(1, p + 1):
            for a, b in zip(shoot_round_slots(plan, t, rho), ref_slots(rplan, t, rho)):
                assert np.array_equal(a, b)
    if (K, p) == (64, 1):
        assert fn.permutes_run == 6


@pytest.mark.parametrize("mode", CPU_MODES)
@pytest.mark.parametrize("K,p,q", [(8, 1, NTT), (16, 1, NTT), (9, 2, M31)])
def test_butterfly_forward_and_inverse(K, p, q, mode):
    f = Field(q)
    x = random_vector(f, (K, 5), seed=6)
    fwd, plan = butterfly(K, p=p, q=q, device="cpu", kernels=mode)
    inv, _ = butterfly(K, p=p, q=q, inverse=True, device="cpu", kernels=mode)
    y = fwd(x.astype(np.uint32))
    assert np.array_equal(to_numpy(y).astype(np.uint64), encode_oracle(x, butterfly_target_matrix(f, K, p + 1), q))
    assert fwd.permutes_run == plan.H * p
    assert np.array_equal(to_numpy(inv(y)), x.astype(np.uint32))


@pytest.mark.parametrize("q", [M31, NTT])
def test_allgather_baseline(q):
    K = 12
    f = Field(q)
    A = random_matrix(f, K, seed=1)
    x = random_vector(f, (K, 7), seed=2)
    got = allgather_encode(np.asarray(A), q=q, device="cpu")(x.astype(np.uint32))
    assert np.array_equal(to_numpy(got).astype(np.uint64), encode_oracle(x, A, q))
    with pytest.raises(ValueError):
        allgather_encode(np.zeros((3, 4)), device="cpu")


def test_default_mode_on_the_cpu_is_fused_and_modes_are_named():
    assert KERNEL_MODES == ("torch", "fused", "cuda")
    A = random_matrix(Field(M31), 8, seed=0)
    fn, _ = ps_encode(np.asarray(A), device="cpu")
    assert fn.kernels == "fused" and fn.device == torch.device("cpu")


def _pipelined_like_ir(pir, mode_update=True):
    """A hand-made IR with update/overlap LocalOps, uniform {0,1} rows, a zero
    row and a partial add group: the strength-reduced classes of the executor."""
    K = 4
    coeffs = np.zeros((K, 3, 2), dtype=np.uint64)
    coeffs[:, 0, :] = 1  # slot 5 = slot0 + slot1   ({0,1} row)
    coeffs[:, 2, 0] = np.arange(2, 2 + K)  # slot 7 = c_k * slot0  (general row); row 1 stays zero
    steps = (
        pir.CommRound(tuple(pir.Transfer(src=k, dst=(k + 1) % K, port=1, slots=((0, 1),), mode="store")
                            for k in range(K))),
        pir.LocalOp(out_slots=(5, 6, 7), in_slots=(0, 1), coeffs=coeffs, update=mode_update, overlap=True),
        # partial add group: only processors 0 and 1 send, into a slot that does not exist yet
        pir.CommRound(tuple(pir.Transfer(src=k, dst=k + 2, port=1, slots=((7, 9),), coeffs=(3,), mode="add")
                            for k in range(2))),
        pir.LocalOp(out_slots=(0,), in_slots=(5, 9, 6, 0), coeffs=np.ones((K, 1, 4), dtype=np.uint64)),
    )
    return pir.ScheduleIR("hand-made", K, 1, steps)


@pytest.mark.parametrize("mode", CPU_MODES)
@pytest.mark.parametrize("update", [True, False])
def test_update_overlap_partial_add_and_missing_slots(mode, update):
    """Equals the port's (and so the reference's) interpreter semantics:
    update keeps other slots, a replaced buffer drops them (slot 0 then reads
    zero), non-receivers of an add group read zero, overlap changes nothing."""
    from repro_torch.core.simulator import interpret

    ir = _pipelined_like_ir(pir, update)
    f = Field(M31)
    x = random_vector(f, (4, 6), seed=1)
    got = to_numpy(ir_encode(ir, q=M31, device="cpu", kernels=mode)(x.astype(np.uint32)))
    for c in range(x.shape[1]):
        want, _ = interpret(ir, x[:, c], f)
        assert np.array_equal(got[:, c].astype(np.uint64), want)
        ref_want, _ = ref_interpret(_pipelined_like_ir(rir, update), x[:, c], f)
        assert np.array_equal(want, ref_want)


def test_partial_store_group_raises_and_structure_only_ir_raises():
    K = 4
    partial = pir.ScheduleIR(
        "partial-store", K, 1,
        (pir.CommRound(tuple(pir.Transfer(src=k, dst=k + 1, port=1, slots=((0, 1),), mode="store")
                             for k in range(K - 1))),),
    )
    with pytest.raises(ValueError, match="store-mode port group must cover every processor"):
        ir_encode(partial, device="cpu")
    bare = psch.plan_prepare_shoot(8, 1).to_ir()  # coeffs=None
    with pytest.raises(ValueError, match="structure-only"):
        ir_encode(bare, device="cpu")
    fn, _ = ps_encode(np.asarray(random_matrix(Field(M31), 8, seed=0)), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        fn(np.zeros((7, 3), dtype=np.uint32))


def test_budget_check_refuses_an_ir_over_budget():
    from repro_torch.dist.collectives import _check_budget

    ir = psch.plan_prepare_shoot(8, 1).to_ir(np.asarray(random_matrix(Field(M31), 8, seed=0)))
    _check_budget(ir, pir.ir_permute_count(ir))
    with pytest.raises(AssertionError, match="budget"):
        _check_budget(ir, pir.ir_permute_count(ir) - 1)


# ---------------------------------------------------------------------------
# one subprocess: the reference's mesh executors with kernels="pallas"
# ---------------------------------------------------------------------------


def test_port_equals_reference_mesh_run_with_pallas_kernels(tmp_path):
    """8 forced host devices; the reference runs ``ps_encode_jit`` and
    ``butterfly_jit`` with ``kernels="pallas"`` on seeded inputs and writes its
    output bytes; the port's CPU run on the same inputs must equal them."""
    out_file = tmp_path / "ref.npz"
    code = f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.launch.mesh import make_mesh
        from repro.core.field import M31, NTT, Field
        from repro.core.matrices import random_matrix, random_vector
        from repro.dist.collectives import butterfly_jit, ps_encode_jit
        K = 8
        mesh = make_mesh((8,), ("enc",))
        res = {{}}
        for q, tag in ((M31, "m31"), (NTT, "ntt")):
            f = Field(q)
            A = np.asarray(random_matrix(f, K, seed=2))
            x = random_vector(f, (K, 16, 3), seed=3).astype(np.uint32)
            fn, _ = ps_encode_jit(mesh, "enc", A, p=1, q=q, kernels="pallas")
            res["ps_" + tag] = np.asarray(fn(jnp.asarray(x)))
        xb = random_vector(Field(NTT), (K, 5), seed=6).astype(np.uint32)
        fnb, _ = butterfly_jit(mesh, "enc", q=NTT, kernels="pallas")
        res["bf"] = np.asarray(fnb(jnp.asarray(xb)))
        fni, _ = butterfly_jit(mesh, "enc", q=NTT, inverse=True, kernels="pallas")
        res["bf_inv"] = np.asarray(fni(jnp.asarray(res["bf"])))
        assert all(v.dtype == np.uint32 for v in res.values())
        np.savez({str(out_file)!r}, **res)
        print("reference mesh run ok")
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, f"child failed:\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    ref = np.load(out_file)
    K = 8
    for q, tag in ((M31, "m31"), (NTT, "ntt")):
        f = Field(q)
        A = np.asarray(random_matrix(f, K, seed=2))
        x = random_vector(f, (K, 16, 3), seed=3).astype(np.uint32)
        for mode in CPU_MODES:
            fn, _ = ps_encode(A, p=1, q=q, device="cpu", kernels=mode)
            assert np.array_equal(to_numpy(fn(x)), ref["ps_" + tag]), (tag, mode)
    xb = random_vector(Field(NTT), (K, 5), seed=6).astype(np.uint32)
    for mode in CPU_MODES:
        fwd, _ = butterfly(K, q=NTT, device="cpu", kernels=mode)
        inv, _ = butterfly(K, q=NTT, inverse=True, device="cpu", kernels=mode)
        y = fwd(xb)
        assert np.array_equal(to_numpy(y), ref["bf"]), mode
        assert np.array_equal(to_numpy(inv(y)), ref["bf_inv"]), mode
    assert np.array_equal(ref["bf_inv"], xb)
