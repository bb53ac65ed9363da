"""CPU tests of the callers of ``butterfly_mac_rows``: the DFT rounds
(``butterfly_apply``), the loose step of draw-and-loose in both directions,
and the one-row LocalOps of ``ir_encode(kernels="cuda")``.

On CPU tensors the wrapper takes the kernel's plain version over the very
tables a card receives (the same ``plan_constants`` entries, on the CPU), so
these tests hold what the callers hand the kernel: the sources (the rows
where they lie: no gather, no transpose, no stack), the row tables and the
twiddles. The same seeded numpy inputs go through the reference's encodes
(``repro.core.draw_loose``, the host oracle with the reference's target
matrices); equality is exact (tolerance 0). ``ir_encode`` refuses
``kernels="cuda"`` off the card, so its tests lift that guard
(``_resolve_kernels``) and nothing else.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import draw_loose as rdl
from repro.core import schedule as rsch
from repro.core.field import NTT, M31, Field
from repro.core.matrices import butterfly_target_matrix, random_matrix, random_vector
from repro.core.prepare_shoot import encode_oracle
from repro.topo import plan_two_level_dft as ref_plan_two_level_dft
from repro.topo import two_level_dft_matrix as ref_two_level_dft_matrix
from repro_torch.convert import to_numpy, to_tensor
from repro_torch.core import draw_loose as pdl
from repro_torch.core import schedule as psch
from repro_torch.core.ir import LocalOp
from repro_torch.dist import collectives
from repro_torch.kernels.butterfly import ops as bops
from repro_torch.kernels.butterfly.kernel import MAX_SOURCES, butterfly_mac_rows_cuda
from repro_torch.topo import FullyConnected, plan_hierarchical, plan_multilevel, plan_two_level_dft
from repro_torch.topo.hierarchical import plan_ring
from repro_torch.topo.passes import PIPELINES

CPU = torch.device("cpu")


def t32(a):
    return to_tensor(np.asarray(a, dtype=np.uint32), "cpu")


@pytest.fixture
def calls(monkeypatch):
    """Every call of ``butterfly_mac_rows``: (sources, idx), then the real call."""
    seen = []
    real = bops.butterfly_mac_rows

    def spy(sources, tw, tw_sh, *, q, idx=None, out=None):
        sources = tuple(sources)
        seen.append((sources, idx, tw))
        return real(sources, tw, tw_sh, q=q, idx=idx, out=out)

    monkeypatch.setattr(bops, "butterfly_mac_rows", spy)
    return seen


@pytest.fixture
def cuda_lowering_on_the_cpu(monkeypatch):
    monkeypatch.setattr(collectives, "_resolve_kernels", lambda kernels, device: kernels)


@pytest.mark.parametrize("K,p,q", [(64, 1, NTT), (9, 2, M31), (16, 3, NTT)])
def test_butterfly_apply_reads_v_through_the_round_tables(calls, K, p, q):
    x = random_vector(Field(q), (K, 5), seed=11)
    rplan, pplan = rsch.plan_butterfly(K, p, q), psch.plan_butterfly(K, p, q)
    y = pdl.butterfly_apply(t32(x), pplan)
    assert np.array_equal(to_numpy(y), np.asarray(rdl.encode_dft(jnp.asarray(x.astype(np.uint32)), rplan)))
    back = pdl.butterfly_apply(y, pplan, inverse=True)
    assert np.array_equal(to_numpy(back), x.astype(np.uint32))
    assert len(calls) == 2 * pplan.H  # one launch a round, each direction
    for direction, rounds in ((False, range(pplan.H)), (True, range(pplan.H - 1, -1, -1))):
        tables = pdl._butterfly_constants(pplan, direction, CPU)
        for t_, (sources, idx, tw) in zip(rounds, calls[: pplan.H] if not direction else calls[pplan.H :]):
            assert len(sources) == 1 and tuple(sources[0].shape) == (K, 5)  # the last round's rows, as they lie
            assert idx is tables[t_][2] and tw is tables[t_][0]  # the cached tables, not a copy
            assert idx.dtype == torch.int32 and tuple(idx.shape) == (pplan.radix, K)


@pytest.mark.parametrize("K,p,q", [(48, 1, NTT), (12, 1, NTT), (18, 2, M31)])
def test_draw_loose_loose_step_runs_on_the_rows_in_their_own_order(calls, K, p, q):
    x = random_vector(Field(q), (K, 3, 2), seed=12)
    rplan, pplan = rsch.plan_draw_loose(K, p, q), psch.plan_draw_loose(K, p, q)
    y = pdl.encode_draw_loose(t32(x), pplan)
    assert np.array_equal(to_numpy(y), np.asarray(rdl.encode_draw_loose(jnp.asarray(x.astype(np.uint32)), rplan)))
    back = pdl.decode_draw_loose(y, pplan)
    assert np.array_equal(to_numpy(back), x.astype(np.uint32))
    lp = pplan.loose_plan
    assert lp is not None
    assert len(calls) == 2 * lp.H
    for sources, idx, tw in calls:  # M butterflies of Z points over the (M·Z, payload) rows
        assert len(sources) == 1 and tuple(sources[0].shape) == (K, 6)
        assert tuple(idx.shape) == (lp.radix, K) and tuple(tw.shape) == (K, lp.radix)
        rows = idx.to(torch.int64)
        assert bool(((rows // pplan.Z) == (torch.arange(K) // pplan.Z)).all())  # a row reads its own group


def _reference_out(kind, K, x):
    """The reference's encode of x for one IR family."""
    if kind == "dft":
        return encode_oracle(x, butterfly_target_matrix(Field(NTT), K, 2), NTT)
    if kind == "draw_loose":
        return np.asarray(rdl.encode_draw_loose(jnp.asarray(x.astype(np.uint32)), rsch.plan_draw_loose(K, 1, NTT)))
    return encode_oracle(x, ref_two_level_dft_matrix(ref_plan_two_level_dft(K, 1, NTT, 8)), NTT)


@pytest.mark.parametrize("kind,K", [("dft", 64), ("draw_loose", 48), ("two_level_dft", 64)])
def test_ir_encode_cuda_lowering_hands_the_slots_over_as_they_lie(calls, cuda_lowering_on_the_cpu, kind, K):
    x = random_vector(Field(NTT), (K, 7), seed=13)
    plan = {"dft": lambda: psch.plan_butterfly(K, 1, NTT), "draw_loose": lambda: psch.plan_draw_loose(K, 1, NTT),
            "two_level_dft": lambda: plan_two_level_dft(K, 1, NTT, 8)}[kind]()
    ir = plan.to_ir()
    fn = collectives.ir_encode(ir, q=NTT, device="cpu", kernels="cuda")
    assert fn.kernels == "cuda"
    got = to_numpy(fn(x.astype(np.uint32)))
    assert np.array_equal(got.astype(np.uint64), np.asarray(_reference_out(kind, K, x)).astype(np.uint64))
    fused = to_numpy(collectives.ir_encode(ir, q=NTT, device="cpu", kernels="fused")(x.astype(np.uint32)))
    assert np.array_equal(got, fused)
    one_row = [s for s in ir.steps if isinstance(s, LocalOp) and _general_rows(s) == 1]
    assert one_row and len(calls) == len(one_row)
    for step, (sources, idx, tw) in zip(one_row, calls):
        assert idx is None and len(sources) == len(step.in_slots)  # one source a slot: nothing stacked
        assert all(tuple(s.shape) == (K, 7) for s in sources) and tuple(tw.shape) == (K, len(step.in_slots))


def _general_rows(step) -> int:
    """Rows of a LocalOp that are not uniformly 0 or 1 across processors:
    the executor's contraction (one: ``butterfly_mac_rows``)."""
    c = np.asarray(step.coeffs)
    uniform = np.all(c == 0, axis=0) | np.all(c == 1, axis=0)
    return sum(1 for i in range(c.shape[1]) if not uniform[i].all())


def _families(K: int):
    """(name, IR) of every plan family the port builds at K (those that
    take K), and the butterfly plans (name, radix) whose rounds launch."""
    A = np.asarray(random_matrix(Field(M31), K, seed=K))
    irs, radices = [], []
    for p in (1, 2, 3):
        ps = psch.plan_prepare_shoot(K, p)
        irs.append((f"prepare_shoot p={p}", ps.to_ir(A, q=M31)))
        irs.append((f"pipeline p={p}", PIPELINES["pipeline"].apply(ps.to_ir(A, q=M31), FullyConnected(K), 1 << 16)))
        dl = psch.plan_draw_loose(K, p, NTT if K % 2 == 0 else M31)
        irs.append((f"draw_loose p={p}", dl.to_ir()))
        if dl.loose_plan is not None:
            radices.append((f"draw_loose p={p} loose", dl.loose_plan.radix))
    irs.append(("ring", plan_ring(K, 1).to_ir(A, q=M31)))
    for k_intra in (2, 4, 8):
        if K % k_intra == 0 and K > k_intra:
            irs.append((f"hierarchical {k_intra}", plan_hierarchical(K, 1, k_intra).to_ir(A, q=M31)))
    if K == 64:
        irs.append(("multilevel (4, 4, 4)", plan_multilevel(K, 1, (4, 4, 4)).to_ir(A, q=M31)))
        irs.append(("two_level_dft", plan_two_level_dft(K, 1, NTT, 8).to_ir()))
    if K & (K - 1) == 0:
        bf = psch.plan_butterfly(K, 1, NTT)
        irs += [("butterfly", bf.to_ir()), ("butterfly inverse", bf.to_ir(inverse=True))]
        radices.append(("butterfly", bf.radix))
    return irs, radices


@pytest.mark.parametrize("K", [8, 16, 48, 64])
def test_no_plan_family_needs_more_sources_than_the_kernel_takes(K):
    """Every one-row LocalOp (one source a slot) and every butterfly round
    (radix) of every family the port runs, at the K it runs, stays within the
    kernel's cap of base pointers."""
    irs, radices = _families(K)
    for name, ir in irs:
        for step in ir.steps:
            if isinstance(step, LocalOp) and _general_rows(step) == 1:
                assert len(step.in_slots) <= MAX_SOURCES, (name, len(step.in_slots))
    for name, radix in radices:
        assert radix <= MAX_SOURCES, (name, radix)


def test_a_one_row_local_op_over_the_cap_goes_to_gf_matmul(calls, cuda_lowering_on_the_cpu):
    """The ring at K = 128 contracts 128 slots in one row: more sources than
    the kernel takes, so the executor stacks them for ``gf_matmul``."""
    K = 128
    A = np.asarray(random_matrix(Field(M31), K, seed=5))
    ir = plan_ring(K, 1).to_ir(A, q=M31)
    assert max(len(s.in_slots) for s in ir.steps if isinstance(s, LocalOp)) > MAX_SOURCES
    x = random_vector(Field(M31), (K, 2), seed=6)
    got = to_numpy(collectives.ir_encode(ir, q=M31, device="cpu", kernels="cuda")(x.astype(np.uint32)))
    assert np.array_equal(got.astype(np.uint64), encode_oracle(x, A, M31))
    assert all(len(sources) <= MAX_SOURCES for sources, _, _ in calls)
    assert butterfly_mac_rows_cuda.launches == 0
