"""Differential tests of the port's single-device executors and public
``a2a_encode`` against ``repro.core``.

The same seeded numpy inputs go through the JAX functions (on the JAX CPU
backend) and through their PyTorch counterparts with ``device="cpu"``; the
universal algorithm's stages are compared one by one in
``test_torch_prepare_shoot.py``. Equality is exact (``np.array_equal``, tolerance 0).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import a2a_encode as ref_a2a_encode
from repro.core import draw_loose as rdl
from repro.core import encode as renc
from repro.core import prepare_shoot as rps
from repro.core import schedule as rsch
from repro.core.field import M31, NTT, Field
from repro.core.matrices import lagrange_matrix, random_matrix, random_vector
from repro_torch.convert import from_reference, to_numpy, to_tensor
from repro_torch.core import a2a_encode, plan_for
from repro_torch.core import draw_loose as pdl
from repro_torch.core import encode as penc
from repro_torch.core import schedule as psch
from repro_torch.core.bounds import CostModel


def j32(a):
    return jnp.asarray(np.asarray(a, dtype=np.uint32))


def t32(a):
    return to_tensor(np.asarray(a, dtype=np.uint32), "cpu")


def jnp_u32(a):
    out = np.asarray(a)
    assert out.dtype == np.uint32
    return out


@pytest.mark.parametrize("K,p,q", [(16, 1, NTT), (64, 1, NTT), (9, 2, M31), (128, 1, NTT)])
def test_butterfly_forward_inverse(K, p, q):
    x = random_vector(Field(q), (K, 3), seed=5)
    rplan, pplan = rsch.plan_butterfly(K, p, q), psch.plan_butterfly(K, p, q)
    ry, py = rdl.encode_dft(j32(x), rplan), pdl.encode_dft(t32(x), pplan)
    assert np.array_equal(to_numpy(py), jnp_u32(ry))
    rback, pback = rdl.decode_dft(ry, rplan), pdl.decode_dft(py, pplan)
    assert np.array_equal(to_numpy(pback), jnp_u32(rback))
    assert np.array_equal(to_numpy(pback), x.astype(np.uint32))
    # the reference's plan, carried across, drives the port to the same bytes
    assert np.array_equal(to_numpy(pdl.butterfly_apply(t32(x), from_reference(rplan))), jnp_u32(ry))


@pytest.mark.parametrize("K,p,q", [(8, 1, NTT), (12, 1, NTT), (20, 1, NTT), (18, 2, M31), (7, 1, NTT), (48, 1, NTT)])
def test_draw_loose_and_decode(K, p, q):
    x = random_vector(Field(q), (K, 2), seed=8)
    rplan, pplan = rsch.plan_draw_loose(K, p, q, seed=7), psch.plan_draw_loose(K, p, q, seed=7)
    ry, py = rdl.encode_draw_loose(j32(x), rplan), pdl.encode_draw_loose(t32(x), pplan)
    assert np.array_equal(to_numpy(py), jnp_u32(ry))
    G = rsch.draw_loose_target_matrix(rplan)
    assert np.array_equal(to_numpy(py).astype(np.uint64), rps.encode_oracle(x, G, q))
    rback, pback = rdl.decode_draw_loose(ry, rplan), pdl.decode_draw_loose(py, pplan)
    assert np.array_equal(to_numpy(pback), jnp_u32(rback))
    assert np.array_equal(to_numpy(pback), x.astype(np.uint32))
    assert np.array_equal(to_numpy(pdl.encode_draw_loose(t32(x), from_reference(rplan))), jnp_u32(ry))


@pytest.mark.parametrize("K,p,q", [(8, 1, NTT), (12, 1, NTT), (6, 1, NTT)])
def test_lagrange_executor(K, p, q):
    f = Field(q)
    x = random_vector(f, (K, 2), seed=9)
    rw, ra = rsch.plan_draw_loose(K, p, q, seed=11), rsch.plan_draw_loose(K, p, q, seed=22)
    pw, pa = psch.plan_draw_loose(K, p, q, seed=11), psch.plan_draw_loose(K, p, q, seed=22)
    got = pdl.encode_lagrange(t32(x), pw, pa)
    want = rdl.encode_lagrange(j32(x), rw, ra)
    assert np.array_equal(to_numpy(got), jnp_u32(want))
    L = lagrange_matrix(f, ra.points, rw.points)
    assert np.array_equal(to_numpy(got).astype(np.uint64), rps.encode_oracle(x, L, q))
    with pytest.raises(ValueError):
        pdl.encode_lagrange(t32(x), pw, psch.plan_draw_loose(K, 2, q, seed=1))


CASES = [
    ("general", 16, 1, M31), ("general", 12, 2, NTT), ("general", 33, 3, M31),
    ("dft", 16, 1, NTT), ("dft", 9, 2, M31),
    ("vandermonde", 12, 1, NTT), ("vandermonde", 18, 2, M31), ("vandermonde", 16, 1, NTT),
]


@pytest.mark.parametrize("kind,K,p,q", CASES)
def test_a2a_encode_equals_reference(kind, K, p, q):
    f = Field(q)
    x = random_vector(f, (K, 5), seed=K)
    rplan = renc.plan_for(kind, K, p, q, seed=3)
    pplan = plan_for(kind, K, p, q, seed=3)
    if kind == "general":
        A = random_matrix(f, K, seed=1)
        want, rrep = ref_a2a_encode(j32(x), np.asarray(A), plan=rplan, q=q)
        got, prep = a2a_encode(x.astype(np.uint32), np.asarray(A), plan=pplan, q=q, device="cpu")
        # no plan given: auto-selection, and a tensor A
        want2, rrep2 = ref_a2a_encode(j32(x), j32(A), p=p, q=q)
        got2, prep2 = a2a_encode(t32(x), t32(A), p=p, q=q, device="cpu")
        assert np.array_equal(to_numpy(got2), jnp_u32(want2))
        assert dataclasses.asdict(prep2) == dataclasses.asdict(rrep2)
    else:
        want, rrep = ref_a2a_encode(j32(x), plan=rplan, q=q)
        got, prep = a2a_encode(t32(x), plan=pplan, q=q, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(to_numpy(got), jnp_u32(want))
    # CostReport: every field, and the derived property
    assert dataclasses.asdict(prep) == dataclasses.asdict(rrep)
    assert prep.c1_optimal == rrep.c1_optimal
    assert [fl.name for fl in dataclasses.fields(prep)] == [fl.name for fl in dataclasses.fields(rrep)]


def test_a2a_encode_cost_model_and_errors():
    f = Field(M31)
    K = 8
    A = random_matrix(f, K, seed=0)
    x = random_vector(f, K, seed=1)
    model = CostModel(beta=2e-6, tau=1e-9)
    _, rep = a2a_encode(t32(x), np.asarray(A), cost_model=model, device="cpu")
    assert rep.time == model.time(rep.c1, rep.c2)
    with pytest.raises(ValueError, match="need A or a plan"):
        a2a_encode(t32(x), device="cpu")
    with pytest.raises(ValueError, match="needs the matrix"):
        a2a_encode(t32(x), plan=plan_for("general", K), device="cpu")
    with pytest.raises(ValueError, match="unknown kind"):
        plan_for("nope", K)
    with pytest.raises(TypeError):
        a2a_encode(t32(x), plan=object(), device="cpu")


@pytest.mark.parametrize("K", [4, 6, 8, 12, 16, 27, 48, 64])
@pytest.mark.parametrize("p", [1, 2])
def test_default_q_and_rs_generator(K, p):
    assert penc.default_q_for(K, p) == renc.default_q_for(K, p)
    f = Field(M31)
    assert np.array_equal(penc.rs_generator(f, 4, K + 2, seed=1), renc.rs_generator(f, 4, K + 2, seed=1))


@pytest.mark.parametrize("inverse", [False, True])
def test_plan_constants_are_baked_once(inverse):
    """The executors upload a plan's twiddles, duals and gather indices at
    the first call and reuse the same tensors after it; the constants are no
    field of the plan, so equality of plans does not see them."""
    K, p, q = 48, 1, NTT
    x = t32(random_vector(Field(q), (K, 2), seed=3))
    plan, fresh = psch.plan_draw_loose(K, p, q, seed=7), psch.plan_draw_loose(K, p, q, seed=7)
    run = pdl.decode_draw_loose if inverse else pdl.encode_draw_loose
    first = run(x, plan)
    loose = pdl._butterfly_constants(plan.loose_plan, inverse, x.device)
    scale = plan.__dict__["_constants"][("scale", inverse, x.device)]
    assert torch.equal(run(x, plan), first)
    assert pdl._butterfly_constants(plan.loose_plan, inverse, x.device) is loose
    assert plan.__dict__["_constants"][("scale", inverse, x.device)] is scale
    assert "_constants" not in fresh.__dict__
    assert dataclasses.asdict(plan).keys() == dataclasses.asdict(fresh).keys()
    assert torch.equal(run(x, fresh), first)
