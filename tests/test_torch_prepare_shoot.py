"""Differential tests of the port's universal prepare-and-shoot executor
(``repro_torch.core.prepare_shoot``) against ``repro.core.prepare_shoot``.

The same seeded numpy inputs go through the JAX functions (on the JAX CPU
backend) and through their PyTorch counterparts on the CPU, stage by stage:
``prepare_phase``, ``shoot_init`` with both coefficient paths, ``shoot_rounds``
and the whole ``encode_universal``. Equality is exact (``np.array_equal``,
tolerance 0).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import prepare_shoot as rps
from repro.core import schedule as rsch
from repro.core.field import M31, NTT, Field
from repro.core.matrices import random_matrix, random_vector
from repro_torch.convert import to_numpy, to_tensor
from repro_torch.core import prepare_shoot as pps
from repro_torch.core import schedule as psch


def j32(a):
    return jnp.asarray(np.asarray(a, dtype=np.uint32))


def t32(a):
    return to_tensor(np.asarray(a, dtype=np.uint32), "cpu")


def jnp_u32(a):
    out = np.asarray(a)
    assert out.dtype == np.uint32
    return out


@pytest.mark.parametrize("path", ["host", "runtime"])
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("K", [2, 3, 5, 8, 9, 16, 17, 33])
def test_universal_stage_by_stage(K, p, path):
    """prepare_phase, shoot_init (both coefficient paths) and shoot_rounds
    each equal the reference's, and so does the encode."""
    q = M31
    f = Field(q)
    A = random_matrix(f, K, seed=K + p)
    x = random_vector(f, (K, 3), seed=2 * K + p)
    rplan, pplan = rsch.plan_prepare_shoot(K, p), psch.plan_prepare_shoot(K, p)
    rbuf, pbuf = rps.prepare_phase(j32(x), rplan), pps.prepare_phase(t32(x), pplan)
    assert np.array_equal(to_numpy(pbuf), jnp_u32(rbuf))
    rA = np.asarray(A) if path == "host" else j32(A)
    pA = np.asarray(A) if path == "host" else t32(A)
    rw, pw = rps.shoot_init(rbuf, rplan, rA, q), pps.shoot_init(pbuf, pplan, pA, q)
    assert np.array_equal(to_numpy(pw), jnp_u32(rw))
    rw2, pw2 = rps.shoot_rounds(rw, rplan, q), pps.shoot_rounds(pw, pplan, q)
    # column 0 is the result; the other columns are dead values the port does not touch
    assert np.array_equal(to_numpy(pw2[:, 0]), jnp_u32(rw2[:, 0]))
    out = pps.encode_universal(t32(x), pA, p=p, q=q)
    want = rps.encode_universal(j32(x), rA, p=p, q=q)
    assert np.array_equal(to_numpy(out), jnp_u32(want))
    assert np.array_equal(to_numpy(out).astype(np.uint64), rps.encode_oracle(x, A, q))
    assert np.array_equal(pps.encode_oracle(x, A, q), rps.encode_oracle(x, A, q))


@pytest.mark.parametrize("q", [M31, NTT])
@pytest.mark.parametrize("payload", [(), (1,), (4, 8), (3, 5, 7), (0,)])
def test_universal_odd_payload_shapes(payload, q):
    K, p = 12, 1
    f = Field(q)
    A = random_matrix(f, K, seed=3)
    x = random_vector(f, (K, *payload), seed=4)
    out = pps.encode_universal(t32(x), np.asarray(A), p=p, q=q)
    want = rps.encode_universal(j32(x), np.asarray(A), p=p, q=q)
    assert tuple(out.shape) == (K, *payload)
    assert np.array_equal(to_numpy(out), jnp_u32(want))


@pytest.mark.parametrize("q", [M31, NTT])
def test_baked_coefficients_follow_the_matrix(q):
    """One plan serves many matrices: the coefficient tensors kept with the
    plan are reused for an equal matrix and made anew for another one, also
    when the caller's array was changed in place."""
    K, p = 9, 1
    f = Field(q)
    plan = psch.plan_prepare_shoot(K, p)
    x = random_vector(f, (K, 5), seed=1)
    A = np.asarray(random_matrix(f, K, seed=2)).copy()
    B = np.asarray(random_matrix(f, K, seed=3))

    def encode(M):
        return to_numpy(pps.encode_universal(t32(x), M, p=p, q=q, plan=plan)).astype(np.uint64)

    assert np.array_equal(encode(A), rps.encode_oracle(x, A, q))
    baked = pps._shoot_coefficients(plan, A, q, t32(x).device)
    assert np.array_equal(encode(A.copy()), rps.encode_oracle(x, A, q))
    assert pps._shoot_coefficients(plan, A.copy(), q, t32(x).device)[0] is baked[0]
    assert np.array_equal(encode(B), rps.encode_oracle(x, B, q))
    A[0, 0] = (int(A[0, 0]) + 1) % q
    assert np.array_equal(encode(A), rps.encode_oracle(x, A, q))
    assert pps._shoot_coefficients(plan, A, q, t32(x).device)[0] is not baked[0]
