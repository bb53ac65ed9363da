"""Differential tests of ``repro_torch.core.field`` against ``repro.core.field``.

The same inputs, made with numpy from a seed, go through the JAX function and
its PyTorch counterpart. Equality is exact (``np.array_equal``, tolerance 0):
the arithmetic is integer arithmetic mod q. Everything runs on the CPU.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import field as ref
from repro_torch.core import field as port
from repro_torch.core.field import to_numpy, to_tensor

PRIMES = [ref.M31, ref.NTT]
N = 4096


def canon(q, seed, n=N):
    """Canonical residues with the edge values 0, 1, q-2, q-1 in every pairing."""
    a = np.random.default_rng(seed).integers(0, q, size=n, dtype=np.uint32)
    edge = np.array([0, 1, q - 2, q - 1], dtype=np.uint32)
    a[:16] = np.repeat(edge, 4) if seed % 2 == 0 else np.tile(edge, 4)
    return a


def words(seed, n=N):
    """Any 32-bit words, with 0, 2^31-1, 2^31 and 2^32-1 among them."""
    a = np.random.default_rng(seed).integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], dtype=np.uint32)
    a[:16] = np.repeat(edge, 4) if seed % 2 == 0 else np.tile(edge, 4)
    return a


def both(name, args_np, *consts):
    got = to_numpy(getattr(port, name)(*[to_tensor(a, "cpu") for a in args_np], *consts))
    want = np.asarray(getattr(ref, name)(*[jnp.asarray(a) for a in args_np], *consts))
    assert want.dtype == np.uint32 and got.dtype == np.uint32
    return got, want


def test_constants_and_representation():
    assert (port.M31, port.NTT) == (ref.M31, ref.NTT)
    w = words(0)
    t = to_tensor(w, "cpu")
    assert t.dtype == torch.int32 and t.element_size() == 4
    assert np.array_equal(to_numpy(t), w)
    # 64-bit holders of 32-bit words are accepted too
    assert np.array_equal(to_numpy(to_tensor(torch.from_numpy(w.astype(np.int64)), "cpu")), w)


@pytest.mark.parametrize("q", PRIMES)
@pytest.mark.parametrize("name", ["madd", "msub", "mmul"])
def test_binary_mod_ops_canonical(name, q):
    a, b = canon(q, 0), canon(q, 1)
    got, want = both(name, (a, b), q)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("q", PRIMES)
@pytest.mark.parametrize("name", ["madd", "msub", "mmul"])
def test_binary_mod_ops_any_word(name, q):
    """Outside the canonical domain the reference's uint32 wrap-around is
    reproduced step for step."""
    a, b = words(2), words(3)
    got, want = both(name, (a, b), q)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("q", PRIMES)
def test_mneg(q):
    for a in (canon(q, 4), words(5)):
        got, want = both("mneg", (a,), q)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["umulhi32", "umulhi32_full"])
def test_umulhi_any_word(name):
    a, b = words(6), words(7)
    got, want = both(name, (a, b))
    assert np.array_equal(got, want)
    if name == "umulhi32_full":
        exact = ((a.astype(object) * b.astype(object)) >> 32).astype(np.uint64)
        assert np.array_equal(got.astype(np.uint64), exact)


def test_umulhi32_below_2_31_is_exact():
    a, b = canon(ref.M31, 8), canon(ref.M31, 9)
    got, want = both("umulhi32", (a, b))
    assert np.array_equal(got, want)
    assert np.array_equal(got.astype(np.uint64), (a.astype(np.uint64) * b.astype(np.uint64)) >> np.uint64(32))


def test_mmul_m31():
    for a, b in ((canon(ref.M31, 10), canon(ref.M31, 11)), (words(12), words(13))):
        got, want = both("mmul_m31", (a, b))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("q", PRIMES + [65537, 97])
def test_barrett32(q):
    x = words(14)
    got, want = both("barrett32", (x,), q)
    assert np.array_equal(got, want)
    assert np.array_equal(got.astype(np.uint64), x.astype(np.uint64) % np.uint64(q))


@pytest.mark.parametrize("q", PRIMES)
def test_shoup_precompute_and_mul(q):
    a, c = canon(q, 15), canon(q, 16)
    c[:8] = q - 1  # duals just below 2^32
    c_pre = port.shoup_precompute(c, q)
    assert c_pre.dtype == np.uint32
    assert np.array_equal(c_pre, ref.shoup_precompute(c, q))
    assert int(c_pre.max()) >= (1 << 32) - 4  # the top bit really is used
    got, want = both("shoup_mul", (a, c, c_pre), q)
    assert np.array_equal(got, want)
    assert np.array_equal(got.astype(np.uint64), ref.Field(q).mul(a, c))
    # any 32-bit multiplicand a (the duals stay those of c)
    got, want = both("shoup_mul", (words(17), c, c_pre), q)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("q", PRIMES)
def test_scalar_constants_broadcast(q):
    """Python-int constants (as the executors pass them) against tensors."""
    a = canon(q, 18)
    c = q - 5
    c_pre = int(port.shoup_precompute(c, q))
    got = to_numpy(port.shoup_mul(to_tensor(a, "cpu"), c, c_pre, q))
    want = np.asarray(ref.shoup_mul(jnp.asarray(a), jnp.uint32(c), jnp.uint32(c_pre), q))
    assert np.array_equal(got, want)
    got = to_numpy(port.madd(to_tensor(a, "cpu"), c, q))
    assert np.array_equal(got, np.asarray(ref.madd(jnp.asarray(a), jnp.uint32(c), q)))
    got = to_numpy(port.mmul(to_tensor(a, "cpu"), c, q))
    assert np.array_equal(got, np.asarray(ref.mmul(jnp.asarray(a), jnp.uint32(c), q)))


@pytest.mark.parametrize("q", PRIMES)
def test_host_field_matches_reference(q):
    fp, fr = port.Field(q), ref.Field(q)
    rng = np.random.default_rng(19)
    A = rng.integers(0, q, size=(9, 9), dtype=np.uint64)
    B = rng.integers(0, q, size=(9, 7), dtype=np.uint64)
    v = rng.integers(1, q, size=9, dtype=np.uint64)
    assert fp.generator == fr.generator
    assert fp.root_of_unity(6) == fr.root_of_unity(6)
    for name, args in [
        ("add", (A, A.T)), ("sub", (A, A.T)), ("neg", (A,)), ("mul", (A, A.T)),
        ("pow", (v, 12345)), ("inv", (v,)), ("matmul", (A, B)), ("solve", (A, B)),
        ("inv_matrix", (A,)),
    ]:
        got, want = getattr(fp, name)(*args), getattr(fr, name)(*args)
        assert got.dtype == want.dtype == np.uint64
        assert np.array_equal(got, want), name
    assert port.two_adic_valuation(q - 1) == ref.two_adic_valuation(q - 1)
    assert port.radix_valuation(q - 1, 3) == ref.radix_valuation(q - 1, 3)


def test_resolve_device_refuses_a_missing_card():
    assert port.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port.resolve_device(None)
        with pytest.raises(RuntimeError, match="cuda"):
            to_tensor(np.zeros(3, np.uint32))
