"""The plain reference against a brute-force product mod q, its generators
against their definitions and against the program's, and its limbs against
the state's bytes read by numpy."""

import numpy as np
import pytest
import torch

from bench.reference import encode as ref_encode
from bench.reference import generators
from bench.reference.field import inverse, order_is, prime_factors
from bench.reference.generators.dft_digit_reversed import digit_reverse
from bench.reference.limbs import state_limbs

M31 = (1 << 31) - 1
NTT = 15 * (1 << 27) + 1


def cauchy_code(K):
    return {"K": K, "N": K, "p": 1, "q": M31,
            "generator": {"construction": "cauchy", "x_points": list(range(1, K + 1)),
                          "y_points": list(range(K + 1, 2 * K + 1))}}


def dft_code(K):
    return {"K": K, "N": K, "p": 1, "q": NTT,
            "generator": {"construction": "dft_digit_reversed", "radix": 2, "group_generator": 31}}


def brute(x: np.ndarray, A, q) -> np.ndarray:
    K, n = x.shape
    N = len(A[0])
    out = np.zeros((N, n), dtype=object)
    for k in range(N):
        for c in range(n):
            out[k, c] = sum(int(x[j, c]) * A[j][k] for j in range(K)) % q
    return out.astype(np.int64)


@pytest.mark.parametrize("code", [cauchy_code(8), cauchy_code(4), dft_code(8), dft_code(64)],
                         ids=["cauchy8", "cauchy4", "dft8", "dft64"])
def test_encode_equals_a_brute_force_product(code):
    rng = np.random.default_rng(7)
    q = code["q"]
    x = rng.integers(0, q, size=(code["K"], 37), dtype=np.int64)
    x[:, 0] = q - 1  # the largest residues
    A = generators.matrix(code)
    got = ref_encode.encode(torch.from_numpy(x).to(torch.int32), A, q, block_bytes=8 * code["N"] * 5)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), brute(x, A, q))


def test_cauchy_is_one_over_the_sum_of_its_points():
    A = generators.matrix(cauchy_code(8))
    for i in range(8):
        for j in range(8):
            assert A[i][j] * (i + 1 + 9 + j) % M31 == 1


def test_dft_is_the_digit_reversed_dft():
    A = generators.matrix(dft_code(64))
    beta = pow(31, (NTT - 1) // 64, NTT)
    assert order_is(beta, 64, NTT)
    for j in range(64):
        for k in range(64):
            assert A[j][k] == pow(beta, digit_reverse(j, 2, 6) * k, NTT)
    assert [digit_reverse(j, 2, 3) for j in range(8)] == [0, 4, 2, 6, 1, 5, 3, 7]


def test_the_configured_generators_are_the_programs():
    from repro_torch.core.field import Field
    from repro_torch.core.matrices import butterfly_target_matrix, cauchy_matrix

    np.testing.assert_array_equal(np.array(generators.matrix(cauchy_code(8)), dtype=np.uint64),
                                  cauchy_matrix(Field(M31), 8))
    np.testing.assert_array_equal(np.array(generators.matrix(dft_code(64)), dtype=np.uint64),
                                  butterfly_target_matrix(Field(NTT), 64, 2))


def test_field_helpers():
    assert prime_factors(NTT - 1) == [2, 3, 5]
    assert prime_factors(M31 - 1) == [2, 3, 7, 11, 31, 151, 331]
    assert inverse(3, 7) == 5
    assert order_is(31, NTT - 1, NTT) and not order_is(2, NTT - 1, NTT)


@pytest.mark.parametrize("bad", [{"radix": 3}, {"group_generator": 2}])
def test_a_bad_dft_generator_is_refused(bad):
    code = dft_code(64)
    code["generator"].update(bad)
    with pytest.raises(ValueError):
        generators.matrix(code)


def test_repeated_cauchy_points_are_refused():
    code = cauchy_code(4)
    code["generator"]["y_points"] = [1, 6, 7, 8]
    with pytest.raises(ValueError, match="distinct"):
        generators.matrix(code)


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_the_float_controls_are_wrong_on_the_dft(precision):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, NTT, size=(64, 200), dtype=np.int64)).to(torch.int32)
    A = generators.matrix(dft_code(64))
    exact = ref_encode.encode(x, A, NTT)
    low = ref_encode.encode(x, A, NTT, precision=precision)
    assert int((exact != low).sum()) > 100


def test_a_non_canonical_input_is_refused():
    x = torch.full((8, 3), M31, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        ref_encode.encode(x, generators.matrix(cauchy_code(8)), M31)


def test_limbs_are_the_state_bytes_in_pairs():
    g = torch.Generator().manual_seed(0)
    state = {
        "b": [torch.randn(3, 5, generator=g).to(torch.bfloat16), torch.tensor(7, dtype=torch.int32)],
        "a": {"z": torch.randn(4, generator=g), "mask": torch.tensor([True, False, True])},
        "c": None,
    }
    K = 4
    got = state_limbs(state, K)
    # JAX's order: a/mask, a/z, b/0, b/1; each leaf's bytes, odd counts padded with one zero byte
    parts = []
    for t in (state["a"]["mask"], state["a"]["z"], state["b"][0], state["b"][1]):
        raw = (t.numpy().astype(np.uint8).tobytes() if t.dtype == torch.bool
               else t.reshape(-1).view(torch.uint8).numpy().tobytes())
        if len(raw) % 2:
            raw += b"\0"
        parts.append(np.frombuffer(raw, dtype="<u2").astype(np.int64))
    limbs = np.concatenate(parts)
    S = -(-limbs.size // K)
    limbs = np.concatenate([limbs, np.zeros(S * K - limbs.size, dtype=np.int64)]).reshape(K, S)
    np.testing.assert_array_equal(got.numpy(), limbs)


def test_limbs_equal_the_programs_shards():
    from repro_torch.coded.rs_checkpoint import shard_state_limbs

    g = torch.Generator().manual_seed(1)
    state = {"params": {"w": torch.randn(33, 7, generator=g).to(torch.bfloat16)},
             "opt": {"m": {"w": torch.randn(33, 7, generator=g)}, "v": {"w": torch.rand(33, 7, generator=g)},
                     "step": torch.tensor(12, dtype=torch.int32)}}
    program, _ = shard_state_limbs(state, 8, "cpu")
    assert torch.equal(program, state_limbs(state, 8))
