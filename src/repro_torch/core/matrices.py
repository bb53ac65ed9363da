"""Generator-matrix constructions (host tier, exact).

All functions return numpy ``uint64`` canonical-representative matrices.
Conventions follow the paper: ``(x_0..x_{K-1}) @ A = (x̃_0..x̃_{K-1})``,
i.e. processor k's coded packet is defined by *column* k of A.
"""

from __future__ import annotations

import numpy as np

from .field import Field, radix_valuation


def vandermonde(field: Field, points, nrows: int | None = None) -> np.ndarray:
    """A[i, j] = points[j] ** i, shape (nrows, len(points))."""
    pts = field.asarray(points)
    n = nrows if nrows is not None else pts.shape[0]
    rows = [np.ones_like(pts)]
    for _ in range(1, n):
        rows.append(field.mul(rows[-1], pts))
    return np.stack(rows, axis=0)


def dft_matrix(field: Field, K: int) -> np.ndarray:
    """The K×K DFT matrix D_K (Eq. 4); requires K | q-1."""
    beta = field.root_of_unity(K)
    return vandermonde(field, field.pow(np.full(K, beta, dtype=np.uint64), np.arange(K)))


def distinct_points(field: Field, K: int, seed: int = 0) -> np.ndarray:
    """K distinct nonzero evaluation points (deterministic)."""
    if K > field.q - 1:
        raise ValueError("need K <= q-1 distinct nonzero points")
    rng = np.random.default_rng(seed)
    # powers of the generator at random distinct exponents — distinct, nonzero
    exps = rng.choice(field.q - 1, size=K, replace=False)
    g = np.full(K, field.generator, dtype=np.uint64)
    return field.pow(g, exps)


def lagrange_matrix(field: Field, alphas, omegas) -> np.ndarray:
    """A[k, j] = Φ_k(α_j) with Φ_k(z) = Π_{i≠k} (z-ω_i)/(ω_k-ω_i)  (§VI).

    Maps point-values f(ω_k) to point-values f(α_j):  x̃ = x @ A.
    """
    alphas = field.asarray(alphas)
    omegas = field.asarray(omegas)
    K = omegas.shape[0]
    # numerator_j(k) = Π_{i≠k} (α_j - ω_i); denominator(k) = Π_{i≠k} (ω_k - ω_i)
    A = np.zeros((K, alphas.shape[0]), dtype=np.uint64)
    denom = np.ones(K, dtype=np.uint64)
    for i in range(K):
        diff = field.sub(omegas, omegas[i])
        diff = np.where(np.arange(K) == i, np.uint64(1), diff)
        denom = field.mul(denom, diff)
    denom_inv = field.inv(denom)
    for k in range(K):
        num = np.ones_like(alphas)
        for i in range(K):
            if i == k:
                continue
            num = field.mul(num, field.sub(alphas, omegas[i]))
        A[k] = field.mul(num, denom_inv[k])
    return A


def cauchy_matrix(field: Field, K: int, N: int | None = None, seed: int = 0) -> np.ndarray:
    """A[i, j] = 1/(x_i + y_j) with all x_i, y_j distinct and x_i + y_j ≠ 0.

    EVERY square submatrix of a Cauchy matrix is invertible — the guarantee
    the coded-checkpoint recovery needs (any f lost shards recoverable from
    any f surviving parity equations). Cauchy generators are the paper's own
    §VII 'future work'; computing one is a direct application of the
    universal prepare-and-shoot algorithm (it computes ANY matrix)."""
    N = N or K
    if K + N > field.q:
        raise ValueError("need K+N distinct field elements")
    xs = np.arange(1, K + 1, dtype=np.uint64)
    ys = np.arange(K + 1, K + N + 1, dtype=np.uint64)
    s = field.add(xs[:, None], ys[None, :])
    return field.inv(s)


def random_matrix(field: Field, K: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, field.q, size=(K, K), dtype=np.uint64)


def random_vector(field: Field, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, field.q, size=shape, dtype=np.uint64)


def digit_reverse(k: int, radix: int, ndigits: int) -> int:
    """Reverse the base-``radix`` digits of k (ndigits wide)."""
    out = 0
    for _ in range(ndigits):
        out = out * radix + k % radix
        k //= radix
    return out


def digit_reversal_permutation(K: int, radix: int) -> np.ndarray:
    H = radix_valuation(K, radix)
    if radix**H != K:
        raise ValueError(f"K={K} is not a power of radix={radix}")
    return np.array([digit_reverse(k, radix, H) for k in range(K)], dtype=np.int64)


def butterfly_target_matrix(field: Field, K: int, radix: int) -> np.ndarray:
    """The matrix the DFT butterfly actually computes: rev-row-permuted D_K.

    out[k] = Σ_j x_j β^{rev(j)·k}  ⇔  A[j, k] = β^{rev(j) k}.
    Row permutation of D_K ⇒ still an MDS/Vandermonde generator.
    """
    D = dft_matrix(field, K)
    rev = digit_reversal_permutation(K, radix)
    return D[rev, :]


def dft_matrix_float(K: int) -> np.ndarray:
    """Orthonormal complex DFT for the float-field instantiation
    (gradient coding): perfectly conditioned."""
    j = np.arange(K)
    W = np.exp(-2j * np.pi * np.outer(j, j) / K) / np.sqrt(K)
    return W
