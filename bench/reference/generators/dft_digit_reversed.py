"""The K-point DFT over GF(q) with its rows in digit-reversed order:
``A[j][k] = beta ** (rev(j) * k)``, ``beta = g ** ((q - 1) / K)`` for the
configuration's primitive root ``g``, and ``rev`` reversing the ``radix``
digits of ``j``. It is what a radix-``radix`` butterfly with ``log_radix K``
rounds computes in place (Theorem 2 of arXiv:2205.05183); an RS code's
generator, since it is a row permutation of a Vandermonde matrix.
"""

from __future__ import annotations

from ..field import check_field, order_is


def digit_reverse(j: int, radix: int, digits: int) -> int:
    out = 0
    for _ in range(digits):
        out = out * radix + j % radix
        j //= radix
    return out


def matrix(code: dict) -> list[list[int]]:
    q, K, N = code["q"], code["K"], code["N"]
    check_field(q)
    gen = code["generator"]
    radix, g = int(gen["radix"]), int(gen["group_generator"])
    if N != K:
        raise ValueError(f"a DFT generator is square, got K = {K}, N = {N}")
    digits = 0
    while radix ** digits < K:
        digits += 1
    if radix ** digits != K:
        raise ValueError(f"K = {K} is not a power of radix {radix}")
    if (q - 1) % K:
        raise ValueError(f"K = {K} does not divide q - 1")
    if not order_is(g, q - 1, q):
        raise ValueError(f"{g} is not a primitive root mod {q}")
    beta = pow(g, (q - 1) // K, q)
    if not order_is(beta, K, q):
        raise ValueError(f"beta = {beta} is not a primitive {K}-th root of unity")
    return [[pow(beta, digit_reverse(j, radix, digits) * k, q) for k in range(K)] for j in range(K)]
