"""Arithmetic in GF(q) on Python integers, for building generators."""

from __future__ import annotations


def prime_factors(n: int) -> list[int]:
    """The distinct prime factors of ``n`` by trial division."""
    out, d = [], 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return out


def is_prime(q: int) -> bool:
    return q > 1 and prime_factors(q) == [q]


def inverse(a: int, q: int) -> int:
    a %= q
    if a == 0:
        raise ZeroDivisionError(f"0 has no inverse mod {q}")
    return pow(a, q - 2, q)


def order_is(g: int, n: int, q: int) -> bool:
    """Whether ``g`` has multiplicative order exactly ``n`` mod ``q``."""
    if pow(g, n, q) != 1:
        return False
    return all(pow(g, n // f, q) != 1 for f in prime_factors(n))


def check_field(q: int) -> None:
    if not is_prime(q):
        raise ValueError(f"q = {q} is not prime")
    if q >= 1 << 31:
        raise ValueError(f"q = {q} does not fit a 31-bit residue")
