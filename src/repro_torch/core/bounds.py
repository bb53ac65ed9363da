"""Lower bounds and closed-form costs (Lemmas 1–2, Theorems 1–4) + cost model.

C1 = number of rounds; C2 = Σ_t d_t (largest message, in field elements, of
round t). Total time = C1·β + C2·τ (§I).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


def ceil_log(K: int, base: int) -> int:
    """⌈log_base K⌉ computed exactly with integers."""
    if K <= 1:
        return 0
    t, v = 0, 1
    while v < K:
        v *= base
        t += 1
    return t


def ps_params(K: int, p: int):
    """prepare-and-shoot phase split (§IV): L = max{(p+1)^L < K};
    L even → (Tp, Ts) = (L/2+1, L/2); L odd → ((L+1)/2, (L+1)/2).
    Returns (L, Tp, Ts, m, n) with m=(p+1)^Tp, n=(p+1)^Ts.

    NOTE: the paper additionally assumes (n-1)m < K ≤ nm, which fails for
    many (K, p) — including its own Fig. 3 example (K=65, p=2, where
    (n-1)m = 72 ≥ 65 and the Eq. 3 correction would need packets outside
    R_k^-). Our executors use a *first-coverage coefficient mask*
    (keep contribution (ℓ, u) iff ℓ·m + offset(u) < K) that subsumes both
    Eq. 2's set semantics and Eq. 3's correction and is exact for every
    K ≤ nm — so the balanced split (and its C2) is always usable.
    (Own copy of the reference package's ``repro.core.bounds``.)
    """
    if K < 2:
        return (0, 0, 0, 1, 1)
    L = 0
    while (p + 1) ** (L + 1) < K:
        L += 1
    if L % 2 == 0:
        Tp, Ts = L // 2 + 1, L // 2
    else:
        Tp = Ts = (L + 1) // 2
    m, n = (p + 1) ** Tp, (p + 1) ** Ts
    assert K <= n * m, (K, p, L, Tp, Ts, m, n)
    return (L, Tp, Ts, m, n)


# -- lower bounds -----------------------------------------------------------


def lemma1_c1_lower(K: int, p: int) -> int:
    """Any universal algorithm has C1 >= ⌈log_{p+1} K⌉."""
    return ceil_log(K, p + 1)


def lemma2_c2_lower(K: int, p: int) -> float:
    """Any universal algorithm has C2 >= the positive root of
    p²T² − p(p−2)T + 2(1−K) >= 0  (exact form from the Lemma-2 proof)."""
    a = p * p
    b = -p * (p - 2)
    c = 2 * (1 - K)
    return (-b + math.sqrt(b * b - 4 * a * c)) / (2 * a)


# -- prepare-and-shoot (Theorem 1) -----------------------------------------


def theorem1_c1(K: int, p: int) -> int:
    return ceil_log(K, p + 1)


def theorem1_c2(K: int, p: int) -> int:
    """C2 of prepare-and-shoot as the sum of Lemma 3 + Lemma 4:
    ((p+1)^Tp - 1)/p + ((p+1)^Ts - 1)/p.

    NOTE: for odd L this equals Theorem 1's
    stated (2(p+1)^{(L+1)/2}−2)/p. For even L, Theorem 1 prints
    ((p+1)^{L/2+1}−2)/p, which is inconsistent with its own Lemmas 3+4
    (it drops the (p+1)^{L/2} shoot term); we validate against the
    lemma-consistent value and flag the discrepancy as a paper typo.
    """
    _, Tp, Ts, m, n = ps_params(K, p)
    return (m - 1) // p + (n - 1) // p


def theorem1_c2_as_printed(K: int, p: int) -> int:
    """The value as literally printed in Theorem 1 (see note above)."""
    L, *_ = ps_params(K, p)
    if L % 2 == 1:
        return (2 * (p + 1) ** ((L + 1) // 2) - 2) // p
    return ((p + 1) ** (L // 2 + 1) - 2) // p


# -- DFT butterfly (Theorem 2) ----------------------------------------------


def theorem2_c1_c2(K: int, p: int) -> tuple[int, int]:
    """C1 = C2 = log_{p+1} K, strictly optimal; requires K = (p+1)^H."""
    H = ceil_log(K, p + 1)
    if (p + 1) ** H != K:
        raise ValueError(f"K={K} is not a power of p+1={p + 1}")
    return H, H


# -- draw-and-loose (Theorem 3) ----------------------------------------------


def theorem3_c1_c2(K: int, p: int, M: int, H: int) -> tuple[int, int]:
    """K = M·(p+1)^H: C1 = ⌈log_{p+1}K⌉, C2 = H + Ψ(M), Ψ = theorem1_c2."""
    Z = (p + 1) ** H
    if M * Z != K:
        raise ValueError("K != M * (p+1)^H")
    psi = 1 if M <= p + 1 and M > 1 else theorem1_c2(M, p)
    if M == 1:
        psi = 0
    return ceil_log(K, p + 1), H + psi


# -- Lagrange (Theorem 4) ----------------------------------------------------


def theorem4_c1_c2(K: int, p: int, M: int, H: int) -> tuple[int, int]:
    """Inverse Vandermonde(ω) + forward Vandermonde(α): costs add."""
    c1, c2 = theorem3_c1_c2(K, p, M, H)
    return 2 * c1, 2 * c2


# -- cost model ---------------------------------------------------------------


@dataclass(frozen=True)
class CostModel:
    """Total time C1·β + C2·τ (§I). The defaults are the reference
    package's model constants (β = 1 µs per message start-up, τ = one 4-byte
    field element over a 50 GB/s link), kept so that both packages price a
    plan alike. They were not measured on an NVLink system: pass your own
    ``beta``/``tau`` for any statement about a real interconnect."""

    beta: float = 1e-6
    tau: float = 4.0 / 50e9  # one 4-byte field element over a 50 GB/s link

    def time(self, c1: int, c2: int, payload_elems: int = 1) -> float:
        return c1 * self.beta + c2 * payload_elems * self.tau


def allgather_baseline_c1_c2(K: int, p: int) -> tuple[int, int]:
    """Baseline: ring/tree all-gather of all K packets then local combine.

    Optimal all-gather in the p-port model: C1 = ⌈log_{p+1}K⌉ rounds with
    message sizes growing (p+1)-fold: C2 = ((p+1)^{⌈log⌉} - 1)/p ≈ K/p —
    exponentially worse than prepare-and-shoot's O(√K/p)."""
    t = ceil_log(K, p + 1)
    return t, ((p + 1) ** t - 1) // p


def direct_baseline_c1_c2(K: int, p: int) -> tuple[int, int]:
    """Baseline: every processor sends its packet directly to all K-1
    targets (coefficient applied at the receiver): ⌈(K-1)/p⌉ rounds of
    1-element messages."""
    t = math.ceil((K - 1) / p)
    return t, t
