"""Finite-field arithmetic for all-to-all encode (PyTorch port).

Two concrete primes:

* ``M31 = 2**31 - 1`` — Mersenne; default storage-code field.
* ``NTT = 15 * 2**27 + 1 = 2013265921`` — 2-adic valuation 27, so radix-2
  DFT subgroups (butterflies) exist for any power-of-two encode-axis size
  up to ``2**27``.

Two implementation tiers, with the names of the reference package's
``repro.core.field``:

* **Host tier** (numpy ``uint64``): exact 62-bit products, used for matrix
  construction, schedule/twiddle precomputation, decoding and the cost-exact
  synchronous-network simulator. It is the reference's host tier unchanged.
* **Device tier** (torch): the same functions with the same values as the
  reference's ``uint32`` tier, on tensors.

Representation — decided here, held everywhere in ``repro_torch``
---------------------------------------------------------------
A field element, a Shoup dual, or any other 32-bit unsigned word lives in a
``torch.int32`` tensor as its **bit pattern**: four bytes an element. PyTorch
can store ``uint32`` but not add, multiply or shift it, so the signed type
carries the bits. Canonical residues are ``< q < 2**31`` and therefore read
the same signed or unsigned. Shoup duals ``floor(c * 2**32 / q)`` reach
``2**32 - 1``; above ``2**31`` they show as negative ``int32`` values, which
the CUDA kernels reinterpret as ``uint32_t`` and the functions below widen to
``int64`` and mask with ``0xFFFFFFFF``. ``repro_torch.convert.to_tensor`` /
``to_numpy`` move ``np.uint32`` arrays in and out by ``view``; a test compares
``out.cpu().numpy().view(np.uint32)`` with the reference's ``uint32``.

The device-tier functions accept ``int32`` tensors (bit patterns), ``int64``
tensors holding values in ``[0, 2**32)``, or Python ints, and return
``int32``. ``madd``/``msub``/``mneg`` stay in ``int32`` (two's-complement
wrap-around is the ``uint32`` arithmetic of the reference, and an unsigned
comparison is a signed one after flipping the top bit); every function that
multiplies works in ``int64`` and emulates the 32-bit wrap by masking, step
for step as the reference computes it, so the values agree for every 32-bit
input and not only for canonical ones.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

M31 = (1 << 31) - 1  # 2147483647
NTT = 15 * (1 << 27) + 1  # 2013265921

_MASK31 = np.uint64(M31)

# q - 1 factorizations (verified in tests) — needed for primitive-root checks.
_GROUP_FACTORS = {
    M31: (2, 3, 7, 11, 31, 151, 331),
    NTT: (2, 3, 5),
}

# Standard generators of the multiplicative groups (verified in tests).
_GENERATORS = {M31: 7, NTT: 31}

__all__ = [
    "M31",
    "NTT",
    "Field",
    "madd",
    "msub",
    "mneg",
    "mmul_m31",
    "umulhi32",
    "umulhi32_full",
    "barrett32",
    "shoup_precompute",
    "shoup_mul",
    "mmul",
    "two_adic_valuation",
    "radix_valuation",
    "resolve_device",
    "to_tensor",
    "to_numpy",
]


# --------------------------------------------------------------------------
# Host tier: exact numpy uint64 field arithmetic
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Field:
    """GF(q) for a prime q < 2**31, exact host-side arithmetic.

    All array arguments are numpy arrays (or python ints) of nonnegative
    integers; results are canonical representatives in ``[0, q)`` as
    ``uint64``.
    """

    q: int = M31

    def __post_init__(self):
        if not (2 < self.q < (1 << 31)):
            raise ValueError(f"q={self.q} out of supported range (3, 2^31)")

    # -- element ops -------------------------------------------------------
    def asarray(self, x) -> np.ndarray:
        a = np.asarray(x, dtype=np.uint64)
        return a % np.uint64(self.q)

    def add(self, a, b):
        return (self.asarray(a) + self.asarray(b)) % np.uint64(self.q)

    def sub(self, a, b):
        return (self.asarray(a) + np.uint64(self.q) - self.asarray(b)) % np.uint64(self.q)

    def neg(self, a):
        return (np.uint64(self.q) - self.asarray(a)) % np.uint64(self.q)

    def mul(self, a, b):
        # products of two < 2^31 values fit in 62 bits < uint64.
        return (self.asarray(a) * self.asarray(b)) % np.uint64(self.q)

    def pow(self, a, e) -> np.ndarray:
        """Element-wise a**e mod q (e: python int or int array >= 0)."""
        a = self.asarray(a)
        e_arr = np.broadcast_arrays(np.asarray(e, dtype=np.int64), a.astype(np.int64))[0].copy()
        result = np.ones_like(a)
        base = a.copy()
        e_work = e_arr.astype(np.uint64).copy()
        while np.any(e_work > 0):
            odd = (e_work & np.uint64(1)).astype(bool)
            result = np.where(odd, self.mul(result, base), result)
            e_work >>= np.uint64(1)
            if np.any(e_work > 0):
                base = self.mul(base, base)
        return result

    def inv(self, a) -> np.ndarray:
        """Element-wise multiplicative inverse (Fermat)."""
        a = self.asarray(a)
        if np.any(a == 0):
            raise ZeroDivisionError("inverse of 0 in GF(q)")
        return self.pow(a, self.q - 2)

    # -- linear algebra ----------------------------------------------------
    def matmul(self, A, B) -> np.ndarray:
        """Exact (A @ B) mod q. Blocks the contraction so uint64 never overflows.

        Each product < q^2 < 2^62; we can add up to 3 such terms within
        uint64 (2^64 / 2^62 = 4), so reduce every 3 accumulands.
        """
        A = self.asarray(A)
        B = self.asarray(B)
        if A.ndim == 1:
            A = A[None, :]
            squeeze = True
        else:
            squeeze = False
        n = A.shape[-1]
        q = np.uint64(self.q)
        out = np.zeros((*A.shape[:-1], B.shape[-1]), dtype=np.uint64)
        step = 3
        for s in range(0, n, step):
            chunk = np.einsum(
                "...k,kj->...j", A[..., s : s + step], B[s : s + step], dtype=np.uint64
            )
            out = (out + chunk % q) % q
        return out[0] if squeeze else out

    def solve(self, A, b) -> np.ndarray:
        """Solve A x = b mod q by Gaussian elimination (A square invertible)."""
        A = self.asarray(A).copy()
        b = self.asarray(b).copy()
        n = A.shape[0]
        if b.ndim == 1:
            b = b[:, None]
            squeeze = True
        else:
            squeeze = False
        q = np.uint64(self.q)
        for col in range(n):
            piv_candidates = np.nonzero(A[col:, col])[0]
            if piv_candidates.size == 0:
                raise np.linalg.LinAlgError("singular matrix over GF(q)")
            piv = col + int(piv_candidates[0])
            if piv != col:
                A[[col, piv]] = A[[piv, col]]
                b[[col, piv]] = b[[piv, col]]
            inv_p = self.inv(A[col, col])
            A[col] = self.mul(A[col], inv_p)
            b[col] = self.mul(b[col], inv_p)
            for row in range(n):
                if row != col and A[row, col] != 0:
                    factor = A[row, col]
                    A[row] = (A[row] + (q - factor) * A[col] % q) % q
                    b[row] = (b[row] + (q - factor) * b[col] % q) % q
        x = b
        return x[:, 0] if squeeze else x

    def inv_matrix(self, A) -> np.ndarray:
        A = self.asarray(A)
        return self.solve(A, np.eye(A.shape[0], dtype=np.uint64))

    # -- group structure ---------------------------------------------------
    @property
    def generator(self) -> int:
        if self.q in _GENERATORS:
            return _GENERATORS[self.q]
        return self._find_generator()

    def _find_generator(self) -> int:
        factors = self._factor_group_order()
        order = self.q - 1
        for g in range(2, self.q):
            if all(pow(g, order // f, self.q) != 1 for f in factors):
                return g
        raise RuntimeError("no generator found (q not prime?)")

    def _factor_group_order(self):
        if self.q in _GROUP_FACTORS:
            return _GROUP_FACTORS[self.q]
        n = self.q - 1
        factors = []
        d = 2
        while d * d <= n:
            if n % d == 0:
                factors.append(d)
                while n % d == 0:
                    n //= d
            d += 1
        if n > 1:
            factors.append(n)
        return tuple(factors)

    def root_of_unity(self, n: int) -> int:
        """A primitive n-th root of unity; requires n | q-1."""
        if (self.q - 1) % n != 0:
            raise ValueError(f"{n} does not divide q-1={self.q - 1}")
        beta = pow(self.generator, (self.q - 1) // n, self.q)
        return beta


def two_adic_valuation(n: int) -> int:
    v = 0
    while n % 2 == 0:
        n //= 2
        v += 1
    return v


def radix_valuation(n: int, r: int) -> int:
    """Largest h with r**h | n."""
    v = 0
    while n % r == 0:
        n //= r
        v += 1
    return v


# --------------------------------------------------------------------------
# Device tier: 32-bit modular arithmetic on torch tensors
# --------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 31)  # int32 bit pattern 0x80000000


def _wide(x):
    """A 32-bit word as a non-negative ``int64`` tensor (or Python int)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK32
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.astype(np.int64)) & _MASK32
    return int(x) & _MASK32


def _narrow(v, out=None):
    """An ``int64`` value in ``[0, 2**32)`` as its ``int32`` bit pattern,
    written into ``out`` (an ``int32`` tensor of its shape, any strides) when
    given: the subtraction's result is cast as it is stored, with no copy
    after it."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v, dtype=torch.int64)
    if out is not None:
        return torch.sub(v ^ 0x80000000, 0x80000000, out=out)
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32)


def _word(x):
    """A 32-bit word as an ``int32`` tensor, or a Python int wrapped into the
    signed range so it broadcasts against ``int32`` tensors."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.int32 else _narrow(x & _MASK32)
    if isinstance(x, np.ndarray):
        return _narrow(_wide(x))
    x = int(x) & _MASK32
    return x - (1 << 32) if x >= (1 << 31) else x


def _words(a, b):
    """Both operands as ``int32``, at least one of them a tensor."""
    a, b = _word(a), _word(b)
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = torch.as_tensor(a, dtype=torch.int32)
    return a, b


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card
    (``torch.device("cuda")``), and asking for a CUDA device on a machine
    without one raises — nothing carries on on the CPU unasked. Only an
    explicit ``device="cpu"`` runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and torch.cuda.is_available() is "
            'False; pass device="cpu" to run the plain PyTorch path on the CPU'
        )
    return dev


def to_tensor(x, device=None) -> torch.Tensor:
    """32-bit words (a numpy array of any integer type with values in
    ``[0, 2**32)``, a tensor, or an int) as an ``int32`` bit-pattern tensor on
    ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return _word(x).to(dev)
    arr = np.ascontiguousarray(np.asarray(x).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """An ``int32`` bit-pattern tensor as a ``np.uint32`` array on the host."""
    return _word(t).detach().cpu().contiguous().numpy().view(np.uint32)


def _csub(s, q: int, out=None):
    """``s - q`` where the unsigned value of ``s`` is ``>= q`` (q < 2**31),
    into ``out`` when given."""
    return torch.where((s < 0) | (s >= q), s - q, s, out=out)


def madd(a, b, q: int, out=None):
    """(a + b) mod q for canonical a, b < q < 2^31. Sum < 2^32: no overflow.
    Written into ``out`` (an ``int32`` tensor of the result's shape, any
    strides; it may be ``a``) when given."""
    a, b = _words(a, b)
    return _csub(a + b, q, out)


def msub(a, b, q: int):
    """(a - b) mod q for canonical a, b < q."""
    a, b = _words(a, b)
    return torch.where((a ^ _SIGN) >= (b ^ _SIGN), a - b, a + (q - b))


def mneg(a, q: int):
    a = _word(a)
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, dtype=torch.int32)
    return torch.where(a == 0, a, q - a)


def _limbs(a):
    a = _wide(a)
    return a >> 16, a & 0xFFFF


def umulhi32(a, b):
    """High 32 bits of the 64-bit product a*b, for BOTH a, b < 2^31.

    a = a1*2^16 + a0, b = b1*2^16 + b0; m0 = a0*b0, m1 = a0*b1 + a1*b0,
    m2 = a1*b1; hi = m2 + ((m1 + (m0 >> 16)) >> 16). As in the reference the
    sum m1 is taken in 32 bits, so it is exact only for operands below 2^31;
    for operands that may reach 2^32 use :func:`umulhi32_full`.
    """
    a1, a0 = _limbs(a)
    b1, b0 = _limbs(b)
    m0 = a0 * b0
    m1 = (a0 * b1 + a1 * b0) & _MASK32
    m2 = a1 * b1
    w = (m1 + (m0 >> 16)) & _MASK32
    return _narrow((m2 + (w >> 16)) & _MASK32)


def _umulhi_full_wide(a, b):
    a1, a0 = _limbs(a)
    b1, b0 = _limbs(b)
    # every partial product < 2^32 and their sum < 2^34: exact in int64
    w = a0 * b1 + a1 * b0 + ((a0 * b0) >> 16)
    return a1 * b1 + (w >> 16)


def umulhi32_full(a, b):
    """High 32 bits of a*b for ANY 32-bit a, b (the carry of the cross terms
    is kept: the sums are taken in ``int64``)."""
    return _narrow(_umulhi_full_wide(a, b))


def _fold31(x):
    return (x >> 31) + (x & M31)


def _csub_wide(x, q: int):
    return torch.where(x >= q, x - q, x) if isinstance(x, torch.Tensor) else (
        x - q if x >= q else x
    )


def mmul_m31(a, b):
    """(a * b) mod M31 for canonical a, b < M31.

    Uses 2^31 ≡ 1 (mod M31) on the 16-bit-limb partial products, with the
    reference's grouping: full = m2*2^32 + m1*2^16 + m0,
    u = 2*m2 + (m1 >> 15) + (m0 >> 31), v = (m1 & 0x7fff)*2^16 + (m0 & M31),
    each folded once and reduced, then added mod M31.
    """
    a1, a0 = _limbs(a)
    b1, b0 = _limbs(b)
    m0 = a0 * b0
    m1 = (a0 * b1 + a1 * b0) & _MASK32
    m2 = a1 * b1
    u = ((m2 << 1) + (m1 >> 15) + (m0 >> 31)) & _MASK32
    v = (((m1 & 0x7FFF) << 16) + (m0 & M31)) & _MASK32
    u = _csub_wide(_fold31(u), M31)
    v = _csub_wide(_fold31(v), M31)
    return _narrow(_csub_wide(u + v, M31))


def shoup_precompute(c, q: int) -> np.ndarray:
    """Host-side: c' = floor(c * 2^32 / q) for constant multiplicand c < q."""
    c = np.asarray(c, dtype=np.uint64)
    return ((c << np.uint64(32)) // np.uint64(q)).astype(np.uint32)


def _shoup_wide(a, c, c_pre, q: int):
    """Shoup product on non-negative ``int64`` words; result ``int64 < 2^32``."""
    t = _umulhi_full_wide(a, c_pre)
    r = (a * c - t * q) & _MASK32  # int64 wraps mod 2^64, so mod 2^32 is exact
    return _csub_wide(r, q)


def shoup_mul(a, c, c_pre, q: int, out=None):
    """(a * c) mod q with Shoup-precomputed c' = floor(c*2^32/q).

    t = floor(a * c' / 2^32) satisfies floor(a*c/q) - 1 <= t <= floor(a*c/q),
    so r = a*c - t*q ∈ [0, 2q), taken mod 2^32 (exact because the true
    r < 2q < 2^32) and reduced by one conditional subtraction. Written into
    ``out`` (an ``int32`` tensor of the result's shape, any strides) when
    given.
    """
    return _narrow(_shoup_wide(_wide(a), _wide(c), _wide(c_pre), q), out)


@functools.lru_cache(maxsize=None)
def _barrett_consts(q: int):
    m = ((1 << 32) // q) & 0xFFFFFFFF  # floor(2^32/q); q > 2 so fits 32 bits
    r16 = (1 << 16) % q
    r32 = (1 << 32) % q
    r16_pre = int(shoup_precompute(r16, q))
    r32_pre = int(shoup_precompute(r32, q))
    return m, r16, r32, r16_pre, r32_pre


def _barrett_wide(x, q: int):
    m, *_ = _barrett_consts(q)
    t = _umulhi_full_wide(x, m)
    r = (x - t * q) & _MASK32
    return _csub_wide(r, q)


def barrett32(x, q: int):
    """x mod q for any 32-bit x (q < 2^31): one Barrett step + one
    conditional subtraction.

    t = floor(x * floor(2^32/q) / 2^32) >= floor(x/q) - 1, so r = x - t*q
    ∈ [0, 2q) < 2^32.
    """
    return _narrow(_barrett_wide(_wide(x), q))


def mmul(a, b, q: int):
    """(a * b) mod q for canonical a, b < q, any prime q < 2^31.

    Mersenne-31 goes through :func:`mmul_m31`; otherwise the reference's
    16-bit-limb schoolbook with Barrett folds and Shoup multiplies by the
    constants 2^16 mod q and 2^32 mod q.
    """
    if q == M31:
        return mmul_m31(a, b)
    _, r16, r32, r16_pre, r32_pre = _barrett_consts(q)
    a1, a0 = _limbs(a)
    b1, b0 = _limbs(b)
    m0 = a0 * b0
    m1 = (a0 * b1 + a1 * b0) & _MASK32
    m2 = a1 * b1
    t0 = _barrett_wide(m0, q)
    t1 = _shoup_wide(_barrett_wide(m1, q), r16, r16_pre, q)
    t2 = _shoup_wide(_barrett_wide(m2, q), r32, r32_pre, q)
    s = _csub_wide(t0 + t1, q)  # canonical terms: plain sums below 2^32
    return _narrow(_csub_wide(s + t2, q))
