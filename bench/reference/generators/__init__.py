"""Generator constructions of the reference, one module each.

A module ``<construction>.py`` defines ``matrix(code) -> list[list[int]]``:
the (K, N) generator ``A`` of the code described by a configuration's
``code`` object, such that coded row ``k`` is ``sum_j x[j] * A[j][k] mod q``.
"""

from __future__ import annotations

import importlib


def matrix(code: dict) -> list[list[int]]:
    construction = code["generator"]["construction"]
    if not construction.isidentifier():
        raise ValueError(f"bad generator construction {construction!r}")
    mod = importlib.import_module(f"{__name__}.{construction}")
    A = mod.matrix(code)
    K, N = code["K"], code["N"]
    if len(A) != K or any(len(row) != N for row in A):
        raise ValueError(f"{construction} gave a generator that is not {K} x {N}")
    if any(not 0 <= a < code["q"] for row in A for a in row):
        raise ValueError(f"{construction} gave a non-canonical coefficient")
    return A
