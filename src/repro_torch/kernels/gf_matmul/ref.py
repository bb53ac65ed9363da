"""Oracles for the GF(q) matrix product: C = (A @ B) mod q.

``gf_matmul_ref`` goes through the device tier of ``core.field`` (``mmul`` and
``madd``, the limb arithmetic of the reference) — slow, O(MNK) modular
multiplies, but independent of both the kernel and its plain version.
``gf_matmul_host`` is the exact numpy ``uint64`` oracle for big shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.field import Field, madd, mmul


def gf_matmul_ref(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """(A @ B) mod q through ``mmul``/``madd``. a: (..., M, K), b: (..., K, N),
    ``int32`` bit patterns."""
    K = a.shape[-1]
    acc = mmul(a[..., :, 0, None], b[..., 0, None, :], q)
    for k in range(1, K):
        acc = madd(acc, mmul(a[..., :, k, None], b[..., k, None, :], q), q)
    return acc


def gf_matmul_host(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Exact numpy uint64 oracle."""
    return Field(q).matmul(a, b)
