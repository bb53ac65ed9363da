"""``x @ A`` over GF(q) in plain PyTorch: the coded rows the benchmark
compares with what the program returns.

Row ``k`` of the result is ``sum_j x[j] * A[j][k] mod q``, each product
taken in ``int64`` (below 2^62 for canonical operands) and reduced, the sum of
at most 2^32 reduced products kept in ``int64``. The columns are walked in
blocks so that the temporaries stay near ``block_bytes`` whatever the
payload's width.

``precision`` other than ``"exact"`` is the benchmark's control: the same
sums with every product and sum in ``torch.float64`` or ``torch.float32``,
the step below exact integers that a faster encode might take. It must come
out wrong, and the comparison must say so.
"""

from __future__ import annotations

import torch

PRECISIONS = {"exact": torch.int64, "float64": torch.float64, "float32": torch.float32}


def check_canonical(x: torch.Tensor, q: int, what: str) -> None:
    if x.ndim != 2 or x.dtype != torch.int32:
        raise ValueError(f"{what} must be a 2-D int32 tensor, got {tuple(x.shape)} {x.dtype}")
    if x.numel() and (int(x.min()) < 0 or int(x.max()) >= q):
        raise ValueError(f"{what} holds a value outside [0, {q})")


def encode(x: torch.Tensor, A: list[list[int]], q: int, *, precision: str = "exact",
           block_bytes: int = 1 << 28) -> torch.Tensor:
    """The (N, n) ``int32`` coded rows of a (K, n) ``int32`` tensor of
    canonical residues, on ``x``'s device."""
    check_canonical(x, q, "x")
    K, n = x.shape
    N = len(A[0])
    if len(A) != K:
        raise ValueError(f"x has {K} rows, the generator {len(A)}")
    dt = PRECISIONS[precision]
    coef = torch.tensor(A, dtype=torch.int64, device=x.device).to(dt)  # (K, N)
    out = torch.empty((N, n), dtype=torch.int32, device=x.device)
    width = max(1, block_bytes // (8 * N))
    for lo in range(0, n, width):
        hi = min(lo + width, n)
        xb = x[:, lo:hi].to(dt)
        acc = torch.zeros((N, hi - lo), dtype=dt, device=x.device)
        for j in range(K):
            acc += torch.remainder(coef[j][:, None] * xb[j][None, :], q)
        out[:, lo:hi] = torch.remainder(acc, q).to(torch.int64).to(torch.int32)
        del xb, acc
    return out
