"""Coded gradient aggregation for straggler mitigation (float field).

Cyclic-repetition gradient coding (Tandon et al., ICML'17 construction,
randomized coefficients): K workers, each computes gradients of r = s+1
data shards (cyclic assignment) and transmits ONE coded combination

    c_i = Σ_{j ∈ supp(i)} B[i, j] · g_j ,   supp(i) = {i, i+1, .., i+s} mod K.

The full-batch gradient Σ_j g_j is recoverable from ANY K−s workers: solve
aᵀ B[S] = 1ᵀ for the surviving rows S (solvable w.p. 1 for random B — the
solve is checked at build time for every survivor pattern size via random
sampling, and at decode time by residual check).

This is the all-to-all-encode view of gradient coding: B is just another
generator matrix; over a mesh the combination is the same permutation
schedule with float payloads (orthonormal-DFT variants available via
``core.matrices.dft_matrix_float`` for conditioning).

The plans are host numpy; the combinations are float32 tensor arithmetic on
the device where the gradients lie, leaf by leaf through ``repro_torch.tree``.
Each coefficient is a Python float, so a product is one float32 multiply by
the coefficient rounded to float32, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .. import tree


@dataclass(frozen=True)
class GradCodingPlan:
    K: int
    s: int  # max stragglers tolerated
    B: np.ndarray  # (K, K) float64 coding matrix, row i supported on supp(i)

    @property
    def r(self) -> int:  # replication factor
        return self.s + 1


def build_grad_coding(K: int, s: int, seed: int = 0) -> GradCodingPlan:
    """Tandon et al. cyclic construction (their Alg. 2): pick H ∈ R^{s×K}
    random with columns summing to 0 (so H·1 = 0); row i of B has support
    {i..i+s}, B[i,i] = 1 and the rest solve H[:, supp\\{i}]·x = −H[:, i] —
    hence B·Hᵀ = 0. Any K−s rows of B are a.s. linearly independent and span
    null(H) ∋ 1, which is exactly the decodability condition."""
    if s == 0:
        return GradCodingPlan(K=K, s=0, B=np.eye(K))
    rng = np.random.default_rng(seed)
    H = rng.normal(size=(s, K))
    H[:, -1] = -H[:, :-1].sum(axis=1)  # columns sum to zero → H·1 = 0
    B = np.zeros((K, K))
    for i in range(K):
        sup = [(i + d) % K for d in range(s + 1)]
        rest = sup[1:]
        x = np.linalg.solve(H[:, rest], -H[:, i])
        B[i, i] = 1.0
        B[i, rest] = x
    return GradCodingPlan(K=K, s=s, B=B)


def decode_vector(plan: GradCodingPlan, survivors: list[int]) -> np.ndarray:
    """a (len survivors) with aᵀ B[survivors] = 1ᵀ (least squares, residual
    checked)."""
    Bs = plan.B[sorted(survivors)]
    a, res, rank, _ = np.linalg.lstsq(Bs.T, np.ones(plan.K), rcond=None)
    err = np.linalg.norm(Bs.T @ a - 1.0)
    if err > 1e-6:
        raise RuntimeError(
            f"survivor set {survivors} cannot decode (residual {err:.2e}); "
            f"more than s={plan.s} stragglers?"
        )
    return a


def worker_combine(plan: GradCodingPlan, worker: int, shard_grads: dict[int, Any]):
    """c_i = Σ_{j∈supp} B[i,j]·g_j. shard_grads: {shard j → grad pytree}."""
    sup = [(worker + d) % plan.K for d in range(plan.s + 1)]
    coef = [float(plan.B[worker, j]) for j in sup]

    def comb(*gs):
        return sum(c * g.to(torch.float32) for c, g in zip(coef, gs))

    return tree.map(comb, *[shard_grads[j] for j in sup])


def aggregate(plan: GradCodingPlan, received: dict[int, Any]):
    """Recover Σ_j g_j from any ≥ K−s workers' combinations."""
    survivors = sorted(received)
    a = [float(ai) for ai in decode_vector(plan, survivors)]

    def comb(*cs):
        return sum(ai * c for ai, c in zip(a, cs))

    return tree.map(comb, *[received[i] for i in survivors])
