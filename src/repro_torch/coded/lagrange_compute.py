"""Lagrange Coded Computing (LCC) — the paper's §VI use case
[Yu et al., AISTATS'19], extended to true (N, K) erasure codes.

Task: K workers hold data blocks X_1..X_K; compute f(X_i) = X_i @ W for all
i, tolerating stragglers. LCC encodes the blocks as evaluations of the
degree-(K−1) polynomial u(z) with u(ω_i) = X_i at N ≥ K points α_j — which
is EXACTLY the all-to-all-encode of a Lagrange matrix (Theorem 4: inverse
Vandermonde then forward Vandermonde, both by draw-and-loose). Worker j
computes f(u(α_j)) = u(α_j) @ W — evaluations of the degree-(K−1) polynomial
f∘u — and any K results interpolate back to f(X_i) = (f∘u)(ω_i).

Two regimes:

* ``R == 0`` (N = K, the original §VI example): the square Lagrange
  generator runs through the Theorem 4 draw-and-loose composite
  (inverse-Vandermonde ∘ forward-Vandermonde).
* ``R > 0`` (N = K + R coded replicas, the serving tier's straggler /
  fault-tolerance regime): the K data rows are zero-padded to N
  processors and encoded with the **padded Lagrange/Vandermonde
  generator** A (A[:K, :] = lagrange_matrix(α_0..α_{N−1}, ω_0..ω_{K−1}),
  rows K..N−1 zero) in ONE universal prepare-and-shoot all-to-all encode
  — or, through :func:`lcc_encode_collective`, as the compiled round
  schedule of ``dist.collectives.ps_encode``. Any K of the N coded shards
  reconstruct every X_i bit-exactly (:func:`lcc_decode`).

Everything is exact over GF(q) (data quantized to field elements), so the
decode is bit-exact. The encodes run on the device where ``X`` lies (a numpy
array goes to the card); the decodes run on the host in numpy, as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.draw_loose import encode_lagrange
from ..core.field import NTT, Field
from ..core.matrices import distinct_points, lagrange_matrix
from ..core.prepare_shoot import encode_universal
from ..core.schedule import plan_constants, plan_draw_loose
from ..dist.collectives import ps_encode
from ..dist.ranks import ps_encode_ranks
from .rs_checkpoint import BlockedEncode, as_residues, encode_columns


@dataclass(frozen=True)
class LCCPlan:
    K: int
    p: int
    q: int
    plan_omega: object
    plan_alpha: object
    #: parity shards beyond K — N = K + R total coded replicas
    R: int = 0
    #: N evaluation points α_0..α_{N−1} when R > 0 (else plan_alpha.points)
    alphas: np.ndarray | None = None

    @property
    def N(self) -> int:
        return self.K + self.R

    @property
    def omega_points(self):
        return self.plan_omega.points

    @property
    def alpha_points(self):
        return self.alphas if self.alphas is not None else self.plan_alpha.points


def build_lcc(K: int, p: int = 1, q: int = NTT, R: int = 0) -> LCCPlan:
    """LCC plan for K data shards and N = K + R coded shards.

    R = 0 reproduces the original square (N = K) §VI example; R > 0 adds
    parity evaluation points so any K-of-N shards decode."""
    if R < 0:
        raise ValueError(f"R must be ≥ 0, got {R}")
    plan_omega = plan_draw_loose(K, p, q, seed=101)
    if R == 0:
        return LCCPlan(
            K=K, p=p, q=q,
            plan_omega=plan_omega,
            plan_alpha=plan_draw_loose(K, p, q, seed=202),
        )
    f = Field(q)
    return LCCPlan(
        K=K, p=p, q=q,
        plan_omega=plan_omega,
        plan_alpha=None,
        R=R,
        alphas=distinct_points(f, K + R, seed=202),
    )


def lcc_generator(plan: LCCPlan) -> np.ndarray:
    """The (N, N) all-to-all-encode generator of the LCC code: row k < K is
    the Lagrange row Φ_k evaluated at every α_j (a column-scaled Vandermonde
    in the ω basis), rows K..N−1 are zero (they multiply the padding).
    ``x_padded @ A`` = the N coded shards."""
    f = Field(plan.q)
    N = plan.N
    A = np.zeros((N, N), dtype=np.uint64)
    A[: plan.K, :] = lagrange_matrix(
        f, np.asarray(plan.alpha_points), np.asarray(plan.omega_points)
    )
    return A


def lcc_pad(plan: LCCPlan, X) -> torch.Tensor:
    """Zero-pad (K, *payload) field elements to the (N, *payload) processor
    count the padded generator expects (a no-op at R = 0)."""
    X = as_residues(X)
    if X.shape[0] != plan.K:
        raise ValueError(f"X must have K={plan.K} rows, got {X.shape[0]}")
    if plan.R == 0:
        return X
    return torch.cat([X, X.new_zeros((plan.R,) + tuple(X.shape[1:]))], dim=0)


def lcc_encode(plan: LCCPlan, X) -> torch.Tensor:
    """X: (K, *block) field elements with X[i] held by worker i as u(ω_i).
    Returns the N = K + R coded blocks u(α_j), one per worker.

    N = K: one all-to-all encode of the Lagrange matrix via the Theorem 4
    draw-and-loose composite. N > K: one universal prepare-and-shoot encode
    of the padded Lagrange generator over N processors. Either runs over
    column blocks of the payload (``rs_checkpoint.encode_columns``), each
    block's last step writing into its columns of the output."""
    X = as_residues(X)
    if plan.R == 0:
        return encode_columns(lambda x, out: encode_lagrange(x, plan.plan_omega, plan.plan_alpha, out=out), X)
    A = plan_constants(plan, "generator", lambda: lcc_generator(plan))  # a guard encodes block by block
    return encode_columns(lambda x, out: encode_universal(lcc_pad(plan, x), A, p=plan.p, q=plan.q, out=out), X,
                          plan.N)


def lcc_encode_collective(plan: LCCPlan, *, device=None, kernels: str | None = None):
    """The IR path: a (N, *payload) → (N, *payload) callable encoding with
    the padded Lagrange generator as the compiled prepare-and-shoot round
    schedule (``dist.collectives.ps_encode``) on one device (``None``: the
    card), the N hosts being the tensor's first axis. Input rows K..N−1 must
    be the zero padding (:func:`lcc_pad`). The multi-rank form, one host a
    rank, is :func:`lcc_encode_ranks`. The callable runs the schedule over
    column blocks (``rs_checkpoint.BlockedEncode``)."""
    fn, _ = ps_encode(lcc_generator(plan), p=plan.p, q=plan.q, device=device, kernels=kernels)
    return BlockedEncode(fn)


def lcc_encode_ranks(mesh, axis: str, plan: LCCPlan, *, kernels: str | None = None):
    """The mesh path, one host a rank (``repro_torch.dist.ranks``): a callable
    mapping this rank's ``(1, *payload)`` block to its coded block, the
    reference's ``lcc_encode_collective(mesh, axis, plan)``. ``axis`` must
    hold N = K + R ranks; ranks K..N−1 hold the zero padding."""
    N = mesh.axis_size(axis)
    if N != plan.N:
        raise ValueError(f"mesh axis {axis!r} has {N} ranks, need N={plan.N}")
    fn, _ = ps_encode_ranks(mesh, axis, lcc_generator(plan), p=plan.p, q=plan.q, kernels=kernels)
    return fn


def _validate_responders(plan: LCCPlan, responders) -> list[int]:
    responders = [int(r) for r in responders]
    if len(set(responders)) != len(responders):
        raise ValueError(f"duplicate responders: {sorted(responders)}")
    bad = [r for r in responders if not 0 <= r < plan.N]
    if bad:
        raise ValueError(f"responders {bad} outside [0, {plan.N})")
    if len(responders) < plan.K:
        raise ValueError(
            f"need ≥{plan.K} responders to interpolate a degree-"
            f"{plan.K - 1} polynomial, have {len(responders)}"
        )
    return sorted(responders)[: plan.K]


def lcc_decode(plan: LCCPlan, values: np.ndarray, responders) -> np.ndarray:
    """Reconstruct all K data blocks from any K-of-N coded shards, on the
    host.

    ``values[i]`` (numpy) is the coded shard held by worker ``responders[i]``
    (u(α_{responders[i]})); raises ValueError on fewer than K responders,
    duplicates, or out-of-range indices — never returns garbage."""
    f = Field(plan.q)
    K = plan.K
    order = {int(r): i for i, r in enumerate(responders)}
    chosen = _validate_responders(plan, responders)
    Y = np.stack(
        [np.asarray(values[order[r]], dtype=np.uint64) % f.q for r in chosen]
    )
    # interpolate the degree-(K−1) polynomial from its values at the K
    # surviving α's, evaluate at every ω: one Lagrange matrix application
    L = lagrange_matrix(
        f, np.asarray(plan.omega_points), np.asarray(plan.alpha_points)[chosen]
    )
    flat = Y.reshape(K, -1)
    out = f.matmul(flat.T, L).T
    return out.reshape((K,) + Y.shape[1:])


def lcc_compute_and_decode(
    plan: LCCPlan, encoded: np.ndarray, W: np.ndarray, responders: list[int]
) -> np.ndarray:
    """Each responder j supplies Y_j = u(α_j) @ W (mod q); interpolate back
    to f(X_i) for all i from any K responses (linearity of f: the responses
    are evaluations of the degree-(K−1) polynomial f∘u). Host numpy."""
    f = Field(plan.q)
    responders = [int(r) for r in responders]
    Y = np.stack(
        [f.matmul(np.asarray(encoded[j], dtype=np.uint64), W) for j in responders]
    )
    return lcc_decode(plan, Y, responders)


__all__ = [
    "LCCPlan",
    "build_lcc",
    "lcc_generator",
    "lcc_pad",
    "lcc_encode",
    "lcc_encode_collective",
    "lcc_encode_ranks",
    "lcc_decode",
    "lcc_compute_and_decode",
]
