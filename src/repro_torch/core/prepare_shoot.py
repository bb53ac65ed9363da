"""Array-level (torch) executor for the universal prepare-and-shoot algorithm.

Vectorized over the processor axis: ``x`` has shape ``(K, *payload)`` and the
whole K-processor algorithm runs as one program on the device where ``x``
lies. Every ``torch.roll`` along dim 0 is exactly one port of one
communication round (the IR executor in ``dist/collectives.py`` runs the same
round structure from the compiled plan) — this module is both the
single-device executor and the local-semantics oracle for the IR path.

Tensors are ``int32`` bit patterns of canonical residues (see
``core.field``).

Correctness note: the w-variable initialization applies the *first-coverage
mask* — contribution (slot u, variable l) is kept iff l·m + offset(u) < K —
which makes the algorithm exact for every (K, p) with no Eq. 3 correction
(see schedule.coeff_mask).

Two coefficient paths:

* ``A`` as a tensor (any matrix, the *universal* promise): the coefficient
  tensor is gathered from A on the device.
* ``A`` as a host numpy array: coefficients and their Shoup duals are baked
  in as constants, uploaded at the first call with this plan and matrix and
  kept on the device after it.

Where the contraction runs: on a CUDA device both paths hand
``w[k] = coefᵀ[k] @ buf[k]`` to the hand-written ``gf_matmul`` kernel
(``kernels/gf_matmul/ops.py::gf_matmul_batched``), one launch for all K
processors. On the CPU they run the reference's chains of modular products
and ``madd``: Shoup multiplies for host constants, the generic ``mmul`` for a
runtime ``A``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .field import M31, Field, madd, mmul, shoup_mul, shoup_precompute, to_tensor
from .schedule import (
    PrepareShootPlan,
    coeff_mask,
    plan_constants,
    plan_prepare_shoot,
    shoot_coeff_indices,
    shoot_coeff_tensor,
)


def _bcast(coef, ndim_payload):
    """Append payload broadcast dims to a coefficient tensor."""
    return coef.reshape(coef.shape + (1,) * ndim_payload)


def prepare_phase(x: torch.Tensor, plan: PrepareShootPlan) -> torch.Tensor:
    """x: (K, *payload) → buf: (K, m, *payload), buf[k, u] = x_{k - offsets[u]}.

    Round t concatenates [self, roll(s_1), .., roll(s_p)] — message size
    (p+1)^{t-1} per port, matching Lemma 3's C2 accounting.
    """
    K = plan.K
    buf = x[:, None]
    for shifts in plan.prepare_shifts:
        parts = [buf]
        for s in shifts:
            parts.append(torch.roll(buf, s % K, dims=0))  # receive from k - s
        buf = torch.cat(parts, dim=1)
    return buf


def _shoot_coefficients(plan: PrepareShootPlan, A, q: int, dev: torch.device):
    """(coef, coef_sh): the masked (K, m, n) coefficient tensor of
    ``shoot_init`` on ``dev``, and for a host ``A`` its Shoup duals.

    A host ``A`` is baked once: the tensors are kept with the plan
    (``schedule.plan_constants``) beside a copy of the matrix they were made
    from, and made anew only when a call brings another matrix. A tensor
    ``A`` is gathered on the device through indices uploaded once.
    """
    if isinstance(A, np.ndarray):
        slot = plan_constants(plan, ("shoot_coef", q, dev), dict)
        if "A" not in slot or slot["A"].shape != A.shape or not np.array_equal(slot["A"], A):
            coef_np = (shoot_coeff_tensor(plan, A) * coeff_mask(plan)[None, :, :]).astype(np.uint32)
            slot["A"] = A.copy()
            slot["coef"] = to_tensor(coef_np, dev), to_tensor(shoup_precompute(coef_np, q), dev)
        return slot["coef"]

    def make():
        rows, cols = shoot_coeff_indices(plan)
        return (
            torch.as_tensor(rows, device=dev),
            torch.as_tensor(cols, device=dev),
            torch.as_tensor(coeff_mask(plan), device=dev)[None, :, :],
        )

    rows, cols, mask = plan_constants(plan, ("shoot_index", dev), make)
    return torch.where(mask, to_tensor(A, dev)[rows, cols], 0), None


def shoot_init(
    buf: torch.Tensor,
    plan: PrepareShootPlan,
    A: torch.Tensor | np.ndarray,
    q: int,
) -> torch.Tensor:
    """w[k, l] = Σ_u buf[k, u] · mask[u,l] · A[(k-off_u)%K, (k+l·m)%K] (mod q).

    This modular contraction is the gf_matmul hot spot: a CUDA ``buf`` sends
    it to the kernel, a CPU ``buf`` runs the chains (see the module doc).
    """
    npay = buf.ndim - 2
    coef, coef_sh = _shoot_coefficients(plan, A, q, buf.device)

    m, n = plan.m, plan.n
    if buf.is_cuda:
        # imported here: the kernel package itself imports core.field
        from ..kernels.gf_matmul.ops import gf_matmul_batched

        K = buf.shape[0]
        flat = buf.reshape(K, m, math.prod(buf.shape[2:]))
        w = gf_matmul_batched(coef.transpose(1, 2).contiguous(), flat, q=q)
        return w.reshape(K, n, *buf.shape[2:])

    if coef_sh is not None:  # host constants + Shoup

        def prods(u, l):
            return shoup_mul(
                buf[:, u], _bcast(coef[:, u, l], npay), _bcast(coef_sh[:, u, l], npay), q
            )

    else:

        def prods(u, l):
            return mmul(buf[:, u], _bcast(coef[:, u, l], npay), q)

    cols_out = []
    for l in range(n):
        acc = prods(0, l)
        for u in range(1, m):
            acc = madd(acc, prods(u, l), q)
        cols_out.append(acc)
    return torch.stack(cols_out, dim=1)


def shoot_rounds(w: torch.Tensor, plan: PrepareShootPlan, q: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Tree-reduce toward w[:, 0] (Algorithm 1 lines 2-10).

    Round t, port ρ: the live targets l (digit_t = 0, lower digits 0) absorb
    slot l + ρ·(p+1)^{t-1} of the processor ``shift`` places back. Targets are
    the multiples of (p+1)^t and their sources lie one port offset further,
    so both are strided slices of dim 1 and no index tensor is needed. Only
    the target columns are touched; every other column would add a zero,
    which leaves a canonical residue as it is. ``w`` itself is not modified.

    With ``out`` (a ``(K, *payload)`` tensor, any strides) the last round's
    one live target, column 0, is summed straight into ``out``, which is
    returned; a plan with no shoot round copies ``w[:, 0]`` into it.
    """
    K, p = plan.K, plan.p
    radix = p + 1
    n = plan.n
    last = len(plan.shoot_shifts)
    for t, shifts in enumerate(plan.shoot_shifts, start=1):
        stride = radix ** (t - 1)
        if t == last and out is not None:  # (p+1)^t ≥ n > (p+1)^(t-1): column 0 is the only target, port 1 feeds it
            tgt = w[:, 0]
            for rho, s in enumerate(shifts, start=1):
                if rho * stride < n:
                    tgt = madd(tgt, torch.roll(w[:, rho * stride], s % K, dims=0), q, out=out)
            return out
        acc = w.clone()
        for rho, s in enumerate(shifts, start=1):
            src = w[:, rho * stride : n : stride * radix]
            if src.shape[1] == 0:
                continue
            tgt = acc[:, 0 : n : stride * radix][:, : src.shape[1]]
            tgt.copy_(madd(tgt, torch.roll(src, s % K, dims=0), q))  # from k - s
        w = acc
    if out is not None:  # no shoot round: the result is w[:, 0] as it stands
        out.copy_(w[:, 0])
        return out
    return w


def encode_universal(
    x: torch.Tensor,
    A: torch.Tensor | np.ndarray,
    *,
    p: int = 1,
    q: int = M31,
    plan: PrepareShootPlan | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """All-to-all encode of ANY K×K matrix A: out[k] = (x @ A)[k] over GF(q).

    x: (K, *payload) ``int32`` canonical residues; A: (K, K) numpy array or
    tensor. Runs on the device where ``x`` lies. With ``out`` (a ``(K,
    *payload)`` ``int32`` tensor, any strides: a block of columns of a wider
    output) the last shoot round sums into it (see :func:`shoot_rounds`)
    and it is returned.
    """
    K = x.shape[0]
    if plan is None:
        plan = plan_prepare_shoot(K, p)
    buf = prepare_phase(x, plan)
    w = shoot_init(buf, plan, A, q)
    if out is not None:
        return shoot_rounds(w, plan, q, out=out)
    w = shoot_rounds(w, plan, q)
    return w[:, 0]


def encode_oracle(x: np.ndarray, A: np.ndarray, q: int = M31) -> np.ndarray:
    """Host oracle: (x @ A) mod q, exact, supports payload dims (K, *payload)."""
    f = Field(q)
    x = f.asarray(x)
    A = f.asarray(A)
    if x.ndim == 1:
        return f.matmul(x[None, :], A)[0]
    flat = x.reshape(x.shape[0], -1)
    out = f.matmul(flat.T, A).T  # (payload, K) @ (K, K) → transpose back
    return out.reshape(x.shape)
