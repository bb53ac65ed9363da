"""Array-level (torch) executors for the specific algorithms (§V, §VI):

* radix-(p+1) DFT butterfly (forward + inverse) — Theorems 2, Lemma 5
* draw-and-loose for general Vandermonde matrices — Theorem 3, Lemma 6
* Lagrange matrices via inverse-Vandermonde ∘ forward-Vandermonde — Theorem 4

All twiddles/coefficients are schedule constants with Shoup duals.
Tensors are ``int32`` bit patterns of canonical residues (``core.field``)
and every function runs on the device where its input lies.

One butterfly round is ``out[k] = Σ_ρ tw[k, ρ] · v[k with digit_t = ρ]``: the
row gather with the per-round digit-group permutation is the local stand-in
for one port of a communication round (see dist/collectives.py). It is one
call of ``butterfly_mac_rows`` (``kernels/butterfly/ops.py``), which reads the
rows of ``v`` through the round's ``(radix, K)`` index table: one launch of
the hand-written kernel a round on a CUDA device, its plain PyTorch version on
the CPU, over the same tables. The loose step of draw-and-loose runs M such
butterflies at once over the ``(M·Z, payload)`` rows in their own order, with
tables expanded over the M groups, so nothing is transposed or gathered first.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .field import Field, shoup_mul, shoup_precompute, to_tensor
from .prepare_shoot import encode_universal
from .schedule import (
    ButterflyPlan,
    DrawLoosePlan,
    butterfly_group_perms,
    plan_butterfly,
    plan_constants,
    plan_draw_loose,
)


def _bcast(coef, npay):
    return coef.reshape(coef.shape + (1,) * npay)


def _butterfly_constants(plan: ButterflyPlan, inverse: bool, dev: torch.device, groups: int = 1):
    """Per round t: (twiddles, their Shoup duals, row table) on ``dev``, for
    ``groups`` independent butterflies whose rows lie group-major (row
    ``g·K + k``): ``idx[ρ, g·K + k] = g·K + (k with digit_t replaced by ρ)``
    and every group takes the plan's twiddle rows. Uploaded once for each
    (plan, direction, device, groups), see ``schedule.plan_constants``."""

    def make():
        K = plan.K
        k = np.arange(K)
        base = (np.arange(groups) * K).repeat(K)  # g·K for row g·K + k
        consts = []
        for t in range(plan.H):
            step = plan.radix**t
            digit = (k // step) % plan.radix
            src = np.stack([k + (rho - digit) * step for rho in range(plan.radix)])
            tw = plan.inv_twiddles[t] if inverse else plan.twiddles[t]
            tw_sh = plan.inv_twiddles_shoup[t] if inverse else plan.twiddles_shoup[t]
            consts.append(
                (
                    to_tensor(np.tile(tw, (groups, 1)), dev),
                    to_tensor(np.tile(tw_sh, (groups, 1)), dev),
                    torch.as_tensor((np.tile(src, groups) + base).astype(np.int32), device=dev),
                )
            )
        return consts

    return plan_constants(plan, ("butterfly", inverse, dev, groups), make)


def _butterfly_rows(rows: torch.Tensor, plan: ButterflyPlan, inverse: bool, groups: int = 1,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """``groups`` butterflies over the ``(groups·K, P)`` rows, group-major:
    one ``butterfly_mac_rows`` a round, reading the last round's rows through
    the round's table. The last round writes into ``out`` (a ``(groups·K,
    P)`` tensor, columns contiguous, rows any stride apart), or a new tensor
    when ``None``; returns it."""
    # imported here: the kernel package itself imports core.field
    from ..kernels.butterfly.ops import butterfly_mac_rows

    if rows.numel() == 0:
        return rows.clone() if out is None else out
    consts = _butterfly_constants(plan, inverse, rows.device, groups)
    order = list(range(plan.H - 1, -1, -1) if inverse else range(plan.H))
    for t in order:
        tw, tw_sh, idx = consts[t]
        rows = butterfly_mac_rows((rows,), tw, tw_sh, q=plan.q, idx=idx, out=out if t == order[-1] else None)
    return rows


def butterfly_apply(
    v: torch.Tensor, plan: ButterflyPlan, inverse: bool = False
) -> torch.Tensor:
    """v: (K, *payload) → out[k] = Σ_j v_{rev(j)} β^{jk} (forward).

    Round t: out[k] = Σ_ρ tw[k, ρ] · v[k with digit_t = ρ]  (Eq. 9/10).
    """
    out = _butterfly_rows(v.reshape(plan.K, math.prod(v.shape[1:])), plan, inverse)
    return out.reshape(v.shape)


def encode_dft(x: torch.Tensor, plan: ButterflyPlan) -> torch.Tensor:
    """Computes x @ G with G = D_K[rev, :] (butterfly_target_matrix)."""
    return butterfly_apply(x, plan)


def decode_dft(y: torch.Tensor, plan: ButterflyPlan) -> torch.Tensor:
    """Inverse of encode_dft (Lemma 5), same C1 = C2 = H."""
    return butterfly_apply(y, plan, inverse=True)


def _scale(v: torch.Tensor, plan: DrawLoosePlan, inverse: bool = False, out=None) -> torch.Tensor:
    """v[i, j] · local_scale[i, j] (or its inverse): a (K,) host constant laid
    out as (M, Z), uploaded with its Shoup dual once for each (plan,
    direction, device). Written into ``out`` (``v``'s shape) when given."""
    q = plan.q

    def make():
        scale = plan.local_scale
        if inverse:
            scale = Field(q).inv(scale.astype(np.uint64))
        scale = np.asarray(scale).astype(np.uint32).reshape(plan.M, plan.Z)
        return to_tensor(scale, v.device), to_tensor(shoup_precompute(scale, q), v.device)

    c, c_sh = plan_constants(plan, ("scale", inverse, v.device), make)
    npay = v.ndim - 2
    return shoup_mul(v, _bcast(c, npay), _bcast(c_sh, npay), q, out=out)


def encode_draw_loose(x: torch.Tensor, plan: DrawLoosePlan, out: torch.Tensor | None = None) -> torch.Tensor:
    """Computes x @ G with G = Vandermonde(points)[source_perm, :]
    (draw_loose_target_matrix). x: (K, *payload). The last step (the loose
    step's last round, or the local scale where there is no loose step)
    writes into ``out`` when given: a ``(K, *payload)`` tensor whose payload
    lies contiguous within a row and whose rows may be any stride apart (a
    block of columns of a wider output). Returns the result (``out`` when
    given)."""
    K, M, Z, q = plan.K, plan.M, plan.Z, plan.q
    payload = x.shape[1:]
    P = math.prod(payload)
    v = x.reshape(M, Z, *payload)  # processor j + Z*i → [i, j]

    # ---- draw: Z parallel M×M prepare-and-shoots (batched over j) ---------
    if plan.draw_plan is not None:
        # treat (Z, *payload) as the payload of an M-processor encode
        F = encode_universal(v, plan.draw_matrix, p=plan.p, q=q, plan=plan.draw_plan)
    else:
        F = v
    # local scale α_i^{rev(j)} (no communication)
    if plan.loose_plan is None:
        F = _scale(F, plan, out=None if out is None else out.view(M, Z, *payload))
        return F.reshape(K, *payload) if out is None else out
    F = _scale(F, plan)

    # ---- loose: M parallel Z-point butterflies (batched over i) -----------
    # the rows j + Z*i of F, in their own order
    F = _butterfly_rows(F.reshape(K, P), plan.loose_plan, False, groups=M,
                        out=None if out is None else out.view(K, P))
    return F.reshape(K, *payload) if out is None else out


def decode_draw_loose(y: torch.Tensor, plan: DrawLoosePlan) -> torch.Tensor:
    """Inverse of encode_draw_loose (Lemma 6): inverse butterfly, divide the
    local scale, then prepare-and-shoot with the INVERSE draw matrix."""
    K, M, Z, q = plan.K, plan.M, plan.Z, plan.q
    payload = y.shape[1:]
    v = y.reshape(M, Z, *payload)
    if plan.loose_plan is not None:
        rows = v.reshape(K, math.prod(payload))
        v = _butterfly_rows(rows, plan.loose_plan, True, groups=M).reshape(M, Z, *payload)
    v = _scale(v, plan, inverse=True)
    if plan.draw_plan is not None:
        Vinv = plan_constants(
            plan, "inv_draw_matrix", lambda: Field(q).inv_matrix(plan.draw_matrix)
        )
        v = encode_universal(v, Vinv, p=plan.p, q=q, plan=plan.draw_plan)
    return v.reshape(K, *payload)


def encode_lagrange(
    x: torch.Tensor, plan_omega: DrawLoosePlan, plan_alpha: DrawLoosePlan, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Theorem 4: processors hold point-values f(ω'_k) of an implicit degree-
    (K-1) polynomial (ω' = plan_omega.points); each obtains f(α'_k)
    (α' = plan_alpha.points). The source permutations of the two plans cancel
    (same K, p, q ⇒ same digit-reversal), so the composite computes the TRUE
    Lagrange matrix lagrange_matrix(field, plan_alpha.points, plan_omega.points).
    The forward encode's last step writes into ``out`` when given (see
    :func:`encode_draw_loose`).
    """
    if (plan_omega.K, plan_omega.p, plan_omega.q) != (
        plan_alpha.K,
        plan_alpha.p,
        plan_alpha.q,
    ):
        raise ValueError("plans must share (K, p, q)")
    coeffs = decode_draw_loose(x, plan_omega)
    return encode_draw_loose(coeffs, plan_alpha, out=out)


__all__ = [
    "butterfly_apply",
    "encode_dft",
    "decode_dft",
    "encode_draw_loose",
    "decode_draw_loose",
    "encode_lagrange",
    "plan_butterfly",
    "plan_draw_loose",
    "butterfly_group_perms",
]
