"""Array-level (torch) executors for the specific algorithms (§V, §VI):

* radix-(p+1) DFT butterfly (forward + inverse) — Theorems 2, Lemma 5
* draw-and-loose for general Vandermonde matrices — Theorem 3, Lemma 6
* Lagrange matrices via inverse-Vandermonde ∘ forward-Vandermonde — Theorem 4

All twiddles/coefficients are schedule constants with Shoup duals.
``index_select`` with the per-round digit-group permutations is the local
stand-in for one port of a communication round (see dist/collectives.py).
Tensors are ``int32`` bit patterns of canonical residues (``core.field``)
and every function runs on the device where its input lies.

One butterfly round is ``out[k] = Σ_ρ tw[k, ρ] · v[k with digit_t = ρ]``. On a
CUDA device the radix gathered parts go through the hand-written
``butterfly_mac`` kernel (``kernels/butterfly/ops.py``), one launch a round;
on the CPU the round is the reference's chain of Shoup multiplies and
``madd``.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import Field, madd, shoup_mul, shoup_precompute, to_tensor
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


def _butterfly_constants(plan: ButterflyPlan, inverse: bool, dev: torch.device):
    """Per round t: (twiddles, their Shoup duals, gather index) on ``dev``.
    ``src[rho, k]`` is k with digit_t replaced by rho. Uploaded once for each
    (plan, direction, device), see ``schedule.plan_constants``."""

    def make():
        k = np.arange(plan.K)
        consts = []
        for t in range(plan.H):
            step = plan.radix**t
            digit = (k // step) % plan.radix
            src = np.stack([k + (rho - digit) * step for rho in range(plan.radix)])
            consts.append(
                (
                    to_tensor(plan.inv_twiddles[t] if inverse else plan.twiddles[t], dev),
                    to_tensor(
                        plan.inv_twiddles_shoup[t] if inverse else plan.twiddles_shoup[t], dev
                    ),
                    torch.as_tensor(src, device=dev),
                )
            )
        return consts

    return plan_constants(plan, ("butterfly", inverse, dev), make)


def butterfly_apply(
    v: torch.Tensor, plan: ButterflyPlan, inverse: bool = False
) -> torch.Tensor:
    """v: (K, *payload) → out[k] = Σ_j v_{rev(j)} β^{jk} (forward).

    Round t: out[k] = Σ_ρ tw[k, ρ] · v[k with digit_t = ρ]  (Eq. 9/10).
    """
    radix, H, q = plan.radix, plan.H, plan.q
    npay = v.ndim - 1
    consts = _butterfly_constants(plan, inverse, v.device)
    if v.is_cuda:
        # imported here: the kernel package itself imports core.field
        from ..kernels.butterfly.ops import butterfly_mac
    for t in range(H - 1, -1, -1) if inverse else range(H):
        tw, tw_sh, src = consts[t]
        if v.is_cuda:
            # one gather for all radix parts, then one kernel launch
            parts = v.index_select(0, src.reshape(-1)).reshape(radix, *v.shape)
            v = butterfly_mac(parts, tw, tw_sh, q=q)
            continue
        acc = None
        for rho in range(radix):
            term = shoup_mul(
                v.index_select(0, src[rho]),
                _bcast(tw[:, rho], npay),
                _bcast(tw_sh[:, rho], npay),
                q,
            )
            acc = term if acc is None else madd(acc, term, q)
        v = acc
    return v


def encode_dft(x: torch.Tensor, plan: ButterflyPlan) -> torch.Tensor:
    """Computes x @ G with G = D_K[rev, :] (butterfly_target_matrix)."""
    return butterfly_apply(x, plan)


def decode_dft(y: torch.Tensor, plan: ButterflyPlan) -> torch.Tensor:
    """Inverse of encode_dft (Lemma 5), same C1 = C2 = H."""
    return butterfly_apply(y, plan, inverse=True)


def _scale(v: torch.Tensor, plan: DrawLoosePlan, inverse: bool = False) -> torch.Tensor:
    """v[i, j] · local_scale[i, j] (or its inverse): a (K,) host constant laid
    out as (M, Z), uploaded with its Shoup dual once for each (plan,
    direction, device)."""
    q = plan.q

    def make():
        scale = plan.local_scale
        if inverse:
            scale = Field(q).inv(scale.astype(np.uint64))
        scale = np.asarray(scale).astype(np.uint32).reshape(plan.M, plan.Z)
        return to_tensor(scale, v.device), to_tensor(shoup_precompute(scale, q), v.device)

    c, c_sh = plan_constants(plan, ("scale", inverse, v.device), make)
    npay = v.ndim - 2
    return shoup_mul(v, _bcast(c, npay), _bcast(c_sh, npay), q)


def encode_draw_loose(x: torch.Tensor, plan: DrawLoosePlan) -> torch.Tensor:
    """Computes x @ G with G = Vandermonde(points)[source_perm, :]
    (draw_loose_target_matrix). x: (K, *payload)."""
    K, M, Z, q = plan.K, plan.M, plan.Z, plan.q
    payload = x.shape[1:]
    v = x.reshape(M, Z, *payload)  # processor j + Z*i → [i, j]

    # ---- draw: Z parallel M×M prepare-and-shoots (batched over j) ---------
    if plan.draw_plan is not None:
        # treat (Z, *payload) as the payload of an M-processor encode
        F = encode_universal(v, plan.draw_matrix, p=plan.p, q=q, plan=plan.draw_plan)
    else:
        F = v
    # local scale α_i^{rev(j)} (no communication)
    F = _scale(F, plan)

    # ---- loose: M parallel Z-point butterflies (batched over i) -----------
    if plan.loose_plan is not None:
        Ft = torch.movedim(F, 0, 1)  # (Z, M, *payload)
        out = butterfly_apply(Ft, plan.loose_plan)
        out = torch.movedim(out, 1, 0)
    else:
        out = F
    return out.reshape(K, *payload)


def decode_draw_loose(y: torch.Tensor, plan: DrawLoosePlan) -> torch.Tensor:
    """Inverse of encode_draw_loose (Lemma 6): inverse butterfly, divide the
    local scale, then prepare-and-shoot with the INVERSE draw matrix."""
    K, M, Z, q = plan.K, plan.M, plan.Z, plan.q
    payload = y.shape[1:]
    v = y.reshape(M, Z, *payload)
    if plan.loose_plan is not None:
        vt = torch.movedim(v, 0, 1)
        vt = butterfly_apply(vt, plan.loose_plan, inverse=True)
        v = torch.movedim(vt, 1, 0)
    v = _scale(v, plan, inverse=True)
    if plan.draw_plan is not None:
        Vinv = plan_constants(
            plan, "inv_draw_matrix", lambda: Field(q).inv_matrix(plan.draw_matrix)
        )
        v = encode_universal(v, Vinv, p=plan.p, q=q, plan=plan.draw_plan)
    return v.reshape(K, *payload)


def encode_lagrange(
    x: torch.Tensor, plan_omega: DrawLoosePlan, plan_alpha: DrawLoosePlan
) -> torch.Tensor:
    """Theorem 4: processors hold point-values f(ω'_k) of an implicit degree-
    (K-1) polynomial (ω' = plan_omega.points); each obtains f(α'_k)
    (α' = plan_alpha.points). The source permutations of the two plans cancel
    (same K, p, q ⇒ same digit-reversal), so the composite computes the TRUE
    Lagrange matrix lagrange_matrix(field, plan_alpha.points, plan_omega.points).
    """
    if (plan_omega.K, plan_omega.p, plan_omega.q) != (
        plan_alpha.K,
        plan_alpha.p,
        plan_alpha.q,
    ):
        raise ValueError("plans must share (K, p, q)")
    coeffs = decode_draw_loose(x, plan_omega)
    return encode_draw_loose(coeffs, plan_alpha)


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
