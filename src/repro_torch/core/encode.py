"""Public all-to-all encode API with algorithm auto-selection.

``a2a_encode`` picks the cheapest applicable algorithm for the requested
generator (paper Remark 5: draw-and-loose degrades gracefully to universal
prepare-and-shoot when the field/size structure gives H = 0):

* DFT matrix, K = (p+1)^H, K | q-1      → butterfly       (C2 = log_{p+1}K)
* Vandermonde on structured points      → draw-and-loose  (C2 = H + Ψ(M))
* anything else (the universal promise) → prepare-and-shoot (C2 = O(√K/p))

Returns the encoded tensor and a ``CostReport`` with the paper-exact C1/C2
and the cost-model time C1·β + C2·τ.

``a2a_encode`` is an entry point: it runs on the card unless the caller asks
for the CPU. ``device=None`` means ``torch.device("cuda")``; an input on the
CPU (or a numpy array) is moved there; with no card the call raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import bounds
from .bounds import CostModel
from .draw_loose import encode_dft, encode_draw_loose
from .field import M31, NTT, Field, resolve_device, to_tensor
from .prepare_shoot import encode_universal
from .schedule import (
    ButterflyPlan,
    DrawLoosePlan,
    PrepareShootPlan,
    plan_butterfly,
    plan_draw_loose,
    plan_prepare_shoot,
)


@dataclass(frozen=True)
class CostReport:
    algorithm: str
    K: int
    p: int
    c1: int
    c2: int
    c1_lower: int
    c2_lower: float
    time: float

    @property
    def c1_optimal(self) -> bool:
        return self.c1 <= self.c1_lower


def _report(alg: str, K: int, p: int, c1: int, c2: int, model: CostModel) -> CostReport:
    return CostReport(
        algorithm=alg,
        K=K,
        p=p,
        c1=c1,
        c2=c2,
        c1_lower=bounds.lemma1_c1_lower(K, p),
        c2_lower=bounds.lemma2_c2_lower(K, p),
        time=model.time(c1, c2),
    )


def plan_for(
    kind: str, K: int, p: int = 1, q: int = M31, seed: int = 0
):
    """kind ∈ {'general', 'vandermonde', 'dft'} → the schedule plan.

    'dft' requires K = (p+1)^H and K | q-1 (use q=NTT for power-of-two K).
    'vandermonde' factors K = M (p+1)^H and may degrade to universal (H=0).
    """
    if kind == "general":
        return plan_prepare_shoot(K, p)
    if kind == "dft":
        return plan_butterfly(K, p, q)
    if kind == "vandermonde":
        return plan_draw_loose(K, p, q, seed=seed)
    raise ValueError(f"unknown kind {kind!r}")


def default_q_for(K: int, p: int) -> int:
    """Prefer the NTT prime when it unlocks butterfly structure for this
    (K, p); otherwise Mersenne-31 (cheapest reduction)."""
    radix = p + 1
    h_ntt = 0
    k = K
    while k % radix == 0 and (NTT - 1) % radix ** (h_ntt + 1) == 0:
        k //= radix
        h_ntt += 1
    h_m31 = 0
    k = K
    while k % radix == 0 and (M31 - 1) % radix ** (h_m31 + 1) == 0:
        k //= radix
        h_m31 += 1
    return NTT if h_ntt > h_m31 else M31


def a2a_encode(
    x: torch.Tensor | np.ndarray,
    A: torch.Tensor | np.ndarray | None = None,
    *,
    plan: PrepareShootPlan | ButterflyPlan | DrawLoosePlan | None = None,
    p: int = 1,
    q: int = M31,
    cost_model: CostModel | None = None,
    device=None,
) -> tuple[torch.Tensor, CostReport]:
    """Encode x (shape (K, *payload), canonical residues mod q as ``int32``
    bit patterns or a ``uint32`` numpy array) on ``device`` (``None``: the
    card).

    Either pass a generator matrix ``A`` (universal path), or a prebuilt
    specific ``plan`` (butterfly / draw-and-loose / prepare-and-shoot). A
    numpy ``A`` is baked in as host constants; a tensor ``A`` is gathered
    from on the device.
    """
    model = cost_model or CostModel()
    dev = resolve_device(device)
    x = to_tensor(x, dev)
    if isinstance(A, torch.Tensor):
        A = to_tensor(A, dev)
    K = x.shape[0]
    if plan is not None:
        if isinstance(plan, ButterflyPlan):
            out = encode_dft(x, plan)
            return out, _report("butterfly", K, plan.p, plan.c1, plan.c2, model)
        if isinstance(plan, DrawLoosePlan):
            out = encode_draw_loose(x, plan)
            return out, _report("draw-and-loose", K, plan.p, plan.c1, plan.c2, model)
        if isinstance(plan, PrepareShootPlan):
            if A is None:
                raise ValueError("universal plan needs the matrix A")
            out = encode_universal(x, A, p=plan.p, q=q, plan=plan)
            return out, _report("prepare-and-shoot", K, plan.p, plan.c1, plan.c2, model)
        raise TypeError(type(plan))
    if A is None:
        raise ValueError("need A or a plan")
    ps = plan_prepare_shoot(K, p)
    out = encode_universal(x, A, p=p, q=q, plan=ps)
    return out, _report("prepare-and-shoot", K, p, ps.c1, ps.c2, model)


def rs_generator(field: Field, K: int, n_total: int, seed: int = 0) -> np.ndarray:
    """K×n_total Reed-Solomon generator (Vandermonde on distinct points) for
    the coded-checkpoint application (Remark 1: N > K targets)."""
    from .matrices import distinct_points, vandermonde

    pts = distinct_points(field, n_total, seed=seed)
    return vandermonde(field, pts, nrows=K)
