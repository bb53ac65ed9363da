"""Field-tier oracle for the fused butterfly-round MAC kernel.

One draw-and-loose/DFT round at a single processor group is
    out = Σ_ρ tw[:, ρ] · parts[ρ]   (mod q)
with ``parts[ρ]``: (B, P) the value received from the digit-ρ group member
and ``tw``: (B, radix) the twiddle row (schedule constants).
"""

from __future__ import annotations

import torch

from ...core.field import madd, shoup_mul


def butterfly_mac_ref(
    parts: torch.Tensor,  # (radix, B, P) int32 bit patterns
    tw: torch.Tensor,  # (B, radix)
    tw_sh: torch.Tensor,  # (B, radix)
    q: int,
) -> torch.Tensor:
    radix = parts.shape[0]
    acc = None
    for r in range(radix):
        term = shoup_mul(parts[r], tw[:, r : r + 1], tw_sh[:, r : r + 1], q)
        acc = term if acc is None else madd(acc, term, q)
    return acc
