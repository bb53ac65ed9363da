"""Public wrapper of the fused butterfly-round MAC, with the reference's names.

Dispatch is by where ``parts`` lies and by nothing else: a CUDA tensor goes to
the hand-written kernel (``kernel.butterfly_mac_cuda``) or raises, a CPU
tensor goes to the plain PyTorch version. There is no ``try`` that falls back.
"""

from __future__ import annotations

import math

import torch

from .kernel import butterfly_mac_cuda, butterfly_mac_plain
from .ref import butterfly_mac_ref


def butterfly_mac(
    parts: torch.Tensor,  # (radix, B, *payload) int32 bit patterns
    tw: torch.Tensor,  # (B, radix)
    tw_sh: torch.Tensor,  # (B, radix)
    *,
    q: int,
) -> torch.Tensor:
    """out[b, ...] = Σ_ρ tw[b, ρ] · parts[ρ, b, ...] (mod q); the payload dims
    are flattened for the kernel's 2-D layout and restored."""
    radix, B = parts.shape[0], parts.shape[1]
    payload = parts.shape[2:]
    flat = parts.reshape(radix, B, math.prod(payload))
    if tw.device != parts.device or tw_sh.device != parts.device:
        raise ValueError(
            f"operands lie on different devices: {parts.device}, {tw.device}, {tw_sh.device}"
        )
    if flat.numel() == 0:
        # nothing to sum or nothing to write: no launch
        return torch.zeros((B, *payload), dtype=torch.int32, device=parts.device)
    if parts.is_cuda:
        out = butterfly_mac_cuda(flat.contiguous(), tw.contiguous(), tw_sh.contiguous(), q)
    else:
        out = butterfly_mac_plain(flat, tw, tw_sh, q)
    return out.reshape(B, *payload)


def butterfly_mac_reference(parts, tw, tw_sh, *, q):
    flat = parts.reshape(parts.shape[0], parts.shape[1], math.prod(parts.shape[2:]))
    out = butterfly_mac_ref(flat, tw, tw_sh, q)
    return out.reshape(parts.shape[1:])
