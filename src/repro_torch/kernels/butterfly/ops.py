"""Public wrappers of the butterfly-round MAC, with the reference's names.

Dispatch is by where the operands lie and by nothing else: CUDA tensors go to
the hand-written kernel (``kernel.butterfly_mac_rows_cuda``) or raise, CPU
tensors go to the plain PyTorch version. There is no ``try`` that falls back.
"""

from __future__ import annotations

import math

import torch

from .kernel import butterfly_mac_rows_cuda, butterfly_mac_rows_plain
from .ref import butterfly_mac_ref


def butterfly_mac_rows(sources, tw: torch.Tensor, tw_sh: torch.Tensor, *, q: int, idx=None,
                       out=None) -> torch.Tensor:
    """out[b, n] = Σ_ρ tw[b, ρ] · X_ρ[idx[ρ, b], n] (mod q), into ``out`` (a
    (B, P) ``int32`` tensor, columns contiguous, rows any stride apart, not
    overlapping a source) or a new dense (B, P) tensor. ``sources``: one 2-D
    ``(rows_ρ, P)`` tensor a ρ, or one that every ρ reads, columns
    contiguous; ``idx``: ``(radix, B)`` int32 row indices, or ``None`` for row
    ``b``; tw, tw_sh: (B, radix). Every operand lies on one device, or the
    call raises: the work runs where the operands lie and is never moved. See
    ``kernel``."""
    sources = tuple(sources)
    if tw.is_cuda:
        return butterfly_mac_rows_cuda(sources, tw, tw_sh, q, idx=idx, out=out)
    return butterfly_mac_rows_plain(sources, tw, tw_sh, q, idx=idx, out=out)


def butterfly_mac(
    parts: torch.Tensor,  # (radix, B, *payload) int32 bit patterns
    tw: torch.Tensor,  # (B, radix)
    tw_sh: torch.Tensor,  # (B, radix)
    *,
    q: int,
) -> torch.Tensor:
    """out[b, ...] = Σ_ρ tw[b, ρ] · parts[ρ, b, ...] (mod q): the dense case
    of ``butterfly_mac_rows``, ``parts[ρ]`` the ρ-th source; the payload dims
    are flattened for the kernel's 2-D rows and restored."""
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
    if tuple(tw.shape) != (B, radix):
        raise ValueError(f"tw and tw_sh must be {(B, radix)}, got {tuple(tw.shape)}")
    if flat.stride(2) != 1:  # the kernel reads each row's columns where they lie, contiguous
        flat = flat.contiguous()
    out = butterfly_mac_rows(flat.unbind(0), tw.contiguous(), tw_sh.contiguous(), q=q)
    return out.reshape(B, *payload)


def butterfly_mac_reference(parts, tw, tw_sh, *, q):
    flat = parts.reshape(parts.shape[0], parts.shape[1], math.prod(parts.shape[2:]))
    out = butterfly_mac_ref(flat, tw, tw_sh, q)
    return out.reshape(parts.shape[1:])
