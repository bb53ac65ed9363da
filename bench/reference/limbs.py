"""A state's bytes as K rows of 16-bit limbs, the input a coded checkpoint
encodes.

The leaves are read in the order of JAX's pytrees (a ``dict`` by sorted
key, a ``list`` or ``tuple`` in order, ``None`` holding no leaf). Each leaf's
bytes, little-endian as the device holds them (a ``bool`` as one byte 0 or
1), are read in pairs, ``lo | hi << 8``, an odd count padded with one zero
byte; the limbs of all leaves follow each other and are padded with zeros to
a multiple of K, then split into K rows of S limbs.
"""

from __future__ import annotations

import torch


def leaves(tree) -> list[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in leaves(item)]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"a state leaf must be a tensor, got {type(tree).__name__}")
    return [tree]


def leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    flat = t.detach().contiguous().reshape(-1)
    return flat.to(torch.uint8) if flat.dtype == torch.bool else flat.view(torch.uint8)


def limb_count(t: torch.Tensor) -> int:
    return -(-t.numel() * t.element_size() // 2)


def state_limbs(state, K: int) -> torch.Tensor:
    """The (K, S) ``int32`` limbs of ``state`` on its leaves' device."""
    parts = leaves(state)
    if not parts:
        raise ValueError("the state holds no leaf")
    total = sum(limb_count(t) for t in parts)
    S = -(-total // K)
    out = torch.zeros(K * S, dtype=torch.int32, device=parts[0].device)
    off = 0
    for t in parts:
        u8 = leaf_bytes(t)
        if u8.numel() % 2:
            u8 = torch.cat([u8, u8.new_zeros(1)])
        n = u8.numel() // 2
        out[off:off + n] = u8[0::2].to(torch.int32) | (u8[1::2].to(torch.int32) << 8)
        off += n
    return out.reshape(K, S)
