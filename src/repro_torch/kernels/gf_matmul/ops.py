"""Public wrappers of the GF(q) matrix product, with the reference's names.

Dispatch is by where the operands lie and by nothing else: tensors on a CUDA
device go to the hand-written kernel (``kernel.gf_matmul_cuda``) or raise;
tensors on the CPU go to the plain PyTorch version. There is no ``try`` that
falls back. The kernel takes every width and every 4-byte offset in one
launch: a product of at most 16 rows runs the row kernel, whose ragged form
splits each row of B and C at its own 16-byte phase (``kernel.row_form``), and
a taller one the general kernel. So nothing is padded or copied here.
"""

from __future__ import annotations

import torch

from ...core.field import resolve_device, to_tensor
from .kernel import gf_matmul_cuda, gf_matmul_plain
from .ref import gf_matmul_ref


def _run(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    if a.device != b.device:
        raise ValueError(f"operands lie on different devices: {a.device}, {b.device}")
    batch, M, K = a.shape
    N = b.shape[2]
    if M == 0 or N == 0 or K == 0 or batch == 0:
        # empty operand (e.g. a slot emptied by fuse_trivial_rounds): the
        # mod-q sum over zero terms is zero — nothing to launch
        return torch.zeros((batch, M, N), dtype=torch.int32, device=a.device)
    if a.is_cuda:
        return gf_matmul_cuda(a.contiguous(), b.contiguous(), q)
    return gf_matmul_plain(a, b, q)


def gf_matmul(a: torch.Tensor, b: torch.Tensor, *, q: int) -> torch.Tensor:
    """C = (A @ B) mod q for (M, K) x (K, N) ``int32`` bit-pattern tensors
    holding canonical residues; any shape, including empty ones."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"expected 2-D operands, got {tuple(a.shape)}, {tuple(b.shape)}")
    return _run(a[None], b[None], q)[0]


def gf_matmul_batched(a: torch.Tensor, b: torch.Tensor, *, q: int) -> torch.Tensor:
    """Batched C[i] = (A[i] @ B[i]) mod q. a: (B, M, K), b: (B, K, N) — the
    batch is walked by the grid of the one kernel launch. Used for the shoot-phase
    init, where every processor contracts its prepare buffer against its own
    coefficient tile, and for the general rows of a LocalOp."""
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"expected 3-D operands, got {tuple(a.shape)}, {tuple(b.shape)}")
    return _run(a, b, q)


def gf_matmul_reference(a, b, *, q):
    """Alias of the field-tier oracle (testing convenience)."""
    return gf_matmul_ref(a, b, q)


def encode_direct(x, G, *, q: int, device=None) -> torch.Tensor:
    """Direct (non-collective) encode baseline: X @ G mod q via the kernel.

    x: (S, K) payload-major state limbs; G: (K, N) generator (tensor or numpy
    array). Runs on ``device`` (``None``: the card); this is the per-node
    compute of the coded-checkpoint path.
    """
    dev = resolve_device(device)
    return gf_matmul(to_tensor(x, dev), to_tensor(G, dev), q=q)
