"""The exact GF(q) matrix product on the card: ctypes wrapper of
``csrc/gf_matmul.cu`` and the plain PyTorch version of the same function.

``gf_matmul_cuda`` is the only door to the kernel. It takes dense ``int32``
bit-pattern tensors on one CUDA device (``repro_torch.core.field`` explains
the representation), allocates the result, launches on PyTorch's current
stream without synchronising, raises if the launch is refused, and adds one
to ``gf_matmul_cuda.launches`` where it launches and nowhere else.
``gf_matmul_plain`` is the same function in ``int64`` tensor arithmetic, on
any device; the CPU tests use it and the on-card check holds the kernel
against it bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.field import _wide
from .._build import load_library


def _library():
    lib = load_library("gf_matmul")
    fn = lib.gf_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,  # A
            ctypes.c_void_p,  # B
            ctypes.c_void_p,  # C
            ctypes.c_int,  # batch
            ctypes.c_int,  # M
            ctypes.c_int,  # K
            ctypes.c_longlong,  # N
            ctypes.c_uint,  # q
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return fn


def _check_operands(a: torch.Tensor, b: torch.Tensor, q: int):
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"expected a (batch, M, K) and b (batch, K, N), got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"shapes do not contract: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"operands must be int32 bit patterns, got {a.dtype}, {b.dtype}")
    if not (2 < q < (1 << 31)) or q % 2 == 0:
        raise ValueError(f"q={q} must be an odd modulus in (2, 2^31)")


def gf_matmul_cuda(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """C[z] = (A[z] @ B[z]) mod q by the CUDA kernel. a: (batch, M, K),
    b: (batch, K, N), canonical residues, contiguous, on one CUDA device."""
    _check_operands(a, b, q)
    if not a.is_cuda or not b.is_cuda or a.device != b.device:
        raise ValueError(f"gf_matmul_cuda needs both operands on one CUDA device, got {a.device}, {b.device}")
    if not a.is_contiguous() or not b.is_contiguous():
        raise ValueError("gf_matmul_cuda needs contiguous operands")
    batch, M, K = a.shape
    N = b.shape[2]
    if min(batch, M, K, N) < 1:
        raise ValueError(f"gf_matmul_cuda takes no empty operand, got {tuple(a.shape)} @ {tuple(b.shape)}")
    if batch > 65535 or (M + 7) // 8 > 65535:
        raise ValueError(f"batch={batch} or M={M} exceeds the kernel's grid")
    fn = _library()
    with torch.cuda.device(a.device):
        out = torch.empty((batch, M, N), dtype=torch.int32, device=a.device)
        err = fn(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, M, K, N, q,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gf_matmul_launch failed with CUDA error {err}")
    gf_matmul_cuda.launches += 1
    return out


gf_matmul_cuda.launches = 0


def gf_matmul_plain(
    a: torch.Tensor, b: torch.Tensor, q: int, *, chunk_bytes: int = 1 << 28
) -> torch.Tensor:
    """The same function in plain PyTorch: ``int64`` products (< 2^62 for
    canonical operands) reduced with ``%`` and summed mod q, one k at a time.
    The columns are walked in chunks so that the ``int64`` temporaries stay
    near ``chunk_bytes`` whatever N is."""
    _check_operands(a, b, q)
    batch, M, K = a.shape
    N = b.shape[2]
    out = torch.zeros((batch, M, N), dtype=torch.int32, device=b.device)
    if min(batch, M, K, N) < 1:
        return out
    a64 = _wide(a.to(b.device))
    step = max(1, chunk_bytes // (8 * batch * M))
    for n0 in range(0, N, step):
        bc = _wide(b[:, :, n0 : n0 + step])
        acc = torch.zeros((batch, M, bc.shape[2]), dtype=torch.int64, device=b.device)
        for k in range(K):
            acc = (acc + a64[:, :, k, None] * bc[:, k, None, :]) % q
        out[:, :, n0 : n0 + step] = acc.to(torch.int32)
    return out
