"""The fused butterfly-round multiply-accumulate on the card: ctypes wrapper
of ``csrc/butterfly_mac.cu`` and the plain PyTorch version of the same
function,

    out[b, n] = Σ_ρ tw[b, ρ] · parts[ρ, b, n]   (mod q).

``butterfly_mac_cuda`` is the only door to the kernel: dense ``int32``
bit-pattern tensors on one CUDA device in, a new tensor out, launched on
PyTorch's current stream without synchronising; it raises if the launch is
refused and adds one to ``butterfly_mac_cuda.launches`` where it launches and
nowhere else. ``butterfly_mac_plain`` is the same function through
``core.field``'s Shoup multiply, on any device.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.field import _csub_wide, _narrow, _shoup_wide, _wide
from .._build import load_library


def _library():
    lib = load_library("butterfly_mac")
    fn = lib.butterfly_mac_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,  # parts
            ctypes.c_void_p,  # tw
            ctypes.c_void_p,  # tw_sh
            ctypes.c_void_p,  # out
            ctypes.c_int,  # radix
            ctypes.c_longlong,  # B
            ctypes.c_longlong,  # P
            ctypes.c_uint,  # q
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return fn


def _check_operands(parts, tw, tw_sh, q: int):
    if parts.ndim != 3:
        raise ValueError(f"expected parts (radix, B, P), got {tuple(parts.shape)}")
    radix, B, _ = parts.shape
    if tuple(tw.shape) != (B, radix) or tuple(tw_sh.shape) != (B, radix):
        raise ValueError(
            f"tw and tw_sh must be ({B}, {radix}), got {tuple(tw.shape)}, {tuple(tw_sh.shape)}"
        )
    for t in (parts, tw, tw_sh):
        if t.dtype != torch.int32:
            raise TypeError(f"operands must be int32 bit patterns, got {t.dtype}")
    if not (2 < q < (1 << 31)):
        raise ValueError(f"q={q} out of supported range (3, 2^31)")


def butterfly_mac_cuda(
    parts: torch.Tensor, tw: torch.Tensor, tw_sh: torch.Tensor, q: int
) -> torch.Tensor:
    """One fused pass by the CUDA kernel. parts: (radix, B, P); tw, tw_sh:
    (B, radix), the twiddles and their Shoup duals; all contiguous on one
    CUDA device."""
    _check_operands(parts, tw, tw_sh, q)
    for t in (parts, tw, tw_sh):
        if not t.is_cuda or t.device != parts.device:
            raise ValueError(f"butterfly_mac_cuda needs every operand on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("butterfly_mac_cuda needs contiguous operands")
    radix, B, P = parts.shape
    if min(radix, B, P) < 1:
        raise ValueError(f"butterfly_mac_cuda takes no empty operand, got {tuple(parts.shape)}")
    fn = _library()
    with torch.cuda.device(parts.device):
        out = torch.empty((B, P), dtype=torch.int32, device=parts.device)
        err = fn(
            parts.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(), out.data_ptr(),
            radix, B, P, q, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"butterfly_mac_launch failed with CUDA error {err}")
    butterfly_mac_cuda.launches += 1
    return out


butterfly_mac_cuda.launches = 0


def butterfly_mac_plain(
    parts: torch.Tensor,
    tw: torch.Tensor,
    tw_sh: torch.Tensor,
    q: int,
    *,
    chunk_bytes: int = 1 << 28,
) -> torch.Tensor:
    """The same function in plain PyTorch: ``radix`` Shoup multiplies folded
    by modular adds in ``int64``, over column chunks sized so the temporaries
    stay near ``chunk_bytes``."""
    _check_operands(parts, tw, tw_sh, q)
    radix, B, P = parts.shape
    out = torch.zeros((B, P), dtype=torch.int32, device=parts.device)
    if min(radix, B, P) < 1:
        return out
    c = _wide(tw.to(parts.device))
    c_pre = _wide(tw_sh.to(parts.device))
    step = max(1, chunk_bytes // (8 * B))
    for n0 in range(0, P, step):
        acc = None
        for r in range(radix):
            term = _shoup_wide(
                _wide(parts[r, :, n0 : n0 + step]), c[:, r : r + 1], c_pre[:, r : r + 1], q
            )
            acc = term if acc is None else _csub_wide(acc + term, q)
        out[:, n0 : n0 + step] = _narrow(acc)
    return out
