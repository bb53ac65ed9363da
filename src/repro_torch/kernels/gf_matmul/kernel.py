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


#: the row kernel's row tiles (MT): the smallest one >= M is launched
ROW_TILES = (1, 2, 4, 8, 16)
#: what ``launch_plan`` returns, and the C function takes, for the general kernel
GENERAL = 0
#: rows of C a block of the general kernel owns; its grid's y axis is M / 8
GENERAL_TILE_M = 8
GRID_Y_MAX = 65535


def launch_plan(M: int, N: int, b_ptr: int, c_ptr: int) -> int:
    """The row tile of the launch for a (batch, M, K) x (batch, K, N)
    product whose B and C start at the addresses ``b_ptr`` and ``c_ptr``:
    the smallest of ``ROW_TILES`` >= M for every M <= 16, whatever N % 4 is
    and wherever B and C start (``row_form`` names the form the kernel then
    takes), else ``GENERAL``, the general kernel, which takes any shape its
    grid holds. Neither K nor the batch sets a limit: the row kernel walks
    the batch on a persistent grid and the general one in strides of its
    grid's z axis. Raises where N < 1 or an address is not 4-byte aligned,
    which the C launcher refuses."""
    if N < 1 or b_ptr % 4 or c_ptr % 4:
        raise ValueError(f"gf_matmul takes N >= 1 and 4-byte-aligned B and C, got N={N}, {b_ptr:#x}, {c_ptr:#x}")
    if M <= ROW_TILES[-1]:
        return next(t for t in ROW_TILES if t >= M)
    if (M + GENERAL_TILE_M - 1) // GENERAL_TILE_M > GRID_Y_MAX:
        raise ValueError(f"M={M} exceeds the general kernel's grid ({GRID_Y_MAX} x {GENERAL_TILE_M} rows)")
    return GENERAL


def row_form(N: int, b_ptr: int, c_ptr: int) -> str:
    """Which form a launch takes, as the C launcher decides it: "aligned"
    where every row of B and C starts on a 16-byte boundary (N % 4 == 0, B
    and C 16-byte aligned), else "ragged", where each row is split at its
    own 16-byte phase. Both the row kernel and the general one have the two
    forms."""
    return "aligned" if N % 4 == 0 and b_ptr % 16 == 0 and c_ptr % 16 == 0 else "ragged"


def _library():
    lib = load_library("gf_matmul")
    fn = lib.gf_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,  # A
            ctypes.c_void_p,  # B
            ctypes.c_void_p,  # C
            ctypes.c_longlong,  # batch
            ctypes.c_int,  # M
            ctypes.c_int,  # K
            ctypes.c_longlong,  # N
            ctypes.c_uint,  # q
            ctypes.c_int,  # m_tile (GENERAL: the general kernel)
            ctypes.c_int,  # device
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


def gf_matmul_launcher(a: torch.Tensor, b: torch.Tensor, q: int, *, out: torch.Tensor | None = None):
    """``(launch, out)``: every check, the output ``out`` and the launch plan
    made once; each ``launch()`` enqueues one product into ``out`` on
    PyTorch's current stream and counts it. ``gf_matmul_cuda`` is one launch
    of a fresh launcher; a timing loop calls ``launch`` alone, so that its
    events see the device and not the checks. a: (batch, M, K), b: (batch,
    K, N), canonical residues, contiguous, on one CUDA device. ``out``, where
    given, is a contiguous (batch, M, N) ``int32`` tensor on their device, at
    any 4-byte offset (a view into a larger buffer); else it is allocated.
    ``launch_plan`` chooses the kernel and its row tile by shape."""
    _check_operands(a, b, q)
    if not a.is_contiguous() or not b.is_contiguous():
        raise ValueError("gf_matmul_cuda needs contiguous operands")
    if not a.is_cuda or not b.is_cuda or a.device != b.device:
        raise ValueError(f"gf_matmul_cuda needs both operands on one CUDA device, got {a.device}, {b.device}")
    batch, M, K = a.shape
    N = b.shape[2]
    if min(batch, M, K, N) < 1:
        raise ValueError(f"gf_matmul_cuda takes no empty operand, got {tuple(a.shape)} @ {tuple(b.shape)}")
    dev, index = a.device, a.get_device()
    if out is None:
        out = torch.empty((batch, M, N), dtype=torch.int32, device=dev)
    elif (tuple(out.shape) != (batch, M, N) or out.dtype != torch.int32 or out.device != dev
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({batch}, {M}, {N}) int32 tensor on {dev}, "
                         f"got {tuple(out.shape)} {out.dtype} on {out.device}")
    fn = _library()
    m_tile = launch_plan(M, N, b.data_ptr(), out.data_ptr())
    form = row_form(N, b.data_ptr(), out.data_ptr())
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, M, K, N, q, m_tile, index)

    def launch():
        stream = torch.cuda.current_stream(dev).cuda_stream
        if torch.cuda.current_device() == index:
            err = fn(*args, stream)
        else:  # the C launcher works on the current device
            with torch.cuda.device(index):
                err = fn(*args, stream)
        if err != 0:
            kernel = "the general kernel" if m_tile == GENERAL else f"row tile {m_tile}"
            raise RuntimeError(f"gf_matmul_launch ({kernel}, {form}) failed with CUDA error {err}")
        gf_matmul_cuda.launches += 1

    launch.operands = (a, b, out)  # the C arguments are their addresses: keep them alive
    return launch, out


def gf_matmul_cuda(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """C[z] = (A[z] @ B[z]) mod q by the CUDA kernel (see ``gf_matmul_launcher``)."""
    launch, out = gf_matmul_launcher(a, b, q)
    launch()
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
