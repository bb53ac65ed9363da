"""The butterfly-round multiply-accumulate on the card: ctypes wrapper of
``csrc/butterfly_mac.cu`` and the plain PyTorch version of the same
function, over gathered rows:

    out[b, n] = Σ_ρ tw[b, ρ] · X_ρ[idx[ρ, b], n]   (mod q).

Each ``X_ρ`` is a 2-D ``(rows_ρ, P)`` ``int32`` bit-pattern tensor whose
columns are contiguous (its rows may be any stride apart: a slice of a wider
buffer is read where it lies). ``sources`` holds one tensor a ρ, or one tensor
that every ρ reads (a DFT round over one vector). ``idx`` is an optional
``(radix, B)`` ``int32`` table of row indices; without it the row is ``b``.

``out`` is a new dense ``(B, P)`` tensor, or the caller's: any ``(B, P)``
``int32`` tensor on the operands' device whose columns are contiguous and
whose rows may be any stride apart (a block of columns of a wider output is
written where it lies, and nothing else of it is touched). It must not
overlap a source.

``butterfly_mac_rows_cuda`` is the only door to the kernel: operands on one
CUDA device in, ``out`` written, launched on PyTorch's current stream without
synchronising; it raises if the launch is refused and adds one to
``butterfly_mac_rows_cuda.launches`` where it launches and nowhere else. ``butterfly_mac_rows_plain`` is the same function through
``core.field``'s Shoup multiply on any device: torch gathers the rows, then
folds them as ``butterfly_mac_plain`` does; the CPU takes it, and the on-card
checks hold the kernel against it bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.field import _csub_wide, _narrow, _shoup_wide, _wide
from .._build import load_library

#: base pointers the kernel takes by value: the most sources, and the most
#: radix, of one launch
MAX_SOURCES = 64


def _library():
    lib = load_library("butterfly_mac")
    fn = lib.butterfly_mac_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),  # bases
            ctypes.POINTER(ctypes.c_longlong),  # row strides (elements)
            ctypes.POINTER(ctypes.c_longlong),  # rows
            ctypes.c_int,  # n_sources
            ctypes.c_void_p,  # idx (null: row b)
            ctypes.c_void_p,  # tw
            ctypes.c_void_p,  # tw_sh
            ctypes.c_void_p,  # out
            ctypes.c_longlong,  # out's row stride (elements)
            ctypes.c_int,  # radix
            ctypes.c_longlong,  # B
            ctypes.c_longlong,  # P
            ctypes.c_uint,  # q
            ctypes.c_int,  # device
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return fn


def _check_rows(sources, tw, tw_sh, idx, q: int, out=None) -> tuple[int, int, int]:
    """(radix, B, P) of a call, after every check that needs no value of a
    device tensor. Every operand lies on one device: neither door moves one."""
    sources = tuple(sources)
    operands = (*sources, tw, tw_sh) + (() if idx is None else (idx,)) + (() if out is None else (out,))
    if len({t.device for t in operands}) > 1:
        raise ValueError(f"butterfly_mac_rows needs every operand on one device, got "
                         f"{sorted({str(t.device) for t in operands})}")
    if tw.ndim != 2 or tw_sh.shape != tw.shape:
        raise ValueError(f"tw and tw_sh must be one (B, radix) shape, got {tuple(tw.shape)}, {tuple(tw_sh.shape)}")
    B, radix = tw.shape
    if not 1 <= radix <= MAX_SOURCES:
        raise ValueError(f"radix {radix} is outside [1, {MAX_SOURCES}] (the kernel's base-pointer cap)")
    if len(sources) not in (1, radix):
        raise ValueError(f"expected 1 or {radix} sources, got {len(sources)}")
    for t in operands:
        if t.dtype != torch.int32:
            raise TypeError(f"operands must be int32 (bit patterns, row indices), got {t.dtype}")
    P = sources[0].shape[-1] if sources[0].ndim == 2 else -1
    for x in sources:
        if x.ndim != 2 or x.shape[1] != P:
            raise ValueError(f"every source must be (rows, {P}), got {tuple(x.shape)}")
        if P > 1 and x.stride(1) != 1:
            raise ValueError("a source's columns must be contiguous")
    if idx is None:
        if any(x.shape[0] < B for x in sources):
            raise ValueError(f"without idx every source needs B = {B} rows")
    elif tuple(idx.shape) != (radix, B):
        raise ValueError(f"idx must be ({radix}, {B}), got {tuple(idx.shape)}")
    if not (2 < q < (1 << 31)):
        raise ValueError(f"q={q} out of supported range (3, 2^31)")
    if out is not None:
        if tuple(out.shape) != (B, max(P, 0)):
            raise ValueError(f"out must be ({B}, {P}), got {tuple(out.shape)}")
        if B > 1 and P > 0 and out.stride(0) < P or P > 1 and out.stride(1) != 1:
            raise ValueError(f"out's columns must be contiguous and its rows at least {P} apart, "
                             f"got strides {tuple(out.stride())}")
    return radix, B, P


def butterfly_mac_rows_launcher(sources, tw, tw_sh, q: int, *, idx=None, out=None):
    """``(launch, out)``: every check, the output ``out`` (a new dense (B, P)
    tensor, or the caller's ``out``, see the module's docstring) and the C
    arguments made once; each ``launch()`` enqueues one pass
    of the kernel into ``out`` on PyTorch's current stream and counts it.
    ``butterfly_mac_rows_cuda`` is one launch of a fresh launcher; a timing
    loop calls ``launch`` alone, so that its events see the device and not
    the checks. tw and tw_sh contiguous (B, radix), idx contiguous (radix, B)
    int32; every operand on one CUDA device. The kernel traps on a row index outside its source (the
    next synchronise raises)."""
    sources = tuple(sources)
    radix, B, P = _check_rows(sources, tw, tw_sh, idx, q, out)
    dev = tw.device
    index = tw.get_device()  # -1 off the card
    tables = (tw, tw_sh) if idx is None else (tw, tw_sh, idx)
    if index < 0:
        raise ValueError(f"butterfly_mac_rows_cuda needs its operands on a CUDA device, got {dev}")
    if not all(t.is_contiguous() for t in tables):
        raise ValueError("butterfly_mac_rows_cuda needs contiguous tw, tw_sh and idx")
    if B < 1 or P < 1:
        raise ValueError(f"butterfly_mac_rows_cuda takes no empty operand, got B={B}, P={P}")
    n = len(sources)
    bases = (ctypes.c_void_p * n)(*(x.data_ptr() for x in sources))
    strides = (ctypes.c_longlong * n)(*(x.stride(0) if x.shape[0] > 1 else P for x in sources))
    rows = (ctypes.c_longlong * n)(*(x.shape[0] for x in sources))
    fn = _library()
    if out is None:
        out = torch.empty((B, P), dtype=torch.int32, device=dev)
    args = (bases, strides, rows, n, None if idx is None else idx.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(),
            out.data_ptr(), out.stride(0) if B > 1 else P, radix, B, P, q, index)

    def launch():
        stream = torch.cuda.current_stream(dev).cuda_stream
        if torch.cuda.current_device() == index:
            err = fn(*args, stream)
        else:  # the C launcher works on the current device
            with torch.cuda.device(index):
                err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"butterfly_mac_rows_launch failed with CUDA error {err}")
        butterfly_mac_rows_cuda.launches += 1

    launch.operands = (sources, tables, out)  # the C arguments are their addresses: keep them alive
    return launch, out


def butterfly_mac_rows_cuda(sources, tw, tw_sh, q: int, *, idx=None, out=None) -> torch.Tensor:
    """One pass of the CUDA kernel over the rows that ``idx`` names (see the
    module's docstring and ``butterfly_mac_rows_launcher``): returns ``out``,
    a new (B, P) when ``None``."""
    launch, out = butterfly_mac_rows_launcher(sources, tw, tw_sh, q, idx=idx, out=out)
    launch()
    return out


butterfly_mac_rows_cuda.launches = 0


def butterfly_mac_rows_plain(
    sources, tw, tw_sh, q: int, *, idx=None, out=None, chunk_bytes: int = 1 << 28
) -> torch.Tensor:
    """The same function in plain PyTorch: the rows gathered by torch, then
    ``radix`` Shoup multiplies folded by modular adds in ``int64``, over
    column chunks sized so the temporaries stay near ``chunk_bytes``, each
    chunk narrowed into its columns of ``out`` (a new dense (B, P) when
    ``None``). Refuses a row index outside its source (a meta tensor has no
    index to read)."""
    sources = tuple(sources)
    radix, B, P = _check_rows(sources, tw, tw_sh, idx, q, out)
    dev = tw.device
    if out is None:
        out = torch.zeros((B, max(P, 0)), dtype=torch.int32, device=dev)
    if B < 1 or P < 1:
        return out
    source = (lambda r: sources[r]) if len(sources) > 1 else (lambda r: sources[0])
    if idx is None:
        rows = torch.arange(B, device=dev).expand(radix, B)
    else:
        rows = idx.to(torch.int64)
        for r in range(radix) if dev.type != "meta" else ():  # a meta tensor has no index to read
            if int(rows[r].min()) < 0 or int(rows[r].max()) >= source(r).shape[0]:
                raise ValueError(f"idx[{r}] names a row outside its source of {source(r).shape[0]} rows")
    c = _wide(tw)
    c_pre = _wide(tw_sh)
    step = max(1, chunk_bytes // (8 * B))
    for n0 in range(0, P, step):
        acc = None
        for r in range(radix):
            x = source(r)
            part = x[:, n0 : n0 + step].index_select(0, rows[r])
            term = _shoup_wide(_wide(part), c[:, r : r + 1], c_pre[:, r : r + 1], q)
            acc = term if acc is None else _csub_wide(acc + term, q)
        _narrow(acc, out=out[:, n0 : n0 + step])
    return out


def _dense_sources(parts: torch.Tensor):
    if parts.ndim != 3:
        raise ValueError(f"expected parts (radix, B, P), got {tuple(parts.shape)}")
    return tuple(parts.unbind(0))


def butterfly_mac_plain(
    parts: torch.Tensor,
    tw: torch.Tensor,
    tw_sh: torch.Tensor,
    q: int,
    *,
    chunk_bytes: int = 1 << 28,
) -> torch.Tensor:
    """The dense case in plain PyTorch (``butterfly_mac_rows_plain`` with
    ``parts[ρ]`` as source ρ)."""
    if parts.ndim == 3 and tuple(tw.shape) != (parts.shape[1], parts.shape[0]):
        raise ValueError(f"tw and tw_sh must be {(parts.shape[1], parts.shape[0])}, got {tuple(tw.shape)}")
    return butterfly_mac_rows_plain(_dense_sources(parts), tw, tw_sh, q, chunk_bytes=chunk_bytes)
