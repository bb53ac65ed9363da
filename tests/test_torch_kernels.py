"""Differential tests of the port's kernel modules on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds each
against its plain version there). Here the *plain PyTorch versions* and the
``ops.py`` wrappers — which a CPU tensor reaches — get the same seeded numpy
inputs as the reference's ``gf_matmul`` / ``gf_matmul_batched`` /
``butterfly_mac``, run as the reference's own tests run them on the CPU (the
Pallas kernels with ``interpret=True``), and as the host oracle
``gf_matmul_host``. Equality is exact (``np.array_equal``, tolerance 0).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.field import M31, NTT, Field, shoup_precompute
from repro.kernels.butterfly.ops import butterfly_mac as ref_butterfly_mac
from repro.kernels.gf_matmul.ops import gf_matmul as ref_gf_matmul
from repro.kernels.gf_matmul.ops import gf_matmul_batched as ref_gf_matmul_batched
from repro.kernels.gf_matmul.ref import gf_matmul_host
from repro_torch.convert import to_numpy, to_tensor
from repro_torch.dist.collectives import ir_encode
from repro_torch.core.schedule import plan_prepare_shoot
from repro_torch.kernels.butterfly.kernel import (
    MAX_SOURCES,
    butterfly_mac_plain,
    butterfly_mac_rows_cuda,
    butterfly_mac_rows_plain,
)
from repro_torch.kernels.butterfly.ops import butterfly_mac, butterfly_mac_reference, butterfly_mac_rows
from repro_torch.kernels.butterfly.ref import butterfly_mac_ref
from repro_torch.kernels.gf_matmul.kernel import (
    GENERAL,
    ROW_TILES,
    gf_matmul_cuda,
    gf_matmul_plain,
    launch_plan,
    row_form,
)
from repro_torch.kernels.gf_matmul.ops import (
    encode_direct,
    gf_matmul,
    gf_matmul_batched,
    gf_matmul_reference,
)
from repro_torch.kernels.gf_matmul.ref import gf_matmul_host as port_gf_matmul_host
from repro_torch.kernels.gf_matmul.ref import gf_matmul_ref


def rand_u32(shape, q, seed):
    return np.random.default_rng(seed).integers(0, q, size=shape, dtype=np.uint32)


def t(a):
    return to_tensor(a, "cpu")


GRID = [
    (8, 8, 128),  # single small block
    (128, 512, 128),  # exactly one default block of the reference
    (256, 1024, 256),  # multi-block in every dim
    (130, 70, 200),  # ragged
    (1, 16, 1),  # degenerate
    (13, 21, 130),
    (40, 100, 257),
]


@pytest.mark.parametrize("q", [M31, NTT])
@pytest.mark.parametrize("M,K,N", GRID)
def test_gf_matmul_vs_pallas_interpret_and_host(q, M, K, N):
    a = rand_u32((M, K), q, seed=M + K)
    b = rand_u32((K, N), q, seed=N + K)
    got = to_numpy(gf_matmul(t(a), t(b), q=q))
    want = np.asarray(ref_gf_matmul(jnp.asarray(a), jnp.asarray(b), q=q, interpret=True))
    assert got.dtype == want.dtype == np.uint32
    assert np.array_equal(got, want)
    assert np.array_equal(got.astype(np.uint64), gf_matmul_host(a, b, q))
    assert np.array_equal(port_gf_matmul_host(a, b, q), gf_matmul_host(a, b, q))


@pytest.mark.parametrize("q", [65537, 97])
@pytest.mark.parametrize("M,K,N", [(8, 8, 128), (130, 70, 200), (1, 16, 1)])
def test_gf_matmul_small_primes(q, M, K, N):
    a = rand_u32((M, K), q, seed=M + K)
    b = rand_u32((K, N), q, seed=N + K)
    got = to_numpy(gf_matmul(t(a), t(b), q=q))
    want = np.asarray(ref_gf_matmul(jnp.asarray(a), jnp.asarray(b), q=q, interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got.astype(np.uint64), gf_matmul_host(a, b, q))


@pytest.mark.parametrize("q", [M31, NTT])
def test_gf_matmul_vs_field_tier_ref(q):
    a = rand_u32((16, 24), q, seed=0)
    b = rand_u32((24, 8), q, seed=1)
    out = gf_matmul(t(a), t(b), q=q)
    assert torch.equal(out, gf_matmul_ref(t(a), t(b), q))
    assert torch.equal(out, gf_matmul_reference(t(a), t(b), q=q))
    assert np.array_equal(to_numpy(out).astype(np.uint64), gf_matmul_host(a, b, q))


@pytest.mark.parametrize("q", [M31, NTT])
def test_gf_matmul_extreme_values(q):
    """q-1 everywhere: the worst case of every accumulator."""
    a = np.full((64, 512), q - 1, dtype=np.uint32)
    b = np.full((512, 128), q - 1, dtype=np.uint32)
    got = to_numpy(gf_matmul(t(a), t(b), q=q))
    want = np.asarray(ref_gf_matmul(jnp.asarray(a), jnp.asarray(b), q=q, interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got.astype(np.uint64), gf_matmul_host(a, b, q))


@pytest.mark.parametrize("q", [M31, NTT])
def test_gf_matmul_batched_vs_pallas_interpret(q):
    a = rand_u32((6, 9, 17), q, seed=3)
    b = rand_u32((6, 17, 5), q, seed=4)
    got = to_numpy(gf_matmul_batched(t(a), t(b), q=q))
    want = np.asarray(ref_gf_matmul_batched(jnp.asarray(a), jnp.asarray(b), q=q, interpret=True))
    assert np.array_equal(got, want)
    for i in range(6):
        assert np.array_equal(got[i].astype(np.uint64), gf_matmul_host(a[i], b[i], q))


def test_gf_matmul_plain_chunking_is_invisible():
    """Tiny chunks (the full-width comparison walks the payload in chunks)."""
    q = NTT
    a = rand_u32((3, 5, 7), q, seed=5)
    b = rand_u32((3, 7, 1001), q, seed=6)
    whole = gf_matmul_plain(t(a), t(b), q)
    chunked = gf_matmul_plain(t(a), t(b), q, chunk_bytes=8 * 3 * 5 * 17)
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("M,K,N", [(0, 8, 8), (8, 0, 8), (8, 8, 0), (0, 0, 0)])
def test_gf_matmul_zero_size_guard(M, K, N):
    q = M31
    out = gf_matmul(torch.zeros((M, K), dtype=torch.int32), torch.zeros((K, N), dtype=torch.int32), q=q)
    want = np.asarray(ref_gf_matmul(jnp.zeros((M, K), jnp.uint32), jnp.zeros((K, N), jnp.uint32), q=q))
    assert tuple(out.shape) == want.shape == (M, N) and out.dtype == torch.int32
    assert np.array_equal(to_numpy(out), want)


def test_gf_matmul_batched_zero_size_guard():
    q = M31
    out = gf_matmul_batched(torch.zeros((3, 0, 7), dtype=torch.int32), torch.zeros((3, 7, 5), dtype=torch.int32), q=q)
    assert tuple(out.shape) == (3, 0, 5)
    out = gf_matmul_batched(torch.zeros((2, 4, 0), dtype=torch.int32), torch.zeros((2, 0, 5), dtype=torch.int32), q=q)
    assert tuple(out.shape) == (2, 4, 5) and not out.any()


def test_encode_direct_on_the_cpu():
    q = M31
    x = rand_u32((33, 8), q, seed=7)
    G = rand_u32((8, 12), q, seed=8)
    got = to_numpy(encode_direct(x, G, q=q, device="cpu"))
    assert np.array_equal(got.astype(np.uint64), gf_matmul_host(x, G, q))
    got2 = to_numpy(encode_direct(t(x), t(G), q=q, device="cpu"))
    assert np.array_equal(got, got2)


# --- which form of the CUDA kernel a shape goes to (host-side logic) ---

@pytest.mark.parametrize("M", range(1, 18))
def test_launch_plan_row_tile_is_the_smallest_at_least_M(M):
    """Every M up to 16 goes to the row kernel with the smallest row tile
    >= M (never a dead row beyond the next power of two); M = 17 goes to
    the general kernel, whatever the batch."""
    m_tile = launch_plan(M, 1 << 20, 0x1000, 0x2000)
    if M <= 16:
        assert m_tile in ROW_TILES and m_tile >= M and (m_tile == 1 or m_tile // 2 < M)
    else:
        assert m_tile == GENERAL


@pytest.mark.parametrize(
    "M,N,b_ptr,c_ptr,why",
    [
        (17, 1029, 0x1000, 0x2000, "M above the largest row tile, N % 4 == 1"),
        (17, 1030, 0x1000, 0x2000, "M above the largest row tile, N % 4 == 2"),
        (17, 1031, 0x1000, 0x2000, "M above the largest row tile, N % 4 == 3"),
        (17, 1024, 0x1004, 0x2000, "M above the largest row tile, B at a 4-byte offset"),
        (17, 1024, 0x1000, 0x2008, "M above the largest row tile, C at an 8-byte offset"),
        (17, 1024, 0x1000, 0x2000, "M above the largest row tile"),
    ],
)
def test_launch_plan_sends_what_the_row_kernel_refuses_to_the_general_one(M, N, b_ptr, c_ptr, why):
    """Only M > 16 is refused by the row kernel: it goes to the general
    kernel whatever N % 4 is and wherever B and C start."""
    assert launch_plan(M, N, b_ptr, c_ptr) == GENERAL, why


@pytest.mark.parametrize(
    "M,N,b_ptr,c_ptr,why",
    [
        (8, 1029, 0x1000, 0x2000, "N % 4 == 1"),
        (8, 1030, 0x1000, 0x2000, "N % 4 == 2"),
        (8, 1031, 0x1000, 0x2000, "N % 4 == 3"),
        (8, 1024, 0x1004, 0x2000, "B at a 4-byte offset"),
        (8, 1024, 0x1000, 0x2008, "C at an 8-byte offset"),
        (8, 1024, 0x1000, 0x200C, "C at a 12-byte offset"),
        (1, 1029, 0x1000, 0x2000, "M = 1, N % 4 == 1"),
        (1, 1031, 0x1008, 0x2004, "M = 1, N % 4 == 3, B and C unaligned"),
        (2, 1029, 0x1000, 0x2000, "M = 2, N % 4 == 1"),
        (2, 1031, 0x100C, 0x2000, "M = 2, N % 4 == 3, B unaligned"),
        (4, 1029, 0x1000, 0x2004, "M = 4, N % 4 == 1, C unaligned"),
        (4, 1031, 0x1000, 0x2000, "M = 4, N % 4 == 3"),
        (16, 1029, 0x1000, 0x2000, "M = 16, N % 4 == 1"),
        (16, 1031, 0x1004, 0x200C, "M = 16, N % 4 == 3, B and C unaligned"),
    ],
)
def test_launch_plan_sends_ragged_and_unaligned_shapes_to_the_row_kernel(M, N, b_ptr, c_ptr, why):
    """Every M <= 16 goes to the smallest row tile >= M in one launch,
    whatever N % 4 is and wherever B and C start: the row kernel's ragged
    form splits each row at its own 16-byte phase."""
    assert launch_plan(M, N, b_ptr, c_ptr) == next(t for t in ROW_TILES if t >= M), why
    assert row_form(N, b_ptr, c_ptr) == "ragged", why


@pytest.mark.parametrize(
    "N,b_ptr,c_ptr,form",
    [
        (1024, 0x1000, 0x2000, "aligned"),
        (4, 0, 0, "aligned"),
        (1025, 0x1000, 0x2000, "ragged"),
        (1026, 0x1000, 0x2000, "ragged"),
        (1027, 0x1000, 0x2000, "ragged"),
        (1024, 0x1004, 0x2000, "ragged"),
        (1024, 0x1008, 0x2000, "ragged"),
        (1024, 0x1000, 0x200C, "ragged"),
    ],
)
def test_row_form_is_aligned_only_where_every_row_starts_on_16_bytes(N, b_ptr, c_ptr, form):
    """The form the C launcher takes: every row of B and C starts on a
    16-byte boundary only where N % 4 == 0 and both start on one."""
    assert row_form(N, b_ptr, c_ptr) == form


@pytest.mark.parametrize("M", [1, 2, 3, 8, 9, 16])
@pytest.mark.parametrize("K", [1, 2, 3, 8])
def test_gf_matmul_row_kernel_shapes_vs_host(M, K):
    """Shapes the row kernel takes (N % 4 == 0), one and several stages of B
    deep, against the host oracle (the on-card check holds the kernel at
    these against this plain version)."""
    q = M31 if (M + K) % 2 else NTT
    a = rand_u32((3, M, K), q, seed=200 * M + K)
    b = rand_u32((3, K, 1028), q, seed=200 * M + K + 1)
    got = to_numpy(gf_matmul_batched(t(a), t(b), q=q))
    for z in range(3):
        assert np.array_equal(got[z].astype(np.uint64), gf_matmul_host(a[z], b[z], q))


def test_launch_plan_limits_and_names():
    assert ROW_TILES == (1, 2, 4, 8, 16) and GENERAL not in ROW_TILES
    assert launch_plan(16, 4, 0, 0) == 16
    assert launch_plan(8 * 65535, 4, 0, 0) == GENERAL
    with pytest.raises(ValueError, match="grid"):
        launch_plan(8 * 65535 + 1, 4, 0, 0)
    for N, b_ptr, c_ptr in ((0, 0, 0), (4, 0x1002, 0), (4, 0, 0x2001)):  # what the C launcher refuses
        with pytest.raises(ValueError, match="4-byte"):
            launch_plan(2, N, b_ptr, c_ptr)


def test_gf_matmul_batch_above_the_old_grid_cap():
    """The batch has no cap any more (the kernel's grid walks it); the ops
    path takes a batch of 65,537 entries and agrees with the host oracle."""
    q = NTT
    a = rand_u32((65537, 2, 2), q, seed=21)
    b = rand_u32((65537, 2, 4), q, seed=22)
    got = to_numpy(gf_matmul_batched(t(a), t(b), q=q)).astype(np.uint64)
    f = Field(q)
    want = f.add(f.mul(a[:, :, 0:1], b[:, 0:1, :]), f.mul(a[:, :, 1:2], b[:, 1:2, :]))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 9, 15, 16, 17])
@pytest.mark.parametrize("K", [1, 4, 5, 9, 33])
def test_gf_matmul_row_tile_edges_vs_host(M, K):
    """The shapes at every row tile's edges (the on-card check holds the
    kernel at these against this plain version)."""
    q = M31 if (M + K) % 2 else NTT
    a = rand_u32((2, M, K), q, seed=100 * M + K)
    b = rand_u32((2, K, 1030), q, seed=100 * M + K + 1)
    got = to_numpy(gf_matmul_batched(t(a), t(b), q=q))
    for z in range(2):
        assert np.array_equal(got[z].astype(np.uint64), gf_matmul_host(a[z], b[z], q))


def _at_offset(a: np.ndarray, words: int) -> torch.Tensor:
    """``a`` as a contiguous CPU tensor that starts ``words`` words into its buffer."""
    flat = torch.full((words + a.size,), -1, dtype=torch.int32)
    view = flat[words:].view(a.shape)
    view.copy_(t(a))
    return view


@pytest.mark.parametrize("q", [M31, NTT])
@pytest.mark.parametrize("words", [0, 1, 2, 3])
@pytest.mark.parametrize("N", [517, 518, 519])
@pytest.mark.parametrize("batch,M,K", [(8, 2, 4), (1, 2, 2)])
def test_gf_matmul_guard_shapes_ragged_and_offset(q, words, N, batch, M, K):
    """The coded guards' products scaled down (batch 8 x (2x4).(4xN) and
    1 x (2x2).(2xN), N % 4 = 1, 2, 3), with A and B as views at 0-3 words'
    offset: the plain version and the ops door against the reference's
    batched kernel in interpret mode and against the host oracle. On the
    card the same shapes run the row kernel's ragged form, which
    ``chip_smoke.py`` holds against this plain version."""
    seed = 1000 * batch + N + 10 * words
    a_np = rand_u32((batch, M, K), q, seed=seed)
    b_np = rand_u32((batch, K, N), q, seed=seed + 1)
    a, b = _at_offset(a_np, words), _at_offset(b_np, words)
    assert a.is_contiguous() and b.is_contiguous() and b.data_ptr() % 16 == (4 * words) % 16
    assert launch_plan(M, N, b.data_ptr(), 0) == next(r for r in ROW_TILES if r >= M)
    got = to_numpy(gf_matmul_plain(a, b, q))
    want = np.asarray(ref_gf_matmul_batched(jnp.asarray(a_np), jnp.asarray(b_np), q=q, interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(to_numpy(gf_matmul_batched(a, b, q=q)), got)
    for z in range(batch):
        assert np.array_equal(got[z].astype(np.uint64), gf_matmul_host(a_np[z], b_np[z], q))


@pytest.mark.parametrize("q", [M31, NTT])
@pytest.mark.parametrize("batch,M,K,N", [(8, 2, 4, 517), (1, 2, 2, 519), (2, 16, 9, 1030)])
def test_gf_matmul_guard_shapes_all_q_minus_1(q, batch, M, K, N):
    """Every operand q - 1, the accumulator's worst case, at ragged guard
    shapes and at the tallest row tile with more than one fold."""
    a_np = np.full((batch, M, K), q - 1, dtype=np.uint32)
    b_np = np.full((batch, K, N), q - 1, dtype=np.uint32)
    got = to_numpy(gf_matmul_plain(_at_offset(a_np, 1), _at_offset(b_np, 3), q))
    want = np.asarray(ref_gf_matmul_batched(jnp.asarray(a_np), jnp.asarray(b_np), q=q, interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got[0].astype(np.uint64), gf_matmul_host(a_np[0], b_np[0], q))


def _cpu_pair(q=M31):
    return t(rand_u32((2, 4, 4), q, 1)), t(rand_u32((2, 4, 8), q, 2))


@pytest.mark.parametrize(
    "make,error,match",
    [
        (lambda a, b: (a.to(torch.int64), b), TypeError, "int32"),
        (lambda a, b: (a, b.to(torch.uint8)), TypeError, "int32"),
        (lambda a, b: (a.transpose(1, 2), b[:, :, :4]), ValueError, "contiguous"),
        (lambda a, b: (a, b.transpose(1, 2).contiguous().transpose(1, 2)), ValueError, "contiguous"),
        (lambda a, b: (a, b.to("meta")), ValueError, "one CUDA device"),
        (lambda a, b: (a, b), ValueError, "one CUDA device"),
        (lambda a, b: (a[:, :, :3], b), ValueError, "do not contract"),
        (lambda a, b: (a[0], b[0]), ValueError, "batch, M, K"),
    ],
)
def test_gf_matmul_cuda_refuses(make, error, match):
    """The wrapper's refusals come before any launch (or library build) and
    leave the launch count alone."""
    a, b = make(*_cpu_pair())
    with pytest.raises(error, match=match):
        gf_matmul_cuda(a, b, M31)
    assert gf_matmul_cuda.launches == 0


@pytest.mark.parametrize("q", [M31, NTT])
@pytest.mark.parametrize(
    "radix,B,P",
    [(2, 8, 16), (2, 256, 512), (3, 9, 100), (4, 64, 1000), (2, 1, 1), (3, 7, 100), (2, 8, 128), (3, 9, 513), (1, 5, 33)],
)
def test_butterfly_mac_vs_pallas_interpret_and_host(q, radix, B, P):
    rng = np.random.default_rng(B + P)
    parts = rng.integers(0, q, size=(radix, B, P), dtype=np.uint32)
    tw = rng.integers(0, q, size=(B, radix), dtype=np.uint32)
    tw[0, 0] = q - 1  # a Shoup dual just below 2^32
    tw_sh = np.asarray(shoup_precompute(tw, q))
    got = to_numpy(butterfly_mac(t(parts), t(tw), t(tw_sh), q=q))
    want = np.asarray(
        ref_butterfly_mac(jnp.asarray(parts), jnp.asarray(tw), jnp.asarray(tw_sh), q=q, interpret=True)
    )
    assert got.dtype == want.dtype == np.uint32
    assert np.array_equal(got, want)
    assert np.array_equal(got, to_numpy(butterfly_mac_ref(t(parts), t(tw), t(tw_sh), q)))
    assert np.array_equal(got, to_numpy(butterfly_mac_reference(t(parts), t(tw), t(tw_sh), q=q)))
    f = Field(q)
    host = np.zeros((B, P), dtype=np.uint64)
    for r in range(radix):
        host = f.add(host, f.mul(parts[r], tw[:, r : r + 1]))
    assert np.array_equal(got.astype(np.uint64), host)
    # the plain version's column chunks are invisible
    chunked = butterfly_mac_plain(t(parts), t(tw), t(tw_sh), q, chunk_bytes=8 * B * 13)
    assert np.array_equal(got, to_numpy(chunked))


def test_butterfly_mac_payload_dims_and_empty():
    q = NTT
    rng = np.random.default_rng(0)
    parts = rng.integers(0, q, size=(2, 16, 3, 5, 7), dtype=np.uint32)
    tw = rng.integers(0, q, size=(16, 2), dtype=np.uint32)
    tw_sh = np.asarray(shoup_precompute(tw, q))
    out = butterfly_mac(t(parts), t(tw), t(tw_sh), q=q)
    assert tuple(out.shape) == (16, 3, 5, 7)
    want = np.asarray(ref_butterfly_mac(jnp.asarray(parts), jnp.asarray(tw), jnp.asarray(tw_sh), q=q))
    assert np.array_equal(to_numpy(out), want)
    empty = butterfly_mac(torch.zeros((2, 16, 0, 4), dtype=torch.int32), t(tw), t(tw_sh), q=q)
    assert tuple(empty.shape) == (16, 0, 4)


def test_cuda_only_doors_raise_on_the_cpu():
    """A CPU tensor never reaches a kernel, and asking for the kernels on the
    CPU raises instead of running something else."""
    q = M31
    a, b = t(rand_u32((2, 4, 4), q, 1)), t(rand_u32((2, 4, 8), q, 2))
    with pytest.raises(ValueError, match="CUDA"):
        gf_matmul_cuda(a, b, q)
    parts, tw = t(rand_u32((2, 4, 8), q, 3)), t(rand_u32((4, 2), q, 4))
    with pytest.raises(ValueError, match="CUDA"):
        butterfly_mac_rows_cuda(parts.unbind(0), tw, tw, q)
    assert gf_matmul_cuda.launches == 0 and butterfly_mac_rows_cuda.launches == 0
    A = rand_u32((8, 8), q, 5)
    with pytest.raises(ValueError, match="CUDA"):
        ir_encode(plan_prepare_shoot(8, 1).to_ir(A, q=q), q=q, device="cpu", kernels="cuda")
    with pytest.raises(ValueError, match="kernels must be"):
        ir_encode(plan_prepare_shoot(8, 1).to_ir(A, q=q), q=q, device="cpu", kernels="pallas")


def test_wrappers_refuse_wrong_operands():
    q = M31
    with pytest.raises(TypeError):
        gf_matmul_plain(torch.zeros((1, 2, 2), dtype=torch.int64), torch.zeros((1, 2, 2), dtype=torch.int32), q)
    with pytest.raises(ValueError):
        gf_matmul_plain(torch.zeros((1, 2, 3), dtype=torch.int32), torch.zeros((1, 2, 2), dtype=torch.int32), q)
    with pytest.raises(ValueError):
        gf_matmul(torch.zeros((2, 2, 2), dtype=torch.int32), torch.zeros((2, 2), dtype=torch.int32), q=q)
    with pytest.raises(ValueError):
        butterfly_mac_plain(
            torch.zeros((2, 4, 8), dtype=torch.int32),
            torch.zeros((4, 3), dtype=torch.int32),
            torch.zeros((4, 3), dtype=torch.int32),
            q,
        )
    with pytest.raises(ValueError, match="odd"):
        gf_matmul_plain(torch.zeros((1, 2, 2), dtype=torch.int32), torch.zeros((1, 2, 2), dtype=torch.int32), 1 << 20)


# ---------------------------------------------------------------------------
# butterfly_mac_rows: the kernel's row form, out[b] = Σ_ρ tw[b, ρ]·X_ρ[idx[ρ, b]]
# ---------------------------------------------------------------------------


def rows_case(radix, B, P, idx_mode, src_mode, q, seed):
    """Seeded numpy sources, row table and twiddles of one case, and the
    (radix, B, P) parts they gather to (numpy fancy indexing). ``src_mode``:
    ``shared`` (one source every ρ reads), ``per`` (source ρ with B + ρ + 1
    rows) or ``strided`` (source ρ a column window of a wider array, starting
    one word in, so its rows are P + 5 apart and their 16-byte phases vary).
    ``idx_mode``: ``identity`` (no table), ``gathered`` (random rows) or
    ``repeated`` (two rows only, each read many times)."""
    rng = np.random.default_rng(seed)
    n_src = 1 if src_mode == "shared" else radix
    rows = [B + (0 if idx_mode == "identity" else 3) + (r if src_mode != "shared" else 0) for r in range(n_src)]
    wide = [rng.integers(0, q, size=(n, P + 5), dtype=np.uint32) for n in rows]
    srcs_np = [w[:, 1 : 1 + P] if src_mode == "strided" else np.ascontiguousarray(w[:, :P]) for w in wide]
    srcs = [to_tensor(w, "cpu")[:, 1 : 1 + P] if src_mode == "strided" else t(x) for w, x in zip(wide, srcs_np)]
    source = (lambda r: r) if n_src > 1 else (lambda r: 0)
    if idx_mode == "identity":
        idx = None
        parts = np.stack([srcs_np[source(r)][:B] for r in range(radix)])
    else:
        if idx_mode == "gathered":
            idx = np.stack([rng.integers(0, rows[source(r)], size=B) for r in range(radix)])
        else:
            idx = np.stack([np.where(np.arange(B) % 3 == 0, rows[source(r)] - 1, 0) for r in range(radix)])
        idx = idx.astype(np.int32)
        parts = np.stack([srcs_np[source(r)][idx[r]] for r in range(radix)])
    tw = rng.integers(0, q, size=(B, radix), dtype=np.uint32)
    tw[0, 0] = q - 1  # a Shoup dual just below 2^32
    tw_sh = np.asarray(shoup_precompute(tw, q))
    return srcs, idx, parts, tw, tw_sh


ROWS_CASES = [
    # radix 1 to 8 and the cap, every P % 4, every row table, every kind of source
    (1, 5, 33, "identity", "per"),
    (2, 8, 64, "gathered", "shared"),
    (2, 7, 65, "repeated", "shared"),
    (2, 9, 66, "gathered", "strided"),
    (3, 9, 67, "identity", "strided"),
    (3, 6, 100, "gathered", "per"),
    (4, 16, 129, "repeated", "per"),
    (4, 3, 130, "gathered", "strided"),
    (5, 11, 131, "gathered", "per"),
    (6, 4, 132, "identity", "per"),
    (7, 5, 61, "repeated", "strided"),
    (8, 8, 62, "gathered", "per"),
    (8, 1, 63, "gathered", "shared"),
    (2, 1, 1, "identity", "per"),
    (2, 2, 3, "gathered", "strided"),
    (MAX_SOURCES, 3, 37, "gathered", "per"),
    (MAX_SOURCES, 2, 20, "identity", "shared"),
]


@pytest.mark.parametrize("q", [M31, NTT])
@pytest.mark.parametrize("radix,B,P,idx_mode,src_mode", ROWS_CASES)
def test_butterfly_mac_rows_vs_pallas_interpret_and_host(q, radix, B, P, idx_mode, src_mode):
    srcs, idx, parts, tw, tw_sh = rows_case(radix, B, P, idx_mode, src_mode, q, seed=radix * 100 + B + P)
    idx_t = None if idx is None else torch.as_tensor(idx)
    got = to_numpy(butterfly_mac_rows(srcs, t(tw), t(tw_sh), q=q, idx=idx_t))
    want = np.asarray(
        ref_butterfly_mac(jnp.asarray(parts), jnp.asarray(tw), jnp.asarray(tw_sh), q=q, interpret=True)
    )
    assert got.dtype == want.dtype == np.uint32 and got.shape == (B, P)
    assert np.array_equal(got, want)
    f = Field(q)
    host = np.zeros((B, P), dtype=np.uint64)
    for r in range(radix):
        host = f.add(host, f.mul(parts[r], tw[:, r : r + 1]))
    assert np.array_equal(got.astype(np.uint64), host)
    # the dense form over the gathered parts, and the plain version's column chunks
    assert np.array_equal(got, to_numpy(butterfly_mac_plain(t(parts), t(tw), t(tw_sh), q)))
    chunked = butterfly_mac_rows_plain(srcs, t(tw), t(tw_sh), q, idx=idx_t, chunk_bytes=8 * B * 7)
    assert np.array_equal(got, to_numpy(chunked))


META_TW = torch.zeros((4, 2), dtype=torch.int32, device="meta")


def _refused(**change):
    """A call of the row form with one operand changed."""
    q = M31
    x = t(rand_u32((6, 16), q, 1))
    args = {"sources": (x, x), "tw": t(rand_u32((4, 2), q, 2)), "tw_sh": t(rand_u32((4, 2), q, 3)),
            "idx": torch.tensor([[0, 1, 2, 5], [5, 4, 3, 0]], dtype=torch.int32)}
    args.update(change)
    return args


@pytest.mark.parametrize(
    "change,error,match",
    [
        ({"sources": (t(rand_u32((6, 16), M31, 1)),) * (MAX_SOURCES + 1),
          "tw": t(rand_u32((4, MAX_SOURCES + 1), M31, 2)), "tw_sh": t(rand_u32((4, MAX_SOURCES + 1), M31, 3)),
          "idx": torch.zeros((MAX_SOURCES + 1, 4), dtype=torch.int32)}, ValueError, "cap"),
        ({"sources": (t(rand_u32((6, 16), M31, 1)), t(rand_u32((6, 15), M31, 1)))}, ValueError, "every source"),
        ({"sources": (t(rand_u32((6, 16), M31, 1)),) * 3}, ValueError, "sources"),
        ({"sources": (torch.zeros((6, 16), dtype=torch.int64),) * 2}, TypeError, "int32"),
        ({"tw": torch.zeros((4, 2), dtype=torch.int64)}, TypeError, "int32"),
        ({"idx": torch.zeros((2, 4), dtype=torch.int64)}, TypeError, "int32"),
        ({"idx": torch.tensor([[0, 1, 2, 6], [0, 0, 0, 0]], dtype=torch.int32)}, ValueError, "outside"),
        ({"idx": torch.tensor([[0, 1, 2, 3], [0, -1, 0, 0]], dtype=torch.int32)}, ValueError, "outside"),
        ({"idx": torch.zeros((2, 3), dtype=torch.int32)}, ValueError, "idx must be"),
        ({"idx": None, "sources": (t(rand_u32((3, 16), M31, 1)),) * 2}, ValueError, "needs B"),
        ({"sources": (t(rand_u32((16, 6), M31, 1)).T,) * 2}, ValueError, "contiguous"),
        ({"tw_sh": t(rand_u32((4, 3), M31, 3))}, ValueError, "one \\(B, radix\\) shape"),
        # operands on two devices (the meta device stands in for the card): refused, never moved
        ({"tw": META_TW, "tw_sh": META_TW}, ValueError, "one device"),
        ({"sources": (t(rand_u32((6, 16), M31, 1)), torch.zeros((6, 16), dtype=torch.int32, device="meta"))},
         ValueError, "one device"),
        ({"idx": torch.zeros((2, 4), dtype=torch.int32, device="meta")}, ValueError, "one device"),
    ],
)
def test_butterfly_mac_rows_refuses(change, error, match):
    """The plain version, the dispatching wrapper and the kernel's door all
    refuse the same operands, and nothing launches. A row index outside its
    source is the exception at the door: finding it would read the device
    table back, so the kernel checks it and traps, and the door refuses
    these CPU operands for their device instead."""
    args = _refused(**change)
    doors = (butterfly_mac_rows_plain,) if match == "outside" else (butterfly_mac_rows_plain, butterfly_mac_rows_cuda)
    if match == "outside":
        with pytest.raises(ValueError, match="CUDA"):
            butterfly_mac_rows_cuda(args["sources"], args["tw"], args["tw_sh"], M31, idx=args["idx"])
    for fn in doors:
        with pytest.raises(error, match=match):
            fn(args["sources"], args["tw"], args["tw_sh"], M31, idx=args["idx"])
    with pytest.raises(error, match=match):
        butterfly_mac_rows(args["sources"], args["tw"], args["tw_sh"], q=M31, idx=args["idx"])
    assert butterfly_mac_rows_cuda.launches == 0


def test_butterfly_mac_rows_door_needs_the_card_and_a_form_that_takes_the_radix():
    """The kernel has one form, and it takes every radix up to the cap: at 9
    and at the cap the door gets as far as the device, and refuses these CPU
    operands for it."""
    args = _refused()
    with pytest.raises(ValueError, match="CUDA"):
        butterfly_mac_rows_cuda(args["sources"], args["tw"], args["tw_sh"], M31, idx=args["idx"])
    for radix in (9, MAX_SOURCES):
        srcs = (t(rand_u32((3, 8), M31, 5)),) * (radix - 1) + (t(rand_u32((3, 8), M31, 6)),)
        tw = t(rand_u32((3, radix), M31, 7))
        with pytest.raises(ValueError, match="CUDA"):
            butterfly_mac_rows_cuda(srcs, tw, tw, M31)
    assert butterfly_mac_rows_cuda.launches == 0
