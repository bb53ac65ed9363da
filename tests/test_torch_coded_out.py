"""The coded encodes write each column block's last step into its columns of
the output, on the CPU, against the reference.

``rs_checkpoint.encode_columns`` hands every block of a blocked encode its
columns of the one output (rows a whole output row apart), and the
single-program encodes write their last step there: the last round of
``butterfly_mac_rows`` (the loose step of ``encode_lagrange`` /
``encode_draw_loose``), the local scale where there is no loose step, and the
last shoot round of ``encode_universal``. Held here, at tolerance 0 (exact
arithmetic mod q):

* ``butterfly_mac_rows_plain`` into a strided ``out=`` (a block of columns of
  a wider buffer at word offsets 0-3) equals its dense result, and leaves the
  rest of the buffer as it was; the launcher refuses an ``out`` it cannot
  write;
* ``encode_universal``, ``encode_draw_loose`` and ``encode_lagrange`` with
  ``out=`` a block of columns of a wider buffer equal the reference's host
  oracle over the reference's own matrices, at block widths 4, 8, S-1, S,
  S+4, K 8/16/48, p 1/2, both primes;
* on meta tensors at the real block widths (``block_columns``), a
  ``TorchDispatchMode`` sees no ``copy_`` into the output of
  ``encode_parity`` and ``lcc_encode`` (R = 0 and R > 0) whose plans have a
  shoot round; a plan with no shoot round (K = 2, p = 1) stores each block,
  one ``copy_`` of the block's shape a block, and the IR executor's blocks
  (``BlockedEncode``) are stored the same way;
* a block's stored result is freed before the next block runs (held through
  it, it raised ``encode_parity_collective``'s added device bytes by one
  block's output, 44.7 MB at K = 16 on the H100).
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.coded import lagrange_compute as rlc
from repro.coded import rs_checkpoint as rrs
from repro.core import schedule as rsch
from repro.core.field import M31, NTT, Field
from repro.core.prepare_shoot import encode_oracle
from repro_torch.coded import lagrange_compute as plc
from repro_torch.coded import rs_checkpoint as prs
from repro_torch.convert import to_numpy, to_tensor
from repro_torch.core import draw_loose as pdl
from repro_torch.core import schedule as psch
from repro_torch.core.field import shoup_precompute
from repro_torch.core.prepare_shoot import encode_universal
from repro_torch.kernels.butterfly.kernel import butterfly_mac_rows_launcher, butterfly_mac_rows_plain

S = 21
WIDTHS = ("4", "8", "S-1", "S", "S+4")
KS, PS, QS = (8, 16, 48), (1, 2), (M31, NTT)
CASES = [(K, p, q) for K in KS for p in PS for q in QS]
ID = lambda c: f"K{c[0]}-p{c[1]}-{'M31' if c[2] == M31 else 'NTT'}"  # noqa: E731
SENTINEL = -7  # never a residue: a word the call must not write


def width(name: str) -> int:
    return {"4": 4, "8": 8, "S-1": S - 1, "S": S, "S+4": S + 4}[name]


def t32(a) -> torch.Tensor:
    return to_tensor(np.asarray(a, dtype=np.uint32), "cpu")


def residues(shape, q: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, q, size=shape, dtype=np.uint64)


def block_of(rows: int, w: int, off: int = 3, pad: int = 5):
    """A (rows, w) block of columns of a wider buffer filled with
    ``SENTINEL``: (buffer, view), the view's rows ``off + w + pad`` apart,
    starting at word ``off``."""
    buf = torch.full((rows, off + w + pad), SENTINEL, dtype=torch.int32)
    return buf, buf[:, off : off + w]


def assert_only_the_view_written(buf, view):
    """Every word of ``buf`` outside ``view`` is still ``SENTINEL``."""
    mask = torch.ones_like(buf, dtype=torch.bool)
    off = view.storage_offset()
    mask[:, off : off + view.shape[1]] = False
    assert bool((buf[mask] == SENTINEL).all())


# ---------------------------------------------------------------------------
# butterfly_mac_rows into a strided output
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", QS, ids=["M31", "NTT"])
@pytest.mark.parametrize("radix,B,P", [(1, 1, 1), (2, 5, 7), (3, 9, 33), (4, 4, 4), (2, 1, 13), (8, 6, 130)])
@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_butterfly_mac_rows_plain_into_a_strided_out_equals_the_dense_result(q, radix, B, P, gathered, off):
    rng = np.random.default_rng(radix * 100 + B * 10 + P + off)
    if gathered:  # one source every part reads through a table
        sources = (t32(rng.integers(0, q, size=(B + 3, P))),)
        idx = torch.as_tensor(rng.integers(0, B + 3, size=(radix, B)).astype(np.int32))
    else:
        sources = tuple(t32(rng.integers(0, q, size=(B, P))) for _ in range(radix))
        idx = None
    tw_np = rng.integers(0, q, size=(B, radix), dtype=np.uint64).astype(np.uint32)
    tw_np[0, 0] = q - 1
    tw, tw_sh = t32(tw_np), t32(shoup_precompute(tw_np, q))
    dense = butterfly_mac_rows_plain(sources, tw, tw_sh, q, idx=idx)
    buf, view = block_of(B, P, off=off, pad=2 + off)
    got = butterfly_mac_rows_plain(sources, tw, tw_sh, q, idx=idx, out=view)
    assert got is view and torch.equal(view, dense)
    assert_only_the_view_written(buf, view)
    # the host oracle over the rows numpy gathers
    f = Field(q)
    want = np.zeros((B, P), dtype=np.uint64)
    for r in range(radix):
        x = to_numpy(sources[r if len(sources) > 1 else 0]).astype(np.uint64)
        part = x[:B] if idx is None else x[idx[r].numpy()]
        want = f.add(want, f.mul(part, tw_np[:, r : r + 1].astype(np.uint64)))
    assert np.array_equal(to_numpy(view), want.astype(np.uint32))


def test_butterfly_mac_rows_refuses_an_out_it_cannot_write():
    """A wrong shape, columns that are not contiguous, rows closer than a row
    apart or another device raise in both doors' checks, before any work."""
    x = t32(np.arange(12).reshape(3, 4))
    tw = t32(np.ones((3, 2)))
    tw_sh = t32(shoup_precompute(np.ones((3, 2), np.uint32), M31))
    bad = {
        "shape": torch.empty((3, 5), dtype=torch.int32),
        "columns": torch.empty((4, 3), dtype=torch.int32).t(),
        "rows": torch.empty(16, dtype=torch.int32).as_strided((3, 4), (2, 1)),
        "device": torch.empty((3, 4), dtype=torch.int32, device="meta"),
    }
    for what, out in bad.items():
        with pytest.raises(ValueError):
            butterfly_mac_rows_plain((x, x), tw, tw_sh, M31, out=out)
        with pytest.raises(ValueError):
            butterfly_mac_rows_launcher((x, x), tw, tw_sh, M31, out=out)


# ---------------------------------------------------------------------------
# the single-program encodes with out=
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def r_parity_plan(K, p, q):
    return rrs.build_parity_plan(K, p, q)


@functools.lru_cache(maxsize=None)
def r_draw_loose_target(K, p, q):
    return rsch.draw_loose_target_matrix(rsch.plan_draw_loose(K, p, q))


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("case", CASES, ids=ID)
def test_encode_universal_into_a_block_of_columns_equals_the_reference(case, w):
    K, p, q = case
    x = residues((K, width(w)), q, K + p + width(w))
    buf, view = block_of(K, width(w))
    got = encode_universal(t32(x), r_parity_plan(K, p, q).A, p=p, q=q, out=view)
    assert got is view
    assert np.array_equal(to_numpy(view), encode_oracle(x, r_parity_plan(K, p, q).A, q))
    assert_only_the_view_written(buf, view)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("case", CASES, ids=ID)
def test_encode_draw_loose_into_a_block_of_columns_equals_the_reference(case, w):
    """With a loose step the last butterfly round writes the view; K = 8 and
    16 at p = 2 have none (no power of 3 divides K), and the local scale
    writes it."""
    K, p, q = case
    x = residues((K, width(w)), q, 2 * K + p + width(w))
    buf, view = block_of(K, width(w))
    got = pdl.encode_draw_loose(t32(x), psch.plan_draw_loose(K, p, q), out=view)
    assert got is view
    assert np.array_equal(to_numpy(view), encode_oracle(x, r_draw_loose_target(K, p, q), q))
    assert_only_the_view_written(buf, view)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("case", CASES, ids=ID)
def test_encode_lagrange_into_a_block_of_columns_equals_the_reference(case, w):
    K, p, q = case
    x = residues((K, width(w)), q, 3 * K + p + width(w))
    plan = plc.build_lcc(K, p=p, q=q)
    buf, view = block_of(K, width(w))
    got = pdl.encode_lagrange(t32(x), plan.plan_omega, plan.plan_alpha, out=view)
    assert got is view
    assert np.array_equal(to_numpy(view), encode_oracle(x, rlc.lcc_generator(rlc.build_lcc(K, p=p, q=q)), q))
    assert_only_the_view_written(buf, view)


# ---------------------------------------------------------------------------
# no copy into the output, counted on meta tensors
# ---------------------------------------------------------------------------


class CopiesInto(TorchDispatchMode):
    """Every ``copy_`` dispatched while active: (destination's storage,
    destination's shape)."""

    def __init__(self):
        super().__init__()
        self.copies = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.copy_.default:
            self.copies.append((args[0].untyped_storage()._cdata, tuple(args[0].shape)))
        return func(*args, **(kwargs or {}))


def stores_into_the_output(encode, K: int, rows: int):
    """The shapes of the ``copy_`` calls whose destination is the output of
    ``encode`` over meta limbs of K rows and three column blocks (the last
    ragged) at the real block width for ``rows``; and the block edges."""
    w = prs.block_columns(rows)
    cols = 2 * w + 6
    x = torch.empty((K, cols), dtype=torch.int32, device="meta")
    with CopiesInto() as mode:
        out = encode(x)
    assert out.device.type == "meta" and out.shape[1] == cols
    mine = out.untyped_storage()._cdata
    return [shape for where, shape in mode.copies if where == mine], prs.column_blocks(cols, rows)


@pytest.mark.parametrize("kind", ["parity", "lcc_square", "lcc_padded"])
@pytest.mark.parametrize("K,p", [(K, p) for K in KS for p in PS])
def test_the_blocked_single_program_encodes_store_nothing_into_their_output(kind, K, p):
    if kind == "parity":
        stores, blocks = stores_into_the_output(lambda x: prs.encode_parity(x, prs.build_parity_plan(K, p)), K, K)
    else:
        plan = plc.build_lcc(K, p=p, R=0 if kind == "lcc_square" else 2)
        stores, blocks = stores_into_the_output(lambda x: plc.lcc_encode(plan, x), K, plan.N)
    assert len(blocks) == 3
    assert stores == []


def test_a_plan_with_no_shoot_round_stores_each_block_by_its_shape():
    """K = 2, p = 1: prepare-and-shoot has no shoot round, so each block's
    result is copied into its columns: one ``copy_`` a block, of the block's
    shape, and nothing else into the output."""
    K = 2
    assert not psch.plan_prepare_shoot(K, 1).shoot_shifts
    stores, blocks = stores_into_the_output(lambda x: prs.encode_parity(x, prs.build_parity_plan(K)), K, K)
    assert stores == [(K, hi - lo) for lo, hi in blocks]


def test_the_ir_executors_blocks_are_stored_into_the_output(monkeypatch):
    """``BlockedEncode`` stores each block of the IR executor's result into
    its columns (no step of the executor writes into a tensor made before
    it): one ``copy_`` a block, of the block's shape. Four columns a block,
    on the CPU."""
    K, cols = 8, 14
    monkeypatch.setattr(prs, "block_columns", lambda rows: 4)
    fn = prs.encode_parity_collective(prs.build_parity_plan(K), device="cpu")
    x = residues((K, cols), M31, 5)
    with CopiesInto() as mode:
        out = fn(t32(x))
    mine = out.untyped_storage()._cdata
    assert [shape for where, shape in mode.copies if where == mine] == [(K, 4), (K, 4), (K, 4), (K, 2)]
    assert np.array_equal(to_numpy(out), encode_oracle(x, r_parity_plan(K, 1, M31).A, M31))


def test_a_stored_block_result_is_freed_before_the_next_block_runs(monkeypatch):
    """Where an encode returns its own result (the IR executor's blocks),
    ``encode_columns`` stores it and lets it go before it runs the next
    block: at most one block's result lives at once beside the output."""
    import weakref

    monkeypatch.setattr(prs, "block_columns", lambda rows: 4)
    alive = []

    def enc(x, out):
        assert all(ref() is None for ref in alive), "a stored block's result outlived its turn"
        y = x + 1
        alive.append(weakref.ref(y))
        return y

    x = torch.arange(2 * 14, dtype=torch.int32).reshape(2, 14)
    assert torch.equal(prs.encode_columns(enc, x), x + 1) and len(alive) == 4
