"""The coded encodes run in column blocks against the reference, on the CPU.

Every encode of the coded layer runs over column blocks of
``repro_torch.coded.rs_checkpoint.block_columns(rows)`` columns (a block's
working set within ``BLOCK_BYTES``): the entry points
that return a tensor (``encode_parity``, ``encode_parity_collective`` flat
and hierarchical, ``lcc_encode`` at R = 0 and R > 0,
``lcc_encode_collective``) and the snapshots of both guards, which read each
block's limbs from the state's leaves and copy it to the host. Each test
patches ``block_columns`` to 4, 8, S - 1, S and S + 4 columns (a ragged last block,
several blocks, one block, one wider than the input) and holds the result
against the reference at tolerance 0 (exact arithmetic mod q): the tensors
against the reference's host oracle (``repro.core.prepare_shoot.
encode_oracle``) over the reference's own generator, and the reference's own
encode once a kind; the guards against the reference's guards (``repro.train
.elastic.CodedStateGuard``, ``repro.serve.coded.CodedServeGuard``), run once
a configuration. K in {8, 16, 48}, p in {1, 2}, both primes.

The bound: ``encode_parity`` over meta limbs of (8, 2^27) under
``launch.op_cost.count_fn`` (:func:`test_encode_parity_peak_is_its_input_and_output_and_one_block`).
"""

import functools
import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.coded import lagrange_compute as rlc
from repro.coded import rs_checkpoint as rrs
from repro.core.field import M31, NTT
from repro.core.prepare_shoot import encode_oracle
from repro.serve.coded import CodedServeGuard as RServeGuard
from repro.train.elastic import CodedStateGuard as RStateGuard
from repro_torch.coded import lagrange_compute as plc
from repro_torch.coded import rs_checkpoint as prs
from repro_torch.convert import state_from_reference, to_numpy, to_tensor
from repro_torch.launch.op_cost import count_fn
from repro_torch.serve import CodedServeGuard
from repro_torch.train import CodedStateGuard
from test_torch_coded_guards import assert_same_state

S = 21  # payload columns of the tensor entry points
PAYLOAD = (3, 7)  # the LCC blocks' payload: S columns once flattened
WIDTHS = ("4", "8", "S-1", "S", "S+4")
KS, PS, QS = (8, 16, 48), (1, 2), (M31, NTT)
CASES = [(K, p, q) for K in KS for p in PS for q in QS]
ID = lambda c: f"K{c[0]}-p{c[1]}-{'M31' if c[2] == M31 else 'NTT'}"  # noqa: E731


def width(name: str, S: int) -> int:
    return {"4": 4, "8": 8, "S-1": S - 1, "S": S, "S+4": S + 4}[name]


@pytest.fixture
def blocks(monkeypatch):
    """``blocks(name, S)`` patches the block width (``block_columns``, at
    any row count) to ``width(name, S)`` columns and returns it."""
    def set_width(name: str, cols: int) -> int:
        w = width(name, cols)
        monkeypatch.setattr(prs, "block_columns", lambda rows: w)
        return w

    return set_width


def t32(a) -> torch.Tensor:
    return to_tensor(np.asarray(a, dtype=np.uint32), "cpu")


def limbs(K: int, seed: int, shape=(S,)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1 << 16, size=(K, *shape), dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def r_parity_plan(K, p, q):
    return rrs.build_parity_plan(K, p, q)


@functools.lru_cache(maxsize=None)
def r_lcc_plan(K, p, q, R):
    return rlc.build_lcc(K, p=p, q=q, R=R)


# ---------------------------------------------------------------------------
# the entry points that return a tensor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("case", CASES, ids=ID)
def test_encode_parity_in_blocks_equals_reference(blocks, case, w):
    K, p, q = case
    blocks(w, S)
    x = limbs(K, K + p)
    got = prs.encode_parity(t32(x), prs.build_parity_plan(K, p, q))
    assert got.device.type == "cpu" and tuple(got.shape) == (K, S)
    assert np.array_equal(to_numpy(got), encode_oracle(x, r_parity_plan(K, p, q).A, q))


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("sizes", ["flat", "hier"])
@pytest.mark.parametrize("case", CASES, ids=ID)
def test_encode_parity_collective_in_blocks_equals_reference(blocks, case, sizes, w):
    """Flat (``ps_encode``) and two-level with 4 groups (``(4, K // 4)``:
    (4, 4) at K = 16)."""
    K, p, q = case
    blocks(w, S)
    x = limbs(K, 3 * K + p)
    fn = prs.encode_parity_collective(prs.build_parity_plan(K, p, q), None if sizes == "flat" else (4, K // 4),
                                      device="cpu")
    assert fn.device.type == "cpu" and fn.kernels is not None
    got = fn(t32(x))
    assert np.array_equal(to_numpy(got), encode_oracle(x, r_parity_plan(K, p, q).A, q))
    assert fn.permutes_run == fn.permute_count  # the last block ran the whole schedule


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("R", [0, 2])
@pytest.mark.parametrize("case", CASES, ids=ID)
def test_lcc_encode_in_blocks_equals_reference(blocks, case, R, w):
    """R = 0: the draw-and-loose Lagrange encode; R > 0: the universal
    encode of the padded generator. A (K, 3, 7) payload, blocked as 21
    columns."""
    K, p, q = case
    blocks(w, S)
    X = np.random.default_rng(K + R + p).integers(0, q, size=(K, *PAYLOAD), dtype=np.uint64)
    r_plan = r_lcc_plan(K, p, q, R)
    want = encode_oracle(np.concatenate([X, np.zeros((R, *PAYLOAD), np.uint64)]), rlc.lcc_generator(r_plan), q)
    got = plc.lcc_encode(plc.build_lcc(K, p=p, q=q, R=R), t32(X))
    assert tuple(got.shape) == (K + R, *PAYLOAD)
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("case", CASES, ids=ID)
def test_lcc_encode_collective_in_blocks_equals_reference(blocks, case, w):
    K, p, q = case
    R = 2
    blocks(w, S)
    X = np.random.default_rng(7 * K + p).integers(0, q, size=(K, *PAYLOAD), dtype=np.uint64)
    plan = plc.build_lcc(K, p=p, q=q, R=R)
    fn = plc.lcc_encode_collective(plan, device="cpu")
    got = fn(plc.lcc_pad(plan, t32(X)))
    want = encode_oracle(np.concatenate([X, np.zeros((R, *PAYLOAD), np.uint64)]),
                         rlc.lcc_generator(r_lcc_plan(K, p, q, R)), q)
    assert tuple(got.shape) == (K + R, *PAYLOAD)
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("kind", ["parity", "lcc_square", "lcc_padded"])
def test_the_reference_encodes_equal_the_blocked_port(blocks, kind):
    """The reference's own encode (a JAX program), once a kind, at K = 16
    and 4-column blocks."""
    K = 16
    blocks("4", S)
    x = limbs(K, 99)
    if kind == "parity":
        got = prs.encode_parity(t32(x), prs.build_parity_plan(K))
        want = rrs.encode_parity(jnp.asarray(x), r_parity_plan(K, 1, M31))
    else:
        R = 0 if kind == "lcc_square" else 2
        X = x % NTT
        got = plc.lcc_encode(plc.build_lcc(K, R=R), t32(X))
        want = rlc.lcc_encode(r_lcc_plan(K, 1, NTT, R), jnp.asarray(X))
    assert np.array_equal(to_numpy(got), np.asarray(want))


def test_block_edges_and_output_allocated_once(blocks):
    """The blocks tile the columns in order, the last one ragged, each a
    view of the input handed over with its columns of the one output (rows
    a whole output row apart), into which the encode writes; a result that
    is not that view is stored into it; an input of one block is encoded as
    it is, with no output view."""
    blocks("8", S)
    assert prs.column_blocks(S, 2) == [(0, 8), (8, 16), (16, 21)]
    assert prs.column_blocks(0, 2) == [(0, 0)]
    seen, outs = [], []

    def enc(x, out):
        seen.append(tuple(x.shape))
        assert x.untyped_storage().data_ptr() == base.untyped_storage().data_ptr()
        if out is None:
            return x + 1
        outs.append(out)
        assert out.shape == x.shape and out.stride() == (S, 1)
        return torch.add(x, 1, out=out)

    x = base = torch.arange(2 * S, dtype=torch.int32).reshape(2, 3, 7)
    out = prs.encode_columns(enc, x)
    assert seen == [(2, 8), (2, 8), (2, 5)]
    assert torch.equal(out, x + 1)
    assert {o.untyped_storage().data_ptr() for o in outs} == {out.untyped_storage().data_ptr()}
    assert [o.storage_offset() for o in outs] == [0, 8, 16]
    assert torch.equal(prs.encode_columns(lambda x, out: x + 1, x), x + 1)  # stored
    blocks("S", S)
    seen.clear()
    assert torch.equal(prs.encode_columns(enc, x), x + 1) and seen == [(2, 3, 7)]


@pytest.mark.parametrize("rows", [6, 8, 10, 16, 18, 48, 50])
def test_the_block_width_is_the_widest_multiple_of_4_in_the_budget(rows):
    """At every row count the guards and encodes use: a multiple of 4, one
    block's working set within ``BLOCK_BYTES`` (1 GiB), 4 columns more
    over it."""
    w = prs.block_columns(rows)
    assert w % 4 == 0 and w > 1 << 17
    assert w * rows * prs.ROW_BYTES <= prs.BLOCK_BYTES < (w + 4) * rows * prs.ROW_BYTES


def test_the_block_width_follows_the_byte_budget(monkeypatch):
    monkeypatch.setattr(prs, "BLOCK_BYTES", 8 * prs.ROW_BYTES * 8)
    assert prs.block_columns(8) == 8 and prs.block_columns(16) == 4 and prs.block_columns(1000) == 4
    assert prs.column_blocks(S, 8) == [(0, 8), (8, 16), (16, 21)]
    assert prs.column_blocks(S, 3) == [(0, 20), (20, 21)]


# ---------------------------------------------------------------------------
# the guards' snapshots
# ---------------------------------------------------------------------------


def train_state(seed: int):
    """bf16 parameters of odd sizes, float32 moments, an int32 step and a
    bool mask of 11 bytes (an odd byte count, its last limb padded)."""
    rng = np.random.default_rng(seed)
    params = {name: jnp.asarray(rng.normal(size=shape), dtype=jnp.bfloat16)
              for name, shape in (("wq", (9, 7)), ("wo", (7, 9)), ("norm", (13,)))}
    return {
        "params": params,
        "opt": {"m": jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), params),
                "step": jnp.asarray(7, jnp.int32)},
        "mask": jnp.asarray(rng.integers(0, 2, size=(11,)).astype(bool)),
    }


def serve_state(seed: int):
    rng = np.random.default_rng(seed)
    cache = [{"k": jnp.asarray(rng.normal(size=(2, 5, 2, 3)), jnp.bfloat16),
              "v": jnp.asarray(rng.normal(size=(2, 5, 2, 3)), jnp.bfloat16)} for _ in range(2)]
    state = {"tokens": jnp.asarray(rng.integers(0, 1000, size=(2, 5)), jnp.int32),
             "pos": jnp.asarray([3, 4], jnp.int32), "flags": jnp.asarray(rng.integers(0, 2, size=(7,)).astype(bool))}
    return cache, state


def limb_edges(state, K: int):
    """(the leaves' limb ranges, every block edge as a global limb index)
    at the module's block width."""
    src = prs.LimbSource(state_from_reference(state, "cpu"), "cpu")
    Sx = -(-src.total // K)
    edges = {j * Sx + lo for j in range(K) for lo, _ in prs.column_blocks(Sx, K)} - {0}
    return list(zip(src.starts, src.starts[1:])), edges


@functools.lru_cache(maxsize=None)
def reference_state_guard(K: int, p: int):
    ref = RStateGuard(K=K, p=p)
    ref.snapshot(train_state(K + p), step=3)
    return ref


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("K,p", [(K, p) for K in KS for p in PS])
def test_state_guard_snapshot_in_blocks_equals_reference(blocks, K, p, w):
    st = train_state(K + p)
    ref = reference_state_guard(K, p)
    Sx = ref._shards.shape[1]
    blocks(w, Sx)
    guard = CodedStateGuard(K=K, p=p, device="cpu")
    guard.snapshot(state_from_reference(st, "cpu"), step=3)
    assert guard._shards.dtype == np.uint32 and guard._shards.shape == (K, Sx)
    assert np.array_equal(guard._shards, ref._shards)
    assert np.array_equal(guard._parity, ref._parity)


@pytest.mark.parametrize("w", ["4", "S-1"])
@pytest.mark.parametrize("K", [8, 16])
def test_fail_and_recover_after_a_blocked_snapshot(blocks, K, w):
    st = train_state(K + 1)
    lost = [1, 4, 6]
    ref = reference_state_guard(K, 1)
    blocks(w, ref._shards.shape[1])
    guard = CodedStateGuard(K=K, device="cpu")
    guard.snapshot(state_from_reference(st, "cpu"), step=3)
    rec, at = guard.fail_and_recover(lost)
    r_rec, r_at = ref.fail_and_recover(lost)
    assert at == r_at == 3
    assert_same_state(rec, st)
    assert_same_state(rec, r_rec)


def test_the_states_block_edges_fall_inside_a_leaf_and_on_the_odd_bool_leaf(blocks):
    """At 4-column blocks and K = 8 the edges fall inside leaves, and one
    inside the bool leaf of odd byte count (11 bytes in the train state, 7
    in the serve state), whose last limb is padded."""
    blocks("4", S)
    for state in (train_state(9), serve_state(8)):
        ranges, edges = limb_edges(state, 8)
        assert len([(a, b) for a, b in ranges if any(a < e < b for e in edges)]) >= 3
        bools = [r for r, leaf in zip(ranges, jax.tree.leaves(state)) if np.asarray(leaf).dtype == bool]
        assert len(bools) == 1 and any(bools[0][0] < e < bools[0][1] for e in edges), (bools, sorted(edges))


@functools.lru_cache(maxsize=None)
def reference_serve_rows(K: int, p: int, R: int):
    ref = RServeGuard(K=K, R=R, p=p)
    cache, state = serve_state(K + R + p)
    ref.snapshot(cache, state, tick=0)
    return {j: np.asarray(v) for j, v in ref.group._mem.items()}


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("collective", [False, True])
@pytest.mark.parametrize("K,p", [(K, p) for K in KS for p in PS])
def test_serve_guard_snapshot_in_blocks_equals_reference(blocks, K, p, collective, w):
    R = 2
    want = reference_serve_rows(K, p, R)
    cache, state = serve_state(K + R + p)
    blocks(w, want[0].shape[0])
    guard = CodedServeGuard(K=K, R=R, p=p, collective=collective, device="cpu")
    guard.snapshot(state_from_reference(cache, "cpu"), state_from_reference(state, "cpu"), tick=0)
    assert sorted(guard.group._mem) == sorted(want) == list(range(K + R))
    for j in range(K + R):
        assert np.array_equal(guard.group._mem[j], want[j]), j


@pytest.mark.parametrize("w", ["4", "S+4"])
def test_serve_guard_recovers_after_a_blocked_snapshot(blocks, w):
    K, R = 8, 2
    cache, state = serve_state(3)
    guard = CodedServeGuard(K=K, R=R, device="cpu")
    blocks(w, -(-prs.state_meta(state_from_reference((cache, state), "cpu")).total // K))
    guard.snapshot(state_from_reference(cache, "cpu"), state_from_reference(state, "cpu"), tick=4)
    guard.group.kill(0)
    guard.group.kill(7)
    got_cache, got_state = guard.recover([0, 7])
    assert_same_state(got_cache, cache)
    assert_same_state(got_state, state)


# ---------------------------------------------------------------------------
# the bound
# ---------------------------------------------------------------------------


def test_encode_parity_peak_is_its_input_and_output_and_one_block():
    """``encode_parity`` over meta limbs of (8, 2^27), counted by
    ``launch.op_cost.count_fn``: the most bytes live at once are at most the
    input (4 GiB), the output (4 GiB) and 2 GiB, and one block's working set
    is within ``BLOCK_BYTES``. Blocked, it counts 8.83 GiB (a block of
    1,398,100 columns adds 0.83 GiB, 80 bytes a row and column; with blocks
    of 2^18 columns it counted 8.16 GiB). The unblocked path (one block of
    2^27 columns) counted 84.0 GiB: the prepare phase's buffer, the shoot's
    (K, n, S) result and its round copies, and the int64 temporaries of the
    modular products, all at the whole width."""
    K, cols = 8, 1 << 27
    x = torch.empty((K, cols), dtype=torch.int32, device="meta")
    mem = count_fn(lambda t: prs.encode_parity(t, prs.build_parity_plan(K)), x).memory
    assert mem["argument_bytes"] == mem["output_bytes"] == K * cols * 4
    assert mem["peak_bytes"] <= mem["argument_bytes"] + mem["output_bytes"] + (2 << 30)
    assert mem["peak_bytes"] <= mem["argument_bytes"] + mem["output_bytes"] + prs.BLOCK_BYTES
    assert len(prs.column_blocks(cols, K)) == math.ceil(cols / 1_398_100) == 97


@pytest.mark.parametrize("host", ["holds-both", "holds-one"])
def test_a_snapshot_that_raises_keeps_the_last_one_where_the_host_holds_both(monkeypatch, host):
    """The second snapshot raises in the port's guard and in the
    reference's (made to raise through its instance's ``_encode_jit``).
    Where the host holds both snapshots' arrays (the decision,
    ``elastic.host_holds_both``, patched), the port keeps step 3 and
    ``fail_and_recover([1, 4, 6])`` gives the reference's state and step,
    bit for bit. Where it does not, the port drops the last snapshot first,
    says so once with a ``RuntimeWarning`` naming both byte counts, and a
    raise leaves no recovery point (``step`` -1)."""
    from repro_torch.train import elastic

    K, lost = 8, [1, 4, 6]
    first, second = train_state(9), train_state(10)
    monkeypatch.setattr(elastic, "host_holds_both", lambda need: (host == "holds-both", 12_345))
    guard = CodedStateGuard(K=K, device="cpu")
    guard.snapshot(state_from_reference(first, "cpu"), step=3)
    ref = RStateGuard(K=K)
    ref.snapshot(first, step=3)

    def fail(*args, **kwargs):
        raise MemoryError("no room for the block")

    monkeypatch.setattr(elastic, "encode_parity", fail)
    ref._encode_jit = fail
    with pytest.raises(MemoryError):
        ref.snapshot(second, step=5)
    r_rec, r_at = ref.fail_and_recover(lost)
    assert r_at == 3
    need = 2 * K * ref._shards.shape[1] * 4
    if host == "holds-both":
        with pytest.raises(MemoryError):
            guard.snapshot(state_from_reference(second, "cpu"), step=5)
        rec, at = guard.fail_and_recover(lost)
        assert at == r_at == 3
        assert_same_state(rec, r_rec)
        assert_same_state(rec, first)
        return
    with pytest.warns(RuntimeWarning, match=f"{need:,} bytes beside 12,345 bytes"):
        with pytest.raises(MemoryError):
            guard.snapshot(state_from_reference(second, "cpu"), step=5)
    assert guard.step == -1 and guard._shards is None and guard._parity is None
    with pytest.raises(RuntimeError, match="no snapshot taken"):
        guard.fail_and_recover(lost)
    monkeypatch.undo()
    monkeypatch.setattr(elastic, "host_holds_both", lambda need: (False, 12_345))
    guard.snapshot(state_from_reference(second, "cpu"), step=5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once a guard
        guard.snapshot(state_from_reference(first, "cpu"), step=6)
    rec, at = guard.fail_and_recover(lost)
    assert at == 6
    assert_same_state(rec, r_rec)


def test_the_keep_or_drop_decision_reads_mem_available(monkeypatch, tmp_path):
    """``host_holds_both`` keeps the last snapshot where the new arrays and
    ``HOST_MARGIN`` fit in ``MemAvailable``, drops it where they do not, and
    keeps it (the reference's semantics) where the file cannot be read."""
    from repro_torch.train import elastic

    info = tmp_path / "meminfo"
    info.write_text("MemTotal:       105906176 kB\nMemFree:  1 kB\nMemAvailable:   20971520 kB\n")
    monkeypatch.setattr(elastic, "MEMINFO", str(info))
    avail = 20971520 * 1024
    assert elastic.host_holds_both(avail - elastic.HOST_MARGIN) == (True, avail)
    assert elastic.host_holds_both(avail - elastic.HOST_MARGIN + 1) == (False, avail)
    monkeypatch.setattr(elastic, "MEMINFO", str(tmp_path / "absent"))
    assert elastic.host_holds_both(1 << 60) == (True, None)
    info.write_text("MemTotal:       105906176 kB\n")
    monkeypatch.setattr(elastic, "MEMINFO", str(info))
    assert elastic.host_holds_both(1 << 60) == (True, None)


def test_a_serving_snapshot_that_raises_keeps_the_last_one(monkeypatch):
    """The serving guard's second snapshot, of a state of other shapes,
    raises in its encode: the guard keeps the first snapshot's metadata and
    tick and the hosts their rows (equal to the reference guard's), and a
    recovery after two kills gives the first state bit for bit."""
    import repro_torch.serve.coded as psc

    K, R = 8, 2
    cache, state = serve_state(3)
    ref = RServeGuard(K=K, R=R)
    ref.snapshot(cache, state, tick=4)
    guard = CodedServeGuard(K=K, R=R, device="cpu")
    guard.snapshot(state_from_reference(cache, "cpu"), state_from_reference(state, "cpu"), tick=4)
    meta, rows = guard._meta, {j: v.copy() for j, v in guard.group._mem.items()}

    def fail(*args, **kwargs):
        raise MemoryError("no room for the block")

    monkeypatch.setattr(psc, "lcc_encode", fail)
    other = state_from_reference(serve_state(4), "cpu")
    other[1]["extra"] = torch.arange(5, dtype=torch.int32)
    with pytest.raises(MemoryError):
        guard.snapshot(*other, tick=9)
    assert guard._tick == 4 and guard._meta is meta and guard._mesh is None and guard.snapshots == 1
    assert sorted(guard.group._mem) == list(range(K + R))
    for j in range(K + R):
        assert np.array_equal(guard.group._mem[j], rows[j]) and np.array_equal(rows[j], np.asarray(ref.group._mem[j]))
    guard.group.kill(0)
    guard.group.kill(7)
    got_cache, got_state = guard.recover([0, 7])
    assert_same_state(got_cache, cache)
    assert_same_state(got_state, state)
