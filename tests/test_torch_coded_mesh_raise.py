"""A raise in the root's encode on a mesh of ranks, against the reference, on
four gloo ranks on the CPU.

On a (data=2, model=2) mesh the coded guards' encode runs on the mesh's first
rank alone (``coded.rs_checkpoint.on_root``), so a raise there is told to
every rank. One 4-rank world of its own (``torch_coded_mesh_harness.
port_raise``) snapshots a float32 smoke-config parameter state, then a second
one with rank 0's encode made to raise, in three cases: the train guard where
the host holds both snapshots (it keeps the first), the train guard where it
does not (rank 0's decision patched: the first is dropped first, on every
rank), and the single-program serving guard. The reference's train guard runs
the same two snapshots in this process, its second made to raise through its
instance's ``_encode_jit``; the recovered states are held equal bit for bit.

Alone on an 8-core CPU machine with no other load the world took 6.1-7.1 s;
with the whole suite beside it in six workers (``-n 6 --dist loadfile``) the
first test, the world's setup included, took 13.9 s. The deadline is 240 s,
17x the loaded time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.train.elastic import CodedStateGuard as RStateGuard
from torch_coded_mesh_harness import TRAIN_K, TRAIN_LOST
from torch_ranks_harness import run_ranks

DEADLINE_S = 240.0


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(4, "torch_coded_mesh_harness:port_raise", deadline=DEADLINE_S)


@pytest.fixture(scope="module")
def reference(ranks):
    """The reference guard's recovery after the same raise, on the first
    state the ranks placed (carried across as float32 arrays)."""
    first = jax.tree.map(jnp.asarray, ranks[0]["first"])
    guard = RStateGuard(K=TRAIN_K)
    guard.snapshot(first, step=3)

    def fail(*args, **kwargs):
        raise MemoryError("the reference's encode")

    guard._encode_jit = fail
    with pytest.raises(MemoryError):
        guard.snapshot(jax.tree.map(lambda a: a + 1, first), step=5)
    state, step = guard.fail_and_recover(TRAIN_LOST)
    return [np.asarray(a) for a in jax.tree.leaves(state)], step, [np.asarray(a) for a in jax.tree.leaves(first)]


def same_leaves(got, want) -> bool:
    return len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g.view(np.uint8), w.view(np.uint8))
        for g, w in zip(got, want))


def test_a_raise_on_the_root_raises_on_every_rank(ranks):
    for case in ("keep", "drop", "serve"):
        assert ranks[0][case]["raised"] == "MemoryError: the root's encode", case
        for r in ranks[1:]:
            assert r[case]["raised"] == "RuntimeError: the coded snapshot failed on rank 0", case


def test_every_rank_keeps_the_last_snapshot_and_recovers_it_as_the_reference(ranks, reference):
    """Where the host holds both: step 3 on every rank, only rank 0 holds
    the arrays, and every rank's recovery is the reference guard's after the
    same raise, and the first state, bit for bit."""
    want, r_step, first = reference
    assert r_step == 3 and same_leaves(want, first)
    for rank, r in enumerate(ranks):
        keep = r["keep"]
        assert keep["step"] == keep["recovered_step"] == 3 and keep["recover_raised"] is None
        assert keep["held"] == (rank == 0) and keep["warned"] == []
        assert same_leaves(keep["leaves"], want), rank


def test_where_the_root_cannot_hold_both_every_rank_drops_it(ranks):
    """Rank 0's decision is told to every rank: each warns once, naming the
    bytes, holds step -1 after the raise, and every recovery raises."""
    for rank, r in enumerate(ranks):
        drop = r["drop"]
        assert drop["step"] == -1 and not drop["held"] and "leaves" not in drop
        assert len(drop["warned"]) == 1 and "beside 1 bytes available" in drop["warned"][0]
        want = ("RuntimeError: no snapshot taken" if rank == 0
                else "RuntimeError: the coded state's recovery failed on rank 0")
        assert drop["recover_raised"] == want


def test_the_serving_guard_keeps_its_last_snapshot_on_every_rank(ranks, reference):
    first = reference[2]
    for rank, r in enumerate(ranks):
        assert r["serve"]["tick"] == 4 and r["serve"]["snapshots"] == 1
        assert same_leaves(r["serve"]["leaves"], first), rank
