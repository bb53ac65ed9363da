"""Differential tests of the coded layer's two model-free consumers on the
CPU: the coded-checkpoint guard and the disk tier of training
(``repro_torch.train``), and the coded-serving guard (``repro_torch.serve``),
against ``repro.train`` and ``repro.serve`` on the same seeded inputs.

Everything runs with ``device="cpu"``; states are carried across by
``repro_torch.convert.state_from_reference``. Parity, coded shards and
recovered states must equal the reference's bit for bit (tolerance 0), and
checkpoints must cross both ways: each package restores the other's files,
bfloat16 leaves included. Every child process of a ``ProcessHostPool`` is
waited for with a timeout.
"""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.serve.coded import CodedServeGuard as RServeGuard
from repro.serve.coded import FaultInjector as RFaultInjector
from repro.train.checkpoint import restore_checkpoint as r_restore
from repro.train.checkpoint import save_checkpoint as r_save
from repro.train.elastic import CodedStateGuard as RStateGuard
from repro_torch import tree
from repro_torch.coded import build_lcc, lcc_encode, lcc_pad
from repro_torch.convert import state_from_reference, to_numpy, to_tensor
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import CodedDecodeGroup, CodedServeGuard, FaultInjector, ProcessHostPool
from repro_torch.train import CodedStateGuard, latest_step, restore_checkpoint, save_checkpoint
from test_torch_coded import bits, ref_bits

WAIT_S = 30


def assert_same_state(port, ref):
    p_leaves, r_leaves = tree.leaves(port), jax.tree.leaves(ref)
    assert tree.structure(port) == tree.structure(ref)
    assert len(p_leaves) == len(r_leaves)
    for p, r in zip(p_leaves, r_leaves):
        assert tuple(p.shape) == tuple(np.shape(r))
        assert str(p.dtype).replace("torch.", "") == np.asarray(r).dtype.name
        assert np.array_equal(bits(p), ref_bits(r))


def train_state(seed: int = 0):
    """A small training state: bf16 parameters, float32 moments, an int32
    step and a bool mask of odd byte count, keys out of sorted order."""
    rng = np.random.default_rng(seed)
    params = {name: jnp.asarray(rng.normal(size=shape), dtype=jnp.bfloat16)
              for name, shape in (("wq", (16, 16)), ("wo", (16, 16)), ("norm", (16,)))}
    return {
        "params": params,
        "opt": {"m": jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), params),
                "step": jnp.asarray(7, jnp.int32)},
        "mask": jnp.asarray(rng.integers(0, 2, size=(3,)).astype(bool)),
    }


def serve_state(seed: int = 0):
    """A (cache, state) pair: bf16 KV slabs of two layers, an int32 token
    buffer and per-slot positions."""
    rng = np.random.default_rng(seed)
    cache = [{"k": jnp.asarray(rng.normal(size=(2, 8, 2, 4)), jnp.bfloat16),
              "v": jnp.asarray(rng.normal(size=(2, 8, 2, 4)), jnp.bfloat16)} for _ in range(2)]
    state = {"tokens": jnp.asarray(rng.integers(0, 1000, size=(2, 8)), jnp.int32),
             "pos": jnp.asarray([3, 5], jnp.int32)}
    return cache, state


# ---------------------------------------------------------------------------
# coded-checkpoint guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,lost", [(8, [1, 4, 6]), (4, [2]), (16, [0, 15])])
def test_state_guard_parity_and_recovery_equal_reference(K, lost):
    st = train_state(K)
    ref = RStateGuard(K=K)
    ref.snapshot(st, step=3)
    guard = CodedStateGuard(K=K, device="cpu")
    guard.snapshot(state_from_reference(st, "cpu"), step=3)
    assert np.array_equal(guard._shards, ref._shards)
    assert np.array_equal(guard._parity, ref._parity)
    assert guard.overhead_elements == ref.overhead_elements == guard._parity.shape[1]
    rec, at = guard.fail_and_recover(lost)
    r_rec, r_at = ref.fail_and_recover(lost)
    assert at == r_at == 3
    assert all(t.device.type == "cpu" for t in tree.leaves(rec))
    assert_same_state(rec, st)
    assert_same_state(rec, r_rec)


def test_state_guard_needs_a_snapshot():
    guard = CodedStateGuard(K=4, device="cpu")
    assert guard.overhead_elements == 0
    with pytest.raises(RuntimeError, match="no snapshot"):
        guard.fail_and_recover([0])


# ---------------------------------------------------------------------------
# checkpoints cross both ways
# ---------------------------------------------------------------------------


def test_port_restores_a_reference_checkpoint(tmp_path):
    st = train_state(1)
    r_save(str(tmp_path), st, step=5, extra={"who": "reference"})
    like = tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                    state_from_reference(st, "cpu"))
    got, step = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert step == 5 and latest_step(str(tmp_path)) == 5
    assert got["params"]["wq"].dtype == torch.bfloat16
    assert_same_state(got, st)


def test_reference_restores_a_port_checkpoint(tmp_path):
    st = train_state(2)
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    manifest = save_checkpoint(str(port_dir), state_from_reference(st, "cpu"), step=9, extra={"k": 1})
    r_manifest = r_save(str(ref_dir), st, step=9, extra={"k": 1})
    assert manifest == r_manifest
    assert json.loads((port_dir / "manifest.json").read_text()) == json.loads((ref_dir / "manifest.json").read_text())
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), st)
    got, step = r_restore(str(port_dir), like)
    assert step == 9
    assert_same_state(state_from_reference(got, "cpu"), st)
    data = np.load(port_dir / "state_00000009.npz")
    assert data["params/wq"].dtype == np.dtype("V2")


def test_port_checkpoint_round_trip_and_16_bit_integers_for_bfloat16(tmp_path):
    st = state_from_reference(train_state(3), "cpu")
    save_checkpoint(str(tmp_path), st, step=1)
    save_checkpoint(str(tmp_path), st, step=12)
    assert latest_step(str(tmp_path)) == 12
    got, step = restore_checkpoint(str(tmp_path), st, step=1, device="cpu")
    assert step == 1
    for a, b in zip(tree.leaves(got), tree.leaves(st)):
        assert a.dtype == b.dtype and np.array_equal(bits(a), bits(b))
    # a bfloat16 leaf written as uint16 reads back by its bits, not its value
    w = st["params"]["norm"]
    np.savez(tmp_path / "state_00000020.npz", x=w.view(torch.int16).numpy().view(np.uint16))
    got, _ = restore_checkpoint(str(tmp_path), {"x": w}, device="cpu")
    assert np.array_equal(bits(got["x"]), bits(w))


def test_restore_without_a_checkpoint_raises(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(2)}, device="cpu")
    with pytest.raises(FileNotFoundError):  # shardings=None: every leaf on the device, as without it
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(2)}, shardings=None, device="cpu")


# ---------------------------------------------------------------------------
# coded-serving guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("collective", [False, True])
@pytest.mark.parametrize("K,R", [(3, 1), (6, 2), (4, 3)])
def test_serve_guard_coded_shards_equal_reference(K, R, collective):
    cache, state = serve_state(K + R)
    ref = RServeGuard(K=K, R=R)
    ref.snapshot(cache, state, tick=0)
    guard = CodedServeGuard(K=K, R=R, collective=collective, device="cpu")
    guard.snapshot(state_from_reference(cache, "cpu"), state_from_reference(state, "cpu"), tick=0)
    assert sorted(guard.group._mem) == sorted(ref.group._mem) == list(range(K + R))
    for j in range(K + R):
        assert np.array_equal(guard.group._mem[j], ref.group._mem[j]), j


@pytest.mark.parametrize("collective", [False, True])
def test_serve_guard_recovers_bit_exact_with_metrics_and_spans(collective):
    K, R = 6, 2
    cache, state = serve_state(1)
    kills = ((1, 3), (2, 0))
    ref = RServeGuard(K=K, R=R, injector=RFaultInjector(kills=kills))
    guard = CodedServeGuard(K=K, R=R, injector=FaultInjector(kills=kills), collective=collective,
                            device="cpu")
    reg, tracer = MetricsRegistry(), Tracer()
    guard.attach(reg, tracer)
    guard.snapshot(state_from_reference(cache, "cpu"), state_from_reference(state, "cpu"), tick=4)
    ref.snapshot(cache, state, tick=4)
    assert guard.poll(2) == ref.poll(2) == [3]
    assert guard.poll(5) == ref.poll(5) == [0]
    dead = [3, 0]
    got_cache, got_state = guard.recover(dead, requests_in_flight=2)
    r_cache, r_state = ref.recover(dead, requests_in_flight=2)
    assert_same_state(got_cache, cache)
    assert_same_state(got_state, state)
    assert_same_state(got_cache, r_cache)
    assert_same_state(got_state, r_state)
    stats, r_stats = guard.stats(), ref.stats()
    assert stats.keys() == r_stats.keys() and stats["recovery_us"].keys() == r_stats["recovery_us"].keys()
    for k in ("K", "R", "n_hosts", "injected_faults", "recoveries", "requests_recovered", "snapshots"):
        assert stats[k] == r_stats[k], k
    assert stats["recoveries"] == 2 and stats["recovery_us"]["p50"] > 0
    snap = reg.snapshot()
    assert snap["serve.snapshots"]["value"] == 1
    assert snap["serve.recoveries"]["value"] == 2
    assert snap["serve.recovery_us"]["count"] == 1
    spans = [s for s in tracer.spans if s.name == "serve.recovery"]
    assert len(spans) == 1 and spans[0].attrs == {"hosts": "[0, 3]", "tick": 4}


def test_serve_guard_edges_raise():
    with pytest.raises(ValueError):
        CodedServeGuard(K=4, R=0, device="cpu")
    with pytest.raises(ValueError, match="collective=True"):
        CodedServeGuard(K=4, R=1, kernels="fused", device="cpu")
    g = CodedServeGuard(K=3, R=1, device="cpu")
    with pytest.raises(RuntimeError, match="no snapshot"):
        g.recover([0])


def test_serve_guard_beyond_tolerance_raises():
    """Losing R+1 hosts is past the code: recover must raise, not return
    interpolated garbage."""
    g = CodedServeGuard(K=3, R=1, injector=FaultInjector(kills=((0, 0), (0, 2))), device="cpu")
    g.snapshot({}, {"x": torch.arange(6, dtype=torch.float32)}, tick=0)
    dead = g.poll(4)
    assert dead == [0, 2]
    with pytest.raises(RuntimeError, match="need K=3"):
        g.recover(dead)


def test_fault_injector_fires_each_kill_once():
    inj = FaultInjector(kills=((2, 0), (2, 3), (9, 1)))
    assert inj.due(1) == []
    assert inj.due(4) == [(2, 0), (2, 3)]
    assert inj.due(5) == []
    assert inj.due(100) == [(9, 1)]
    assert inj.injected == 3


def _all_ended(pool):
    for p in pool.procs:
        try:
            p.wait(timeout=WAIT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            raise
    return all(p.poll() is not None for p in pool.procs)


def test_process_host_pool_store_fetch_kill():
    pool = ProcessHostPool(3)
    try:
        arr = np.arange(17, dtype=np.uint32)
        assert pool.store(0, arr)
        np.testing.assert_array_equal(pool.fetch(0), arr)
        assert pool.fetch(1) is None  # nothing stored yet
        pool.kill(2)
        assert not pool.alive(2)
        assert not pool.store(2, arr)
        assert pool.fetch(2) is None
    finally:
        pool.close()
    assert _all_ended(pool)


def test_serve_guard_with_sigkilled_host_processes():
    K, R = 3, 2
    cache, state = serve_state(2)
    pool = ProcessHostPool(K + R)
    try:
        guard = CodedServeGuard(K=K, R=R, injector=FaultInjector(kills=((1, 2),)), hosts=pool,
                                device="cpu")
        guard.snapshot(state_from_reference(cache, "cpu"), state_from_reference(state, "cpu"), tick=0)
        os.kill(pool.procs[4].pid, 9)  # a host that dies without the injector
        pool.procs[4].wait(timeout=WAIT_S)
        dead = guard.poll(3)
        assert sorted(dead) == [2, 4] and not pool.alive(2)
        got_cache, got_state = guard.recover(dead)
        assert_same_state(got_cache, cache)
        assert_same_state(got_state, state)
        assert guard.injected_faults == 1 and guard.recoveries == 2
    finally:
        pool.close()
    assert _all_ended(pool)


def test_decode_group_reconstructs_any_k_of_n():
    import itertools

    plan = build_lcc(3, R=2)
    X = np.arange(3 * 11, dtype=np.uint32).reshape(3, 11)
    coded = to_numpy(lcc_encode(plan, lcc_pad(plan, to_tensor(X, "cpu"))[: plan.K]))
    for killed in itertools.combinations(range(5), 2):
        grp = CodedDecodeGroup(plan)
        grp.store(coded.reshape(5, -1))
        for h in killed:
            assert grp.kill(h)
            assert not grp.kill(h)  # can't die twice
        np.testing.assert_array_equal(grp.reconstruct().reshape(3, 11), X)


def test_decode_group_host_count_mismatch():
    plan = build_lcc(3, R=2)
    pool = ProcessHostPool(4)  # needs 5
    try:
        with pytest.raises(ValueError, match="need N=5"):
            CodedDecodeGroup(plan, hosts=pool)
    finally:
        pool.close()
    assert _all_ended(pool)
