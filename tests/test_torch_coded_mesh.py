"""The coded guards on a mesh of ranks against the reference, on gloo ranks on
the CPU.

One JAX child with 8 forced host devices writes the reference's outputs
(``torch_coded_mesh_harness.reference_outputs``): its continuous engine on a
(data=2, model=2) mesh at float32, plain and under ``CodedServeGuard(K=3,
R=2)`` with kills ``((1, 0), (5, 4))``; its serving launcher with ``--mesh
2x2`` with and without ``--coded 3,2 --kill 2:0 --kill 6:4``, both launchers
reading the reference's bf16 weights from one ``--ckpt``; and its
``CodedStateGuard(K=8)`` snapshot of a train state. One 4-rank world runs the
port's cases (``port_main``, deadline 300 s); one 8-rank world the port of
the reference's ``test_coded_serve_mesh_8_host_devices_sigkill``
(``port_hosts``, deadline 300 s), whose first coded rows a second JAX child
encodes with the reference's ``lcc_encode_collective`` on an 8-wide host
mesh. Alone on an 8-core CPU machine with no other load (the reference child
run first) the 4-rank world took 44.6 s and the 8-rank world 6.9 s: each
deadline is 6.7x and 43x its time.

Tolerances: tokens equal; coded shards, parity and recovered states bit for
bit. The one comparison that is not exact is the first snapshot's float32
KV cache, the port's against the reference's: the two packages sum the
projections in another order (measured 6e-7 at most, on values up to 2.8);
it is held at rtol 1e-5, atol 1e-6, and the coded shards are then compared on
one state, the port's, through both packages' guards. The rng leaf differs
by design: the port's sampling streams are seed pairs, the reference's JAX
keys (``serve/engine.py``'s docstring).
"""

import json
import zlib

import numpy as np
import pytest
import torch

import jax  # noqa: F401 - both packages in one test process, JAX on the CPU
import jax.numpy as jnp

import torch_coded_mesh_harness as H
from repro.serve import CodedServeGuard as RCodedServeGuard
from repro_torch.coded.rs_checkpoint import shard_state_limbs, state_limb_row, state_meta, state_to_limbs
from repro_torch.launch.mesh import RankMesh
from repro_torch.serve import CodedServeGuard
from torch_ranks_harness import run_ranks


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path, ckpt = H.reference_outputs(str(tmp_path_factory.mktemp("coded_mesh_ref")))
    return {"path": path, "ckpt": ckpt, "data": dict(np.load(path))}


@pytest.fixture(scope="module")
def port(ref):
    return run_ranks(4, "torch_coded_mesh_harness:port_main", ref["path"], ref["ckpt"], deadline=300.0)


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    return run_ranks(8, "torch_coded_mesh_harness:port_hosts", str(tmp_path_factory.mktemp("coded_hosts")),
                     deadline=300.0)


def ref_tokens(ref, kind):
    return [ref["data"][f"{kind}/{i}"].tolist() for i in range(len(H.PROMPTS))]


def ref_lines(ref, name):
    return json.loads(str(ref["data"][name]))


def token_lines(lines):
    return [s for s in lines if s.startswith("cli-")]


# ---------------------------------------------------------------------------
# the single-program guard on the 2x2 engine
# ---------------------------------------------------------------------------


def test_guarded_2x2_tokens_equal_the_reference_on_every_rank(ref, port):
    assert port[0]["guarded"] == ref_tokens(ref, "guarded") == ref_tokens(ref, "plain")
    assert all(r["guarded"] == port[0]["guarded"] and r["plain"] == port[0]["plain"] for r in port)
    assert port[0]["plain"] == ref_tokens(ref, "plain")


def test_guarded_2x2_recovers_from_both_kills_on_every_rank(ref, port):
    want = json.loads(str(ref["data"]["guarded_stats"]))
    for r in port:
        st = r["guarded_stats"]
        for k in ("K", "R", "n_hosts", "injected_faults", "recoveries", "requests_recovered", "snapshots"):
            assert st[k] == want[k], k
        assert st["alive"] == [1, 2, 3] and st["faults"] == [(0, 2), (4, 6)]
        assert st["metric_recoveries"] == 2 and st["cache_placed"]


def test_first_snapshot_state_equals_the_reference(ref, port):
    """Every leaf of the state the guard read first: the counters, mask and
    buffers equal, the float32 KV cache within rtol 1e-5, atol 1e-6, and the
    rng rows the port's seed pairs (seed 0, the request id's hash)."""
    got = port[0]["first_leaves"]
    want = [ref["data"][f"first/{i}"] for i in range(len(got))]
    assert [a.shape for a in got] == [b.shape for b in want]
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(got[2:-1], want[2:-1]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    seeds = [[0, zlib.crc32(f"r{i}".encode()) & 0x7FFFFFFF] for i in range(H.ENGINE["n_slots"])]
    assert got[-1].dtype == np.int32 and got[-1].tolist() == seeds


def test_first_snapshot_coded_shards_equal_the_reference_guard(port):
    """The port's first coded shards, as rank 0's decode group holds them,
    equal the reference guard's snapshot of the same (gathered) state and a
    one-process port guard's."""
    leaves = port[0]["first_leaves"]
    rg = RCodedServeGuard(K=H.K, R=H.R)
    rg.snapshot([jnp.asarray(x) for x in leaves[:-1]], [jnp.asarray(leaves[-1])], tick=0)
    one = CodedServeGuard(K=H.K, R=H.R, device="cpu")
    one.snapshot([torch.from_numpy(x) for x in leaves[:-1]], [torch.from_numpy(leaves[-1])], tick=0)
    rows = port[0]["first_rows"]
    assert rows.shape[0] == H.K + H.R
    for j in range(H.K + H.R):
        np.testing.assert_array_equal(rows[j], np.asarray(rg.group._mem[j]))
        np.testing.assert_array_equal(rows[j], one.group._mem[j])


# ---------------------------------------------------------------------------
# the rank form: CodedServeGuard(mesh=, axis=) over the four ranks
# ---------------------------------------------------------------------------


def test_rank_form_guard_on_the_2x2_engine(port):
    """K = 2, R = 2 over the four ranks as the axis ``hosts``: rank j encodes
    row j; host 3 killed after tick 2; the tokens are the unguarded run's
    on every rank and the first coded rows equal the one-program encode of
    the same limbs."""
    for rank, r in enumerate(port):
        rk = r["ranks"]
        assert rk["tokens"] == port[0]["plain"]
        assert rk["stats"]["recoveries"] == 1 and rk["stats"]["injected_faults"] == 1
        assert rk["alive"] == [0, 1, 2] and rk["host"] == rank and rk["device"] == "cpu"
    rk = port[0]["ranks"]
    assert rk["rows"].shape[0] == H.RANK_K + H.RANK_R
    np.testing.assert_array_equal(rk["rows"], rk["single"])


def test_mesh_requires_axis():
    mesh = RankMesh(None, (5,), ("hosts",), 0, (0,), tuple(range(5)), torch.device("cpu"))
    with pytest.raises(ValueError, match="mesh= requires axis="):
        CodedServeGuard(K=3, R=2, mesh=mesh)
    with pytest.raises(ValueError, match="collective=True"):
        CodedServeGuard(K=3, R=2, mesh=mesh, axis="hosts", collective=True)


def test_an_axis_whose_size_is_not_n_is_refused():
    mesh = RankMesh(None, (4,), ("hosts",), 0, (0,), tuple(range(4)), torch.device("cpu"))
    with pytest.raises(ValueError, match="has 4 ranks, need N=5"):
        CodedServeGuard(K=3, R=2, mesh=mesh, axis="hosts")


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_serve_launcher_2x2_coded_prints_the_reference_token_lines(ref, port):
    """``launch/serve.py --smoke --mesh 2x2 --coded 3,2 --kill 2:0 --kill
    6:4`` on the reference's weights prints the reference launcher's token
    lines, those of the run without ``--coded``, and its fault count."""
    want = ref_lines(ref, "launch_coded")
    got = port[0]["launch_coded"]
    assert token_lines(got) == token_lines(want) == token_lines(ref_lines(ref, "launch_plain"))
    assert token_lines(port[0]["launch_plain"]) == token_lines(want)
    assert len(token_lines(got)) == 2
    coded = [s for s in got if s.startswith("coded ")]
    assert len(coded) == 1 and coded[0].split(", recovery")[0] == \
        next(s for s in want if s.startswith("coded ")).split(", recovery")[0]
    assert all(not r["launch_coded"] and not r["launch_plain"] for r in port[1:])  # rank 0 alone prints


def test_train_launcher_2x2_coded_every_1_trains_as_coded_every_0(port):
    for r in port:
        tl = r["train_launcher"]
        assert tl["losses"]["1"] == tl["losses"]["0"] == port[0]["train_launcher"]["losses"]["1"]
        assert len(tl["losses"]["1"]) == 3 and tl["step"] == 2
    assert port[0]["train_launcher"]["held"] and not any(r["train_launcher"]["held"] for r in port[1:])


def test_train_guard_on_the_carried_state_equals_the_reference(ref, port):
    """The reference's train state after one step, carried across and
    placed on the 2x2 mesh: the port guard's shards and parity (held by rank
    0) equal the reference guard's; every rank agrees on the step."""
    tc = port[0]["train_carried"]
    np.testing.assert_array_equal(tc["shards"], ref["data"]["train/shards"])
    np.testing.assert_array_equal(tc["parity"], ref["data"]["train/parity"])
    assert all(r["train_carried"]["step"] == 1 for r in port)
    assert tc["held"] and not any(r["train_carried"]["held"] for r in port[1:])


def test_train_guard_recovery_reshards_bit_exact(port):
    """``fail_and_recover([1, 4, 6])`` on every rank, then ``reshard_state``
    onto the run's shardings: each rank holds the blocks it held, bit for
    bit; rank 0's shards and parity equal a one-process guard's over the
    gathered state."""
    assert port[0]["train_launcher"]["one_process_equal"]
    for r in port:
        tl = r["train_launcher"]
        assert tl["blocks_equal"] and tl["same_mesh"] and tl["recovered_plain"] and tl["recovered_step"] == 2


# ---------------------------------------------------------------------------
# tests/test_coded_serve.py:249 on 8 gloo ranks
# ---------------------------------------------------------------------------


def test_coded_serve_mesh_8_ranks_sigkill(hosts):
    """8 ranks, the guard's Lagrange encode on an 8-wide ``hosts`` axis
    (K = 6, R = 2), rank 0's ProcessHostPool host 3 SIGKILLed mid-decode:
    recovered, tokens equal the unguarded run's on every rank,
    recoveries ≥ 1."""
    r0 = hosts[0]
    assert r0["got"] == r0["base"] and all(r["got"] == r0["got"] for r in hosts)
    assert r0["pool_alive"][3] is False and sum(r0["pool_alive"]) == 7
    for r in hosts:
        assert r["recoveries"] >= 1 and r["metric"] >= 1
        assert r["alive"] == [0, 1, 2, 4, 5, 6, 7] and r["faults"] == [(3, 2)]
        assert r["transport"] == "gloo_exchange" and r["kernels"] == "fused"


def test_coded_serve_mesh_8_ranks_rows_equal_the_reference_collective(hosts, tmp_path):
    r0 = hosts[0]
    assert r0["limbs"].shape[0] == H.HOSTS_K
    want = H.collective_rows(r0["limbs"], str(tmp_path))
    np.testing.assert_array_equal(r0["rows"], want)
    np.testing.assert_array_equal(r0["rows"], r0["single"])


# ---------------------------------------------------------------------------
# the limb helpers a meshed state goes through (one process)
# ---------------------------------------------------------------------------


def _mixed_state():
    g = torch.Generator().manual_seed(3)
    return {"a": torch.randn((5, 3), generator=g).to(torch.bfloat16), "b": torch.tensor([True, False, True]),
            "c": torch.arange(7, dtype=torch.int32), "d": 3, "e": torch.tensor(2.5), "f": torch.zeros((0, 2))}


def test_state_meta_equals_the_limbs_meta():
    st = _mixed_state()
    _, meta = state_to_limbs(st, "cpu")
    got = state_meta(st)
    assert (got.shapes, got.dtypes, got.sizes_u16, got.total) == (meta.shapes, meta.dtypes, meta.sizes_u16,
                                                                  meta.total)
    assert got.treedef == meta.treedef


@pytest.mark.parametrize("K", [1, 2, 3, 5, 7, 40])
def test_state_limb_row_is_a_row_of_the_shards(K):
    """Row j built alone equals row j of ``shard_state_limbs``; a row past
    the K-th is the LCC padding (zeros)."""
    st = _mixed_state()
    shards, _ = shard_state_limbs(st, K, "cpu")
    for j in range(K + 2):
        want = shards[j] if j < K else torch.zeros_like(shards[0])
        assert torch.equal(state_limb_row(st, K, j, "cpu"), want), j
