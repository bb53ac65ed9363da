"""Differential tests of the rank executor (``repro_torch.dist.ranks``) and the
rank mesh (``repro_torch.launch.mesh``) on the CPU, over spawned gloo ranks.

One JAX child with 8 forced host devices runs the reference's mesh executors
on the cases of ``tests/test_distributed.py:31-170`` (prepare-and-shoot p = 1
and 2, the all-gather baseline, the butterfly and its inverse, the coded
checkpoint's parity) plus the LCC encode at N = 8 and two encodes over one
axis of a 4×2 mesh (side by side, one per coordinate of the other axis),
and the traced runs of
``tests/test_obs.py:263-310`` and of ``test_fused_encode.py``'s pipelined
trace; it writes inputs, outputs and span records to an ``.npz``. Each test
function then spawns 8 (or 4) gloo ranks once (``torch_ranks_harness``), each
running its processor's program on its own block in every CPU kernel mode.
Every rank's block must equal the reference's row for that processor,
tolerance 0, and every rank must run exactly the permutation budget.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_ranks_harness as h
from repro.core.field import M31, Field
from repro.core import ir as rir
from repro.core.matrices import random_vector
from repro.core.prepare_shoot import encode_oracle
from repro.core.simulator import interpret as ref_interpret
from repro_torch.coded.rs_checkpoint import build_parity_plan, recover_lost
from repro_torch.convert import to_numpy
from repro_torch.core import ir as pir
from repro_torch.dist.collectives import ir_encode
from repro_torch.launch.mesh import RankMesh, mesh_encode_levels, production_topology, topology_for_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["ps_p1", "ps_p2", "allgather", "butterfly", "butterfly_inverse", "parity", "parity_2x2x2", "lcc_8",
         "ps_inter_of_4x2", "allgather_intra_of_4x2"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = h.reference_outputs(str(tmp_path_factory.mktemp("ranks_ref")), NAMES, traced=True, orders=True)
    with open(path + ".json") as fh:
        spans = json.load(fh)
    return path, dict(np.load(path)), spans


def _assemble(results, name, mode):
    """The (K, *payload) output the ranks computed, row k from processor k
    (ranks that differ on the other mesh axes compute the same row)."""
    rows = {}
    for res in results:
        k, block, permutes, budget, _ = res[(name, mode)]
        assert block.shape[0] == 1
        if k in rows:
            assert np.array_equal(rows[k], block[0]), (name, mode, k)
        rows[k] = block[0]
    K = h.processors(h.CASES[name])
    assert sorted(rows) == list(range(K))
    return np.stack([rows[k] for k in range(K)])


def test_distributed_cases_equal_the_reference_on_8_ranks(ref):
    path, r, _ = ref
    results = h.run_ranks(8, "port_cases", path, NAMES, h.CPU_MODES)
    for name in NAMES:
        spec = h.CASES[name]
        want = r[f"{name}/out@None"]
        if spec["gen"] is not None and spec["kind"] in ("ps", "allgather"):
            x = r[f"{name}/x"].astype(np.uint64)
            assert np.array_equal(want.astype(np.uint64), encode_oracle(x, r[f"{name}/A"], spec["q"]))
        for mode in (h.CPU_MODES if spec["kind"] != "allgather" else ("plain",)):
            got = _assemble(results, name, mode)
            assert got.dtype == np.uint32 and np.array_equal(got, want), (name, mode)
            for res in results:
                _, _, permutes, budget, transport = res[(name, mode)]
                if budget is not None:  # every rank ran exactly the committed budget
                    assert permutes == budget, (name, mode, permutes, budget)
                    assert transport == "gloo_exchange"
                else:
                    assert transport == "all_gather_into_tensor"
    # the butterfly's inverse gives x back; the parity recovers lost shards bit for bit
    assert np.array_equal(r["butterfly_inverse/out@None"], r["butterfly/x"])
    plan = build_parity_plan(8, p=1)
    shards = r["parity/x"]
    parity = _assemble(results, "parity", "fused").astype(np.uint64)
    lost = [1, 6]
    rec = recover_lost(plan, lost, {k: shards[k].astype(np.uint64) for k in range(8) if k not in lost},
                       {k: parity[k] for k in range(8) if k not in lost})
    for k in lost:
        assert np.array_equal(rec[k], shards[k].astype(np.uint64))


def test_traced_ranks_one_span_per_round_on_every_rank(ref, tmp_path):
    path, r, ref_spans = ref
    results = h.run_ranks(8, "port_traced", path, str(tmp_path))
    for name in h.TRACED:
        budget = ref_spans[name]["counters"]["encode.ppermutes"]
        want_spans = ref_spans[name]["spans"]
        rows = {}
        for rank, res in enumerate(results):
            e = res[name]
            rows[e["k"]] = e["outs"][0][0]
            assert np.array_equal(e["outs"][0], e["outs"][1]) and np.array_equal(e["outs"][0], e["plain"])
            assert e["permutes"] == budget
            # two calls: the reference's one-call span records twice over, ids shifted
            one = len(want_spans)
            assert len(e["spans"]) == 2 * one
            for c in range(2):
                mine = e["spans"][c * one:(c + 1) * one]
                for got, want in zip(mine, want_spans):
                    shift = c * one
                    assert got["name"] == want["name"] and got["attrs"] == want["attrs"], (name, rank)
                    assert got["parent"] == (None if want["parent"] is None else want["parent"] + shift)
            comm = [s for s in e["spans"] if "comm_round" in s["attrs"]]
            assert len(comm) == 2 * 3 and [s["attrs"]["level"] for s in comm] == [0, 1, 2] * 2
            assert sum(s["attrs"]["ppermutes"] for s in comm) == 2 * budget
            assert all(d > 0 for d in e["durations"])
            assert e["counters"] == {k: 2 * v for k, v in ref_spans[name]["counters"].items()}
            assert e["hist_counts"] == {k: 2 * v for k, v in ref_spans[name]["hist_counts"].items()}
            if rank == 0:
                assert e["calibration"] == (True, 3)
        got = np.stack([rows[k] for k in range(8)])
        assert np.array_equal(got, r[f"{name}/out"]), name
        x = r[f"{name}/x"].astype(np.uint64)
        assert np.array_equal(got.astype(np.uint64), encode_oracle(x, r[f"{name}/A"], M31))
    overlapped = [s for s in results[0]["traced_pipelined"]["spans"] if s["attrs"].get("overlap")]
    assert overlapped and all(s["attrs"]["overlap_out_slots"] > 0 for s in overlapped)
    trace = results[0]["traced_pipelined"]["trace"]
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "check_trace.py"), trace],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("shape,names,axes_list", h.MESH_ORDERS, ids=[str(m[0]) for m in h.MESH_ORDERS])
def test_rank_mesh_index_is_the_reference_sharding_order(ref, shape, names, axes_list):
    """Rank r at coordinates unravel(r, shape) holds, over ``axes``, the row
    that the reference's ``P(axes)`` gives the device at that mesh position;
    ``peer`` inverts it among the ranks that share the other coordinates."""
    _, r, _ = ref
    n = int(np.prod(shape))
    for axes in axes_list:
        want = r[f"order/{shape}/{names}/{axes}"]
        for rank in range(n):
            coords = tuple(int(c) for c in np.unravel_index(rank, shape))
            mesh = RankMesh(None, shape, names, rank, coords, tuple(range(n)), None)
            k = mesh.index(axes)
            assert k == want[coords], (axes, rank)
            assert mesh.peer(axes, k) == rank
            for j in range(mesh.size(axes)):
                other = mesh.peer(axes, j)
                o_coords = np.unravel_index(other, shape)
                assert want[o_coords] == j
                fixed = [d for d in range(len(shape)) if names[d] not in axes]
                assert all(o_coords[d] == coords[d] for d in fixed)


def test_mesh_topology_helpers_equal_the_reference():
    from repro.launch import mesh as rmesh

    mesh = RankMesh(None, (2, 4, 2), ("pod", "slice", "chip"), 0, (0, 0, 0), tuple(range(16)), None)
    assert mesh_encode_levels(mesh, ("pod", "slice", "chip")) == (2, 4, 2)
    assert mesh_encode_levels(mesh, ("slice", "chip")) == (2, 4)
    assert topology_for_mesh(mesh, ("pod", "slice", "chip")).levels == (2, 4, 2)
    for multi in (False, True):
        assert production_topology(multi_pod=multi).levels == rmesh.production_topology(multi_pod=multi).levels
    with pytest.raises(ValueError, match="not one of"):
        mesh.index(("rack",))


def test_partial_store_raises_and_partial_add_runs_on_4_ranks():
    """A store group that leaves a rank out raises the reference's error on
    every rank before any message; the hand-made IR (update/overlap LocalOps,
    {0,1} and zero rows, a partial add group into a missing slot) equals the
    one-card executor and the reference's interpreter."""
    f = Field(M31)
    x = random_vector(f, (4, 6), seed=1).astype(np.uint32)
    results = h.run_ranks(4, "port_semantics", x, h.CPU_MODES)
    for res in results:
        assert res["store_error"] == "store-mode port group must cover every device (got 3 of 4)"
    for update in (True, False):
        one_card = to_numpy(ir_encode(h.hand_made_ir(pir, update), q=M31, device="cpu")(x))
        for c in range(x.shape[1]):
            want, _ = ref_interpret(h.hand_made_ir(rir, update), x[:, c].astype(np.uint64), f)
            assert np.array_equal(one_card[:, c].astype(np.uint64), want)
        for mode in h.CPU_MODES:
            rows = {res["k"]: res[(update, mode)] for res in results}
            got = np.concatenate([rows[k][0] for k in range(4)])
            assert np.array_equal(got, one_card), (update, mode)
            assert all(rows[k][1] == rows[k][2] == 2 for k in range(4))


def test_a_rank_that_raises_fails_the_run_within_its_deadline(ref):
    path, _, _ = ref
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="injected fault on rank 2"):
        h.run_ranks(8, "port_faulty", path, deadline=60)
    assert time.monotonic() - t0 < 60


def test_a_backend_other_than_gloo_is_refused(monkeypatch):
    from repro_torch.dist import ranks

    monkeypatch.setattr(ranks.dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="ROADMAP A2"):
        ranks._check_backend(None)
