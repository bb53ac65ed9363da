"""The dry run on a mesh of ranks: collectives counted on a fake world over
``meta`` tensors (``repro_torch.dist.counting``), the differential pass
(``launch.costpass``), the roofline's collective term and the hill-climb's.

Each world runs in a process of its own (``torch_dryrun_mesh_harness``),
side by side: four gloo ranks on CPU tensors, a fake world of four on
``meta`` blocks, and fake worlds of 256 and 512 ranks at full width. Each
waits under ``DEADLINE_S`` (300 s); alone on an 8-core CPU machine with no
other load they took, in seconds: the gloo ranks 46.1, the fake world's
families 31.0 and cases 41.3, the 256-rank world 7.6, the 512-rank 24.6.

* (a) The fake count equals the real one: the float32 smoke config of each
  family (dense, MoE, MLA, Mamba, RWKV6, Whisper, InternVL2), one decode
  tick and one train step on a (data=2, model=2) mesh, counted by
  ``CollectiveCounter`` on the fake world (rank 0) and on four real gloo
  ranks: rank 0's calls per op equal in count and in input and output
  bytes; every rank's in count.
* (b) The differential pass (repeats 1 and 2, ``collectives_corrected``)
  equals the count of the whole depth, per op, in count and bytes — but for
  one difference, stated in ``INEXACT``: a train step's reduce-scatter bytes
  where DTensor scatters the gradient's pending sum in the global norm
  along a dim it picks by divisibility, the stacked layers' among them.
* (c) The records have the reference's form (``mesh``, ``n_chips`` 256 and
  512, ``collectives`` under the reference's op names, their bytes' sum).
* (d) is a case of ``tests/test_torch_analysis.py::
  test_analyze_reads_the_record_as_the_reference_does``.
* (e) Qwen3-1.7B at full width on both production meshes through the dry
  run, the cost pass and ``hillclimb --multi-pod``: a nonzero collective
  term, which a lever that changes the rules (``dp_only``) changes.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import pytest

import torch_dryrun_mesh_harness as H
from repro.launch import perf_report as r_perf_report
from repro_torch.dist.counting import OP_NAMES, collectives_of
from repro_torch.launch import perf_report, roofline
from repro_torch.launch.mesh import PRODUCTION_MESHES
from torch_ranks_harness import run_ranks

DEADLINE_S = 300.0
REFERENCE_OPS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"}
# (b): the one difference from the whole count, and how far it may go
INEXACT = {"mamba-train": ("reduce-scatter", 0.15)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's results: the fake ones in spawned processes while the
    four gloo ranks run."""
    d256, d512 = (str(tmp_path_factory.mktemp(n)) for n in ("pod16x16", "pod2x16x16"))
    with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn")) as pool:
        fams = pool.submit(H.fake_main, "families")
        cases = pool.submit(H.fake_main, "cases")
        p256 = pool.submit(H.production_main, d256, False)
        p512 = pool.submit(H.production_main, d512, True)
        real = run_ranks(4, "torch_dryrun_mesh_harness:real_counts", deadline=DEADLINE_S)
        return {"families": fams.result(DEADLINE_S), "cases": cases.result(DEADLINE_S), "real": real,
                "pod16x16": p256.result(DEADLINE_S), "pod2x16x16": p512.result(DEADLINE_S)}


# ---------------------------------------------------------------------------
# the counter's names and bytes, in this process
# ---------------------------------------------------------------------------


def test_calls_map_to_the_reference_ops():
    calls = {"all_gather_into_tensor": {"count": 2, "input_bytes": 8, "output_bytes": 32},
             "all_reduce": {"count": 1, "input_bytes": 16, "output_bytes": 16},
             "all_to_all_single": {"count": 1, "input_bytes": 4, "output_bytes": 4},
             "reduce_scatter_tensor": {"count": 3, "input_bytes": 48, "output_bytes": 12},
             "send": {"count": 1, "input_bytes": 64, "output_bytes": 0},
             "recv": {"count": 1, "input_bytes": 0, "output_bytes": 64}}
    assert collectives_of(calls) == {
        "all-gather": {"count": 2, "bytes": 32}, "all-reduce": {"count": 1, "bytes": 16},
        "all-to-all": {"count": 1, "bytes": 4}, "reduce-scatter": {"count": 3, "bytes": 12},
        "collective-permute": {"count": 1, "bytes": 64}}
    assert {v for v in OP_NAMES.values() if v} - {"broadcast"} == REFERENCE_OPS


# ---------------------------------------------------------------------------
# (a) the fake world counts what four gloo ranks issue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what", sorted(H.SHAPES))
@pytest.mark.parametrize("fam", sorted(H.FAMILIES))
def test_fake_count_equals_the_real_count(worlds, fam, what):
    """Rank 0's calls equal in count and bytes; every other rank makes as
    many calls, of at most rank 0's bytes (an uneven split gives rank 0 the
    largest block: its count is the per-device figure)."""
    fake = worlds["families"][fam][what]
    assert fake and set(fake) <= set(OP_NAMES)
    assert worlds["real"][0][fam][what] == fake
    for rank, real in enumerate(worlds["real"][1:], 1):
        got = real[fam][what]
        assert {k: v["count"] for k, v in got.items()} == {k: v["count"] for k, v in fake.items()}, f"rank {rank}"
        for k, v in got.items():
            assert v["input_bytes"] <= fake[k]["input_bytes"] and v["output_bytes"] <= fake[k]["output_bytes"], rank


def test_the_regions_own_all_reduce_is_counted(worlds):
    """The recurrent mixers sum inside their regions (``dist._compat.all_reduce``,
    a plain ``torch.distributed.all_reduce``): counted on both sides."""
    for fam in ("mamba", "rwkv6"):
        assert worlds["families"][fam]["tick"].get("all_reduce", {}).get("count", 0) > 0, fam


# ---------------------------------------------------------------------------
# (b) the differential pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(H.CASES))
def test_differential_pass_equals_the_whole_count(worlds, case):
    got = worlds["cases"][case]
    assert got["method"].startswith("repeats 1,2->") and got["R"] >= 3
    corrected, whole = got["corrected"], got["whole"]
    assert set(corrected) == set(whole)
    inexact_op, rel = INEXACT.get(case, (None, 0.0))
    for op, c in corrected.items():
        assert c["bytes"] == c["base"] + (got["R"] - 1) * c["per_layer"]
        assert c["count"] == whole[op]["count"], op
        if op == inexact_op:
            assert c["bytes"] == pytest.approx(whole[op]["bytes"], rel=rel), op
        else:
            assert c["bytes"] == whole[op]["bytes"], op
    m, mw = got["memory"], got["memory_whole"]
    assert (m["argument_bytes"], m["output_bytes"]) == (mw["argument_bytes"], mw["output_bytes"])


# ---------------------------------------------------------------------------
# (c), (e) the production meshes at full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", sorted(PRODUCTION_MESHES))
def test_record_has_the_reference_form(worlds, tag):
    rec = worlds[tag]["raw"]
    assert rec["status"] == "ok" and rec["mesh"] == tag and rec["n_chips"] == (512 if PRODUCTION_MESHES[tag] else 256)
    assert set(rec["collectives"]) <= REFERENCE_OPS and rec["collectives"]
    assert all(set(c) == {"count", "bytes"} and c["count"] > 0 for c in rec["collectives"].values())
    assert rec["collective_bytes_per_device"] == sum(c["bytes"] for c in rec["collectives"].values()) > 0
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "peak_bytes", "temp_bytes"}
    # a device's blocks: the weights and the 32k cache over the ranks, not whole
    assert rec["memory"]["argument_bytes"] < (rec["param_bytes"] + rec["cache_bytes"]) / rec["n_chips"] * 1.1
    assert rec["fits"] == (rec["memory"]["peak_bytes"] <= 80e9)


@pytest.mark.parametrize("tag", sorted(PRODUCTION_MESHES))
def test_costpass_corrects_the_count_over_depth(worlds, tag):
    raw, rec = worlds[tag]["raw"], worlds[tag]["corrected"]
    corr = rec["collectives_corrected"]
    assert set(corr) == set(raw["collectives"]) and rec["collective_method"] == "repeats 1,2->28"
    for op, c in corr.items():
        assert set(c) == {"bytes", "base", "per_layer", "count"}
        assert c["base"] == raw["collectives"][op]["bytes"]  # the dry run counts the body once
        assert c["bytes"] == c["base"] + 27 * c["per_layer"]
    assert rec["collective_bytes_per_device_corrected"] == sum(max(c["bytes"], 0) for c in corr.values())
    assert rec["collective_bytes_per_device_corrected"] > raw["collective_bytes_per_device"]


@pytest.mark.parametrize("tag", sorted(PRODUCTION_MESHES))
def test_roofline_prices_the_corrected_bytes(worlds, tag):
    rec = worlds[tag]["corrected"]
    row = roofline.analyze(rec)
    assert row.mesh == tag and row.status == "ok"
    assert row.collective_s == rec["collective_bytes_per_device_corrected"] / (roofline.P_LINKS * roofline.NVLINK_BW)
    assert row.compute_s == rec["op_cost"]["flops_global"] / rec["n_chips"] / roofline.PEAK_FLOPS
    raw = roofline.analyze(worlds[tag]["raw"])
    assert raw.collective_s == worlds[tag]["raw"]["collective_bytes_per_device"] / roofline.NVLINK_BW


def test_hillclimb_multi_pod_reports_the_collective_term(worlds):
    base, dp = worlds["pod2x16x16"]["hillclimb"]
    assert base["mesh"] == dp["mesh"] == "pod2x16x16"
    assert base["profile"] == "baseline" and dp["levers"]["dp_only"]
    assert base["collective_s"] > 0 and base["collective_gb_per_dev"] > 0
    assert base["collective_gb_per_dev"] == pytest.approx(sum(base["collective_by_op_gb"].values()), rel=1e-12)
    assert set(base["collective_by_op_gb"]) <= REFERENCE_OPS
    # the same bytes as the cost pass's, over the same NVLink rate
    rec = worlds["pod2x16x16"]["corrected"]
    assert base["collective_gb_per_dev"] * 1e9 == pytest.approx(rec["collective_bytes_per_device_corrected"], rel=1e-12)
    assert dp["collective_by_op_gb"] != base["collective_by_op_gb"]


def test_perf_report_renders_the_mesh_rows_as_the_reference_does(worlds, tmp_path):
    import json

    path = tmp_path / "log.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in worlds["pod2x16x16"]["hillclimb"]))
    text = perf_report.render(str(path))
    assert text == r_perf_report.render(str(path))
    assert "qwen3-1.7b×decode_32k×pod2x16x16" in text
