"""Each cell through its command, on the card: a short window, the result
line's keys, and ``correct``; and the command refuses a directory that holds
the benchmark without the program."""

import json
import os
import subprocess
import sys

import pytest

from bench import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def command(workload, trace, cwd=ROOT):
    args = [sys.executable, "-m", "bench.run", "--workload", workload, "--seed", str(2**31 + 17),
            "--seconds", "2", "--trace", str(trace)]
    return subprocess.run(args, capture_output=True, text=True, timeout=900, cwd=cwd)


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_and_is_correct(card, workload, trace):
    out = command(workload, trace)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    cell = harness.load_cell(workload, root=ROOT)
    want = {m["name"] for m in cell.metrics("per_layer" if trace else "end_to_end")}
    assert set(r["metrics"]) == want
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert len(r["breakdown"]["device_ops"]) <= 10 and len(r["breakdown"]["idle_gaps"]) <= 10
        for name in ("encode_mfu", "kernel_roofline"):
            if name in r["metrics"]:
                assert 0 < r["metrics"][name]["value"] <= 100


@pytest.mark.chip
def test_the_benchmark_alone_does_not_run(card, tmp_path):
    (tmp_path / "BENCHMARK.json").write_bytes((ROOT / "BENCHMARK.json").read_bytes())
    os.symlink(ROOT / "bench", tmp_path / "bench")
    out = command(CELLS[0], 0, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
