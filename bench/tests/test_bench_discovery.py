"""A configuration, a traffic mix or a metric is added by adding a file and an
entry of ``BENCHMARK.json``, a hand kernel by adding a file: the harness
finds each by its name, and no file that exists is edited."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest

from bench import harness, plugins
from bench import trace as tracing

FOLDERS = ("configs", "traffic", "entries", "payloads", "metrics", "kernels")


def digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "bench"
    for folder in FOLDERS:
        shutil.copytree(plugins.BENCH / folder, bench / folder, ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(bench)
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())

    # the new files
    config = json.loads((bench / "configs" / "dft64-ntt.json").read_text())
    config.update(name="dft16-ntt", code=dict(config["code"], K=16, N=16), payload={"kind": "residues",
                                                                                   "elements_per_node": 300})
    (bench / "configs" / "dft16-ntt.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "a2a_encode.json").read_text())
    (bench / "traffic" / "one_payload.json").write_text(json.dumps(dict(mix, payloads=1, warmup_calls=1)))
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return run.completed / run.window_s\n")
    (bench / "kernels" / "shoot_rounds.json").write_text(json.dumps({"trace_names": ["shoot_rounds"]}))

    # the new entries
    spec["configs"].append({"name": "dft16-ntt", "source": "https://arxiv.org/abs/2205.05183",
                            "file": "bench/configs/dft16-ntt.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dft16.one", "config": "dft16-ntt", "traffic": "one_payload",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["dft16.one"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    r = harness.run_cell("dft16.one", 5, 0.2, False, t_start=time.perf_counter(), device="cpu",
                         root=tmp_path, bench_dir=bench, log=lambda *a: None)
    assert r["correct"], r["checks"]
    assert r["metrics"]["calls_per_s"]["value"] > 0 and r["metrics"]["calls_per_s"]["unit"] == "1/s"
    assert {"coded_GBps", "call_p95_ms", "setup_s"} <= set(r["metrics"])
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing that was there changed
    assert set(after) - set(before) == {"configs/dft16-ntt.json", "traffic/one_payload.json",
                                        "metrics/calls_per_s.py", "kernels/shoot_rounds.json"}

    # the new kernel is a hand kernel of every trace: out of eager_ms, into kernel_roofline
    hand = plugins.hand_kernel_names(plugins.hand_kernels(bench))
    assert set(hand) == {"gf_matmul", "butterfly_mac", "shoot_rounds"}
    t = tracing.summarize([(tracing.WINDOW, False, 0, 100), (tracing.CALL, False, 0, 100),
                           ("shoot_rounds_kernel", True, 10, 30), ("elementwise_kernel", True, 40, 50)], hand=hand)
    assert t.op_seconds(in_call=True, names=t.hand) == pytest.approx(20e-6)
    assert dict(t.top_ops())["hand_kernels: shoot_rounds_kernel"] == pytest.approx(20e-6)
    eager = plugins.load_module(bench, "metrics", "eager_ms")
    assert eager.read(harness.Run(harness.load_cell("dft16.one", root=tmp_path, bench_dir=bench),
                                  trace=t)) == pytest.approx(10e-3)

    # a metric another cell does not list is not read there
    cell = harness.load_cell("dft64.encode", root=tmp_path, bench_dir=bench)
    assert "calls_per_s" not in [m["name"] for m in cell.metrics("end_to_end")]


@pytest.mark.parametrize("name", ["../run", "a/b", "", "x" * 65, " a"])
def test_a_bad_name_is_refused(name):
    with pytest.raises(ValueError):
        plugins.load_module(plugins.BENCH, "metrics", name)


def test_a_missing_file_says_so():
    with pytest.raises(FileNotFoundError, match="no_such_metric"):
        plugins.load_module(plugins.BENCH, "metrics", "no_such_metric")


def test_every_name_in_the_benchmark_has_its_file():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert hasattr(plugins.load_module(plugins.BENCH, "metrics", m["name"]), "read"), m["name"]
    for c in spec["configs"]:
        config = json.loads((harness.ROOT / c["file"]).read_text())
        assert config["name"] == c["name"]
        plugins.load_module(plugins.BENCH, "payloads", config["payload"]["kind"])
    for w in spec["workloads"]:
        mix = plugins.read_json(plugins.BENCH, "traffic", w["traffic"])
        plugins.load_module(plugins.BENCH, "entries", mix["entry"])


def test_each_configuration_states_the_sizes_its_payload_makes():
    import math

    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        config = json.loads((harness.ROOT / c["file"]).read_text())
        payload = plugins.load_module(plugins.BENCH, "payloads", config["payload"]["kind"])
        S = payload.width(config)
        assert S == config["sizes"]["S"], c["name"]
        assert config["sizes"]["row_bytes_in"] == config["code"]["K"] * S * 4
        if "params" in config["payload"]:
            assert sum(math.prod(s) for _, s in config["payload"]["params"]) == config["sizes"]["parameters"]
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"])
        S = cell.config["sizes"]["S"]
        assert S % int(cell.traffic.get("call_columns", S)) == 0, w["name"]
