"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the program. Top-level module names are compared whole:
``repro_torch`` begins with ``repro`` and is not it."""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from bench import plugins
from bench.run import FORBIDDEN

BENCH = plugins.BENCH
ROOT = BENCH.parent


def top_level_imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                tops.add(arg.value.split(".")[0])
    return tops


def sources(folder: Path):
    return [p for p in sorted(folder.rglob("*.py")) if "tests" not in p.relative_to(BENCH).parts]


@pytest.mark.parametrize("path", sources(BENCH), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sources(BENCH / "reference"), ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    tops = top_level_imports(path)
    assert "repro_torch" not in tops and "bench" not in tops, tops  # its own modules are relative


def test_names_are_compared_whole():
    assert "repro" in FORBIDDEN and "repro_torch" not in FORBIDDEN
    tree = ast.parse("import repro_torch.core\nfrom jaxtyping import x\nimport repro.core")
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    assert names & set(FORBIDDEN) == {"repro"}


def fresh(code: str):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + str(ROOT)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True,
                          env=env, timeout=600, cwd=ROOT)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = fresh("""
        import json, sys, time
        from bench import harness, run
        from bench.tests.small import SMALL
        for w in sorted(SMALL):
            r = harness.run_cell(w, 11, 0.1, False, t_start=time.perf_counter(), device="cpu",
                                 overrides=SMALL[w], log=lambda *a: None)
            assert r["correct"], (w, r["checks"])
        import bench.control
        print(json.dumps(run.forbidden_modules()))
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules} & {"repro_torch", "torch"})))
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    found, loaded = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert found == []
    assert loaded == ["repro_torch", "torch"]


def test_the_command_refuses_to_run_without_a_card_or_without_the_program(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = [sys.executable, "-m", "bench.run", "--workload", "rs8.encode", "--seed", "1", "--seconds", "1"]
    out = subprocess.run(args, capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == "", out.stdout
    # a directory with BENCHMARK.json and the benchmark alone
    (tmp_path / "BENCHMARK.json").write_bytes((ROOT / "BENCHMARK.json").read_bytes())
    os.symlink(BENCH, tmp_path / "bench")
    out = subprocess.run(args, capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
