"""The port stands alone: ``repro_torch`` and ``chip_smoke`` import neither
JAX nor the JAX package, and the port's entry points refuse to run when there
is no CUDA device instead of carrying on on the CPU.

Each check runs in a fresh interpreter (this test process itself has JAX
loaded by the other test files).
"""

import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run_fresh(code: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = SRC + os.pathsep + REPO
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True,
                          env=env, timeout=300, cwd=REPO)


def port_modules():
    import repro_torch

    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, prefix="repro_torch."):
        names.append(m.name)
    return sorted(names)


def test_the_slice_is_all_there():
    names = set(port_modules())
    for mod in [
        "core.field", "core.bounds", "core.matrices", "core.schedule", "core.ir", "core.simulator",
        "core.prepare_shoot", "core.draw_loose", "core.encode", "dist.collectives", "convert",
        "kernels._build", "kernels.gf_matmul.kernel", "kernels.gf_matmul.ops", "kernels.gf_matmul.ref",
        "kernels.butterfly.kernel", "kernels.butterfly.ops", "kernels.butterfly.ref",
        "topo", "topo.model", "topo.hierarchical", "topo.lower", "topo.passes", "topo.calibrate",
        "topo.autotune", "obs", "obs.trace", "obs.metrics", "obs.export", "obs.feed",
    ]:
        assert "repro_torch." + mod in names, mod
    for src in ("gf_matmul.cu", "butterfly_mac.cu"):
        assert os.path.isfile(os.path.join(SRC, "repro_torch", "csrc", src)), src


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = port_modules()
    r = run_fresh(f"""
        import importlib, sys
        for name in {mods!r}:
            importlib.import_module(name)
        import chip_smoke  # imported as a module: must not run
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        assert "torch" in sys.modules and "triton" not in sys.modules
        print("imported", len({mods!r}), "modules")
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "imported" in r.stdout


@pytest.mark.parametrize("order", ["kernels-first", "core-first", "dist-first", "topo-first", "obs-first"])
def test_import_order_does_not_matter(order):
    first = {
        "kernels-first": "repro_torch.kernels.gf_matmul.ops",
        "core-first": "repro_torch.core.encode",
        "dist-first": "repro_torch.dist.collectives",
        "topo-first": "repro_torch.topo",
        "obs-first": "repro_torch.obs",
    }[order]
    r = run_fresh(f"""
        import importlib
        importlib.import_module({first!r})
        import repro_torch.kernels.butterfly.ops, repro_torch.core, repro_torch.dist, repro_torch.convert
        import repro_torch.topo, repro_torch.obs
        print("ok")
    """)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_name_no_jax_import():
    import re

    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\b|from repro\.)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, fs in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path, encoding="utf-8") as fh:
            assert not pat.search(fh.read()), path


ENTRY_POINTS = {
    "a2a_encode": "a2a_encode(x, A)",
    "a2a_encode_plan": "a2a_encode(x, plan=plan_for('general', 8), A=A)",
    "ir_encode": "ir_encode(plan_for('general', 8).to_ir(A))",
    "ps_encode": "ps_encode(A)",
    "butterfly": "butterfly(8)",
    "allgather_encode": "allgather_encode(A)",
    "hierarchical_encode": "hierarchical_encode(A, k_intra=4)",
    "multilevel_encode": "multilevel_encode(A, (2, 2, 2))",
    "encode_direct": "encode_direct(x, A, q=M31)",
    "to_tensor": "to_tensor(x)",
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_with_device_none_raises_without_a_card(name):
    """``device=None`` means the card. On a machine without one the call
    raises; it does not quietly run on the CPU. (On a machine with a card the
    same call succeeds, and the check is that it ran there.)"""
    r = run_fresh(f"""
        import numpy as np, torch
        from repro_torch import a2a_encode, plan_for, ir_encode, ps_encode, butterfly, M31
        from repro_torch.dist import allgather_encode, hierarchical_encode, multilevel_encode
        from repro_torch.kernels.gf_matmul.ops import encode_direct
        from repro_torch.convert import to_tensor
        A = np.arange(64, dtype=np.uint32).reshape(8, 8)
        x = np.arange(24, dtype=np.uint32).reshape(8, 3)
        try:
            out = {ENTRY_POINTS[name]}
        except RuntimeError as e:
            assert not torch.cuda.is_available(), e
            assert "cuda" in str(e).lower(), e
            print("raised")
        else:
            assert torch.cuda.is_available(), "ran without a card"
            print("ran on the card")
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert ("raised" in r.stdout) or ("ran on the card" in r.stdout)


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    r = run_fresh("""
        import subprocess, sys, torch
        if torch.cuda.is_available():
            print("card present: not checked here")
        else:
            r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True, timeout=280)
            assert r.returncode != 0, r.stdout
            assert '"ok"' not in r.stdout, r.stdout
            print("refused")
    """)
    assert r.returncode == 0, r.stdout + r.stderr
