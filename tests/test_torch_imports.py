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
        "tree", "coded", "coded.rs_checkpoint", "coded.lagrange_compute", "coded.gradient_coding",
        "train", "train.checkpoint", "train.elastic", "serve", "serve.coded",
        "configs", "configs.base", "configs.registry", "configs.qwen3_1_7b", "models", "models.layers",
        "models.mla", "models.ssm", "models.model", "models.inputs", "train.train_loop", "serve.scheduler",
        "serve.traffic", "serve.engine",
        "launch", "launch.serve", "train.optimizer", "train.data", "launch.train", "dist.ranks", "launch.mesh",
        "dist.sharding", "launch.roofline", "launch.rules", "launch.profiles",
        "launch.op_cost", "launch.costpass", "launch.dryrun", "launch.hillclimb", "launch.perf_report",
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


@pytest.mark.parametrize(
    "order", ["kernels-first", "core-first", "dist-first", "topo-first", "obs-first", "coded-first", "serve-first",
              "models-first", "configs-first", "launch-first", "train-first", "sharding-first", "profiles-first"]
)
def test_import_order_does_not_matter(order):
    first = {
        "kernels-first": "repro_torch.kernels.gf_matmul.ops",
        "core-first": "repro_torch.core.encode",
        "dist-first": "repro_torch.dist.collectives",
        "topo-first": "repro_torch.topo",
        "obs-first": "repro_torch.obs",
        "coded-first": "repro_torch.coded",
        "serve-first": "repro_torch.serve",
        "models-first": "repro_torch.models",
        "configs-first": "repro_torch.configs",
        "launch-first": "repro_torch.launch.serve",
        "train-first": "repro_torch.launch.train",
        "sharding-first": "repro_torch.dist.sharding",
        "profiles-first": "repro_torch.launch.profiles",
    }[order]
    r = run_fresh(f"""
        import importlib
        importlib.import_module({first!r})
        import repro_torch.kernels.butterfly.ops, repro_torch.core, repro_torch.dist, repro_torch.convert
        import repro_torch.topo, repro_torch.obs, repro_torch.coded, repro_torch.train, repro_torch.serve
        import repro_torch.configs, repro_torch.models, repro_torch.launch.serve, repro_torch.launch.train
        import repro_torch.dist.sharding, repro_torch.launch.profiles, repro_torch.launch.roofline
        print("ok")
    """)
    assert r.returncode == 0, r.stdout + r.stderr


SCRIPTS = [f"examples/{name}_torch.py" for name in
           ("quickstart", "coded_checkpoint_recovery", "topology_planner", "serve_lm", "train_lm")] + [
    "tools/trace_encode_torch.py"]


def test_examples_and_tools_import_without_jax_or_the_jax_package():
    """Every example of the port and its trace tool load as modules (their
    ``main`` does not run) without JAX or the JAX package, and the spec
    functions the dry run uses are where the reference keeps them."""
    r = run_fresh(f"""
        import importlib.util, sys
        for path in {SCRIPTS!r}:
            spec = importlib.util.spec_from_file_location(path.split("/")[-1][:-3], path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            assert callable(mod.main), path
        from repro_torch.models import decode_input_specs, train_batch_specs
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print("loaded", len({SCRIPTS!r}))
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "loaded 6" in r.stdout


def test_scripts_without_device_need_a_card():
    """Without ``--device`` an example (and the trace tool) runs on the card:
    here, with no card, each stops with the card's error instead of running
    on the CPU. (The topology planner computes nothing on a device.)"""
    scripts = [s for s in SCRIPTS if "topology_planner" not in s]
    r = run_fresh(f"""
        import importlib.util, os, torch
        for path in {scripts!r}:
            spec = importlib.util.spec_from_file_location(path.split("/")[-1][:-3], path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            argv = ["--smoke", "--steps", "1", "--ckpt", os.devnull] if "train_lm" in path else []
            try:
                mod.main(argv)
            except RuntimeError as e:
                assert not torch.cuda.is_available() and "torch.cuda.is_available() is False" in str(e), e
            else:
                assert torch.cuda.is_available(), path + " ran without a card"
        print("checked", len({scripts!r}))
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "checked 5" in r.stdout


def test_sources_name_no_jax_import():
    import re

    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\b|from repro\.)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")] + [os.path.join(REPO, s) for s in SCRIPTS]
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
    "state_to_limbs": "state_to_limbs({'a': torch.zeros(3)})",
    "shard_state_limbs": "shard_state_limbs({'a': torch.zeros(3)}, 4)",
    "encode_parity": "encode_parity(x, build_parity_plan(8))",
    "encode_parity_collective": "encode_parity_collective(build_parity_plan(8), (2, 4))",
    "lcc_encode": "lcc_encode(build_lcc(8), x)",
    "lcc_encode_collective": "lcc_encode_collective(build_lcc(6, R=2))",
    "CodedStateGuard": "CodedStateGuard(K=4)",
    "CodedServeGuard": "CodedServeGuard(K=3, R=1)",
    "restore_checkpoint": "restore_checkpoint((save_checkpoint((d := tempfile.TemporaryDirectory()).name, "
                          "{'a': torch.zeros(1)}, 0), d.name)[1], {'a': torch.zeros(1)})",
    "state_from_reference": "state_from_reference({'a': np.zeros(3)})",
    "make_batch": "make_batch(smoke_config('qwen3-1.7b'), 1, 4)",
    "init_cache": "build_model(smoke_config('qwen3-1.7b')).init_cache(1, 8)",
    "params_from_reference": "params_from_reference((m := build_model(smoke_config('qwen3-1.7b'))).param_specs(), m)",
    "launch.serve": "serve_main(['--arch', 'qwen3-1.7b', '--smoke'])",
    "launch.train": "train_main(['--arch', 'qwen3-1.7b', '--smoke', '--steps', '1'])",
    "Prefetcher": "Prefetcher(SyntheticLM(smoke_config('qwen3-1.7b')), 1, 4)",
    "train_state_from_reference": "train_state_from_reference({'params': (m := build_model(smoke_config("
                                  "'qwen3-1.7b'))).param_specs(), 'opt': state_specs(OptConfig(), m.param_specs())}, "
                                  "m, OptConfig())",
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_with_device_none_raises_without_a_card(name):
    """``device=None`` means the card. On a machine without one the call
    raises; it does not quietly run on the CPU. (On a machine with a card the
    same call succeeds, and the check is that it ran there.)"""
    r = run_fresh(f"""
        import tempfile
        import numpy as np, torch
        from repro_torch import a2a_encode, plan_for, ir_encode, ps_encode, butterfly, M31
        from repro_torch.dist import allgather_encode, hierarchical_encode, multilevel_encode
        from repro_torch.kernels.gf_matmul.ops import encode_direct
        from repro_torch.configs import smoke_config
        from repro_torch.convert import params_from_reference, state_from_reference, to_tensor
        from repro_torch.convert import train_state_from_reference
        from repro_torch.launch.serve import main as serve_main
        from repro_torch.launch.train import main as train_main
        from repro_torch.models import build_model, make_batch
        from repro_torch.coded import (build_lcc, build_parity_plan, encode_parity, encode_parity_collective,
                                       lcc_encode, lcc_encode_collective, shard_state_limbs, state_to_limbs)
        from repro_torch.serve import CodedServeGuard
        from repro_torch.train import CodedStateGuard, restore_checkpoint, save_checkpoint
        from repro_torch.train import OptConfig, Prefetcher, SyntheticLM, state_specs
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
