"""Differential tests of the rank executor's topology-aligned and
kernel-mode forms on the CPU, over 8 spawned gloo ranks.

One JAX child with 8 forced host devices runs the reference's mesh executors
on the cases of ``tests/test_hierarchical.py:37-200`` (``hierarchical_encode_jit``
on 4×2 and 2×4 meshes and ``multilevel_encode_jit`` on 2×2×2, both fields,
random, Vandermonde and DFT generators, p = 1 and 2, and the flat
``ps_encode_jit`` on the same packets) and of ``tests/test_fused_encode.py:300-420``
(every reference kernel mode — ``jnp``, ``fused`` and ``pallas`` in interpret
mode — with and without the pipeline pass, and the pipelined permutation
budgets). Each test function spawns the ranks once; every rank runs its
processor's program in each CPU kernel mode of the port (``torch`` and
``fused``; ``cuda`` runs on the card, in ``chip_smoke.py``). Blocks must equal
the reference's rows, tolerance 0, and every rank must run exactly the
committed permutation budget.
"""

import numpy as np
import pytest

import torch_ranks_harness as h
from repro.core.prepare_shoot import encode_oracle

HIER = [n for n in h.CASES if n.startswith("hier_")]
MULTI = [n for n in h.CASES if n.startswith("ml_")] + ["flat_ps", "flat_hier", "flat_ml"]
MODES = [n for n in h.CASES if n.startswith("modes_")]
BUDGETS = [n for n in h.CASES if n.startswith("budget_")]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = h.reference_outputs(str(tmp_path_factory.mktemp("ranks_hier_ref")), HIER + MULTI + MODES + BUDGETS)
    return path, dict(np.load(path))


def _check(results, r, names):
    for name in names:
        spec = h.CASES[name]
        outs = [r[f"{name}/out@{kern}"] for kern in spec["ref_kernels"]]
        assert all(np.array_equal(o, outs[0]) for o in outs), name  # the reference's modes agree
        if spec["gen"] is not None:
            x = r[f"{name}/x"].astype(np.uint64)
            assert np.array_equal(outs[0].astype(np.uint64), encode_oracle(x, r[f"{name}/A"], spec["q"])), name
        for mode in h.CPU_MODES:
            rows = {}
            for res in results:
                k, block, permutes, budget, transport = res[(name, mode)]
                assert permutes == budget and transport == "gloo_exchange", (name, mode, permutes, budget)
                rows[k] = block[0]
            got = np.stack([rows[k] for k in range(8)])
            assert np.array_equal(got, outs[0]), (name, mode)


def test_hierarchical_equals_the_reference_on_8_ranks(ref):
    path, r = ref
    _check(h.run_ranks(8, "port_cases", path, HIER, h.CPU_MODES), r, HIER)


def test_multilevel_and_flat_equal_the_reference_on_8_ranks(ref):
    path, r = ref
    _check(h.run_ranks(8, "port_cases", path, MULTI, h.CPU_MODES), r, MULTI)
    # the same packets through the flat, two-level and three-level schedules
    assert np.array_equal(r["flat_ps/out@None"], r["flat_hier/out@None"])
    assert np.array_equal(r["flat_ps/out@None"], r["flat_ml/out@None"])


def test_every_kernel_mode_and_pipeline_equals_the_reference_on_8_ranks(ref):
    path, r = ref
    _check(h.run_ranks(8, "port_cases", path, MODES + BUDGETS, h.CPU_MODES), r, MODES + BUDGETS)
