"""Differential tests of the port's topology-aligned encodes on the CPU:
``hierarchical_encode``, ``multilevel_encode``, the ``pipeline=`` argument of
every entry point, and the traced ``ir_encode(tracer=, topo=, metrics=)``.

Each output runs in modes ``"torch"`` and ``"fused"`` on ``device="cpu"`` and
must equal — tolerance 0 — the matrix oracle and the reference's ``interpret``
on the reference's own IR, for the same seeded numpy inputs; each
pass-rewritten IR must equal the reference's step by step; ``permutes_run``
must equal the reference's budget functions. One test forks a process with 8
forced host devices and runs the reference's mesh executors
(``hierarchical_encode_jit`` 4×2, ``multilevel_encode_jit`` 2×2×2, traced
``ir_encode_jit`` at K = 8); the port's outputs and span attributes (all but
times) must equal theirs.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core.field import M31, NTT, Field
from repro.core.matrices import (
    butterfly_target_matrix,
    dft_matrix,
    distinct_points,
    random_matrix,
    random_vector,
    vandermonde,
)
from repro.core.prepare_shoot import encode_oracle
from repro.core.schedule import plan_butterfly as r_plan_butterfly
from repro.core.schedule import plan_prepare_shoot as r_plan_prepare_shoot
from repro.core.simulator import interpret as r_interpret
from repro.dist import collectives as rc
from repro.topo import hierarchical as rh
from repro_torch.convert import to_numpy
from repro_torch.core.ir import LocalOp
from repro_torch.dist import collectives as pc
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.topo import FullyConnected, Hierarchy
from repro_torch.topo.passes import PIPELINES
from test_torch_plans import plans_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_MODES = ("torch", "fused")


def _gens(q: int, K: int):
    f = Field(q)
    gens = {"random": random_matrix(f, K, seed=K), "vandermonde": vandermonde(f, distinct_points(f, K, seed=1))}
    if (q - 1) % K == 0:
        gens["dft"] = dft_matrix(f, K)
    return gens


def _check_output(fn, r_ir, x, target, q):
    got = to_numpy(fn(x.astype(np.uint32))).astype(np.uint64)
    assert np.array_equal(got, encode_oracle(x, target, q))
    f = Field(q)
    flat_x, flat_got = x.reshape(x.shape[0], -1), got.reshape(x.shape[0], -1)
    for c in (0, flat_x.shape[1] - 1):  # the reference's interpreter on its own IR
        ref, _ = r_interpret(r_ir, flat_x[:, c], f)
        assert np.array_equal(flat_got[:, c], ref)


def _check_ir(p_ir, r_ir):
    assert len(p_ir.steps) == len(r_ir.steps) and plans_equal(p_ir, r_ir)


# test_topo.py's and test_hierarchical.py's factorizations
HIER = [(8, 2, 1), (8, 4, 1), (8, 4, 2), (12, 3, 1), (12, 4, 2), (16, 4, 1), (15, 3, 2)]
MULTI = [(8, (2, 2, 2), 1), (8, (2, 2, 2), 2), (12, (3, 2, 2), 1), (16, (2, 2, 2, 2), 1),
         (16, (4, 2, 2), 2), (24, (2, 3, 4), 1), (30, (5, 3, 2), 2)]


@pytest.mark.parametrize("mode", CPU_MODES)
@pytest.mark.parametrize("K,I,p", HIER)
def test_hierarchical_encode_equals_reference(K, I, p, mode):
    for q in (M31, NTT):
        for name, A in _gens(q, K).items():
            A = np.asarray(A)
            fn, plan = pc.hierarchical_encode(A, k_intra=I, p=p, q=q, device="cpu", kernels=mode)
            r_plan = rh.plan_hierarchical(K, p, I)
            r_ir = r_plan.to_ir(A, q=q)
            x = random_vector(Field(q), (K, 3), seed=K + p)
            _check_output(fn, r_ir, x, A, q)
            assert fn.permutes_run == pc.expected_hier_permute_count(plan) == rc.expected_hier_permute_count(r_plan)
    with pytest.raises(ValueError):
        pc.hierarchical_encode(np.zeros((8, 8)), k_intra=3, device="cpu")


@pytest.mark.parametrize("mode", CPU_MODES)
@pytest.mark.parametrize("K,levels,p", MULTI)
def test_multilevel_encode_equals_reference(K, levels, p, mode):
    sizes = tuple(reversed(levels))  # outermost first, as the reference's mesh axes
    for q in (M31, NTT):
        A = np.asarray(random_matrix(Field(q), K, seed=K + levels[0]))
        fn, plan = pc.multilevel_encode(A, sizes, p=p, q=q, device="cpu", kernels=mode)
        assert plan.levels == levels
        r_plan = rh.plan_multilevel(K, p, levels)
        x = random_vector(Field(q), (K, 2, 3), seed=p)
        _check_output(fn, r_plan.to_ir(A, q=q), x, A, q)
        assert fn.permutes_run == pc.expected_multilevel_permute_count(plan) == rc.expected_multilevel_permute_count(r_plan)
    with pytest.raises(ValueError, match="sizes"):
        pc.multilevel_encode(np.zeros((K, K)), (2, K), device="cpu")


def _entries():
    """(label, port entry, build the IR with a package's planners, target, q,
    the reference's budget): every entry point at K = 8 and 16."""
    from repro_torch.core.schedule import plan_butterfly as p_plan_butterfly
    from repro_torch.core.schedule import plan_prepare_shoot as p_plan_prepare_shoot
    from repro_torch.topo import hierarchical as ph

    out = []
    for K in (8, 16):
        A = np.asarray(random_matrix(Field(M31), K, seed=3 * K))
        lv = (2, 2, K // 4)
        out += [
            (f"ps-{K}", lambda pl, m, A=A: pc.ps_encode(A, device="cpu", kernels=m, pipeline=pl),
             lambda ref, A=A, K=K: (r_plan_prepare_shoot if ref else p_plan_prepare_shoot)(K, 1).to_ir(A),
             A, M31, rc.expected_permute_count(r_plan_prepare_shoot(K, 1))),
            (f"hier-{K}", lambda pl, m, A=A: pc.hierarchical_encode(A, k_intra=4, device="cpu", kernels=m, pipeline=pl),
             lambda ref, A=A, K=K: (rh if ref else ph).plan_hierarchical(K, 1, 4).to_ir(A),
             A, M31, rc.expected_hier_permute_count(rh.plan_hierarchical(K, 1, 4))),
            (f"multi-{K}", lambda pl, m, A=A, lv=lv: pc.multilevel_encode(A, lv[::-1], device="cpu", kernels=m, pipeline=pl),
             lambda ref, A=A, K=K, lv=lv: (rh if ref else ph).plan_multilevel(K, 1, lv).to_ir(A),
             A, M31, rc.expected_multilevel_permute_count(rh.plan_multilevel(K, 1, lv))),
            (f"butterfly-{K}", lambda pl, m, K=K: pc.butterfly(K, device="cpu", kernels=m, pipeline=pl),
             lambda ref, K=K: (r_plan_butterfly if ref else p_plan_butterfly)(K, 1, NTT).to_ir(),
             butterfly_target_matrix(Field(NTT), K, 2), NTT, r_plan_butterfly(K, 1, NTT).H),
        ]
    return out


def _applicable(entry) -> list[str]:
    """The registered pipelines that apply to the entry's IR on the flat
    fabric the dispatch prices on (decided with the reference's registry)."""
    from repro.topo import FullyConnected as RFullyConnected
    from repro.topo.passes import PIPELINES as R_PIPELINES

    r_ir = entry[2](True)
    return [n for n, pl in R_PIPELINES.items() if pl.applicable(r_ir, RFullyConnected(r_ir.K))]


ENTRIES = _entries()
PIPE_CASES = [(i, name) for i, e in enumerate(ENTRIES) for name in _applicable(e)]


def test_pipelines_that_apply_are_the_same_in_both_registries():
    assert list(PIPELINES) == ["remap-digits", "split-contended", "fuse-rounds",
                               "align-subgroups", "split+fuse", "pipeline"]
    for e in ENTRIES:
        p_ir = e[2](False)
        mine = [n for n, pl in PIPELINES.items() if pl.applicable(p_ir, FullyConnected(p_ir.K))]
        assert mine == _applicable(e), e[0]
    assert {n for _, n in PIPE_CASES} == {"fuse-rounds", "pipeline"}


@pytest.mark.parametrize("mode", CPU_MODES)
@pytest.mark.parametrize("idx,pipeline", PIPE_CASES,
                         ids=[f"{ENTRIES[i][0]}-{n}" for i, n in PIPE_CASES])
def test_pipeline_argument_equals_reference(idx, pipeline, mode):
    """The rewritten IR is the reference's ``_apply_pipeline`` output step by
    step, the output is exact, and the permutation count is within the
    reference's budget."""
    label, entry, build, target, q, budget = ENTRIES[idx]
    r_new = rc._apply_pipeline(build(True), pipeline)
    p_new = pc._apply_pipeline(build(False), pipeline)
    _check_ir(p_new, r_new)
    fn, _ = entry(pipeline, mode)
    x = random_vector(Field(q), (r_new.K, 5), seed=len(label))
    _check_output(fn, r_new, x, target, q)
    assert fn.permutes_run == fn.permute_count <= budget


# ---------------------------------------------------------------------------
# the traced path
# ---------------------------------------------------------------------------


def _traced(ir, x, q=M31, topo=None, mode="fused"):
    tracer, reg = Tracer(), MetricsRegistry()
    fn = pc.ir_encode(ir, q=q, device="cpu", kernels=mode, tracer=tracer, topo=topo, metrics=reg)
    return fn, fn(x), tracer, reg


def _span_records(spans):
    return [{k: v for k, v in s.to_dict().items() if k not in ("ts_us", "dur_us")} for s in spans]


@pytest.mark.parametrize("mode", CPU_MODES)
def test_traced_multilevel_one_span_per_round(mode):
    K, levels = 8, (2, 2, 2)
    f = Field(M31)
    A = np.asarray(vandermonde(f, distinct_points(f, K, seed=0)))
    fn_plain, plan = pc.multilevel_encode(A, levels[::-1], device="cpu", kernels=mode)
    ir = plan.to_ir(A)
    x = random_vector(f, (K, 32), seed=3).astype(np.uint32)
    want = fn_plain(x)
    fn, out, tracer, reg = _traced(ir, x, topo=Hierarchy(levels=levels), mode=mode)
    assert torch.equal(out, want) and fn.permutes_run == fn_plain.permutes_run
    roots = [s for s in tracer.spans if s.name == "ir_encode"]
    comm = [s for s in tracer.spans if "comm_round" in s.attrs]
    assert len(roots) == 1 and len(comm) == ir.c1 == 3
    assert [s.attrs["comm_round"] for s in comm] == [0, 1, 2]
    assert [s.attrs["level"] for s in comm] == [0, 1, 2]
    budget = pc.expected_multilevel_permute_count(plan)
    assert sum(s.attrs["ppermutes"] for s in comm) == budget
    for s in comm:
        assert s.parent == 0 and s.dur_us > 0
        for key in ("predicted_us", "level", "msgs", "elems", "transfers", "ppermutes", "payload_elems"):
            assert key in s.attrs, (s.name, key)
    snap = reg.snapshot()
    assert snap["encode.rounds"]["value"] == 3
    assert snap["encode.ppermutes"]["value"] == budget
    assert snap["encode.bytes_on_wire"]["value"] == sum(s.attrs["wire_slots"] for s in comm) * 32 * 4
    assert snap["encode.round_us{level=0}"]["count"] == 1


def test_traced_pipelined_encode_stamps_overlap_and_keeps_values():
    K = 16
    A = np.asarray(random_matrix(Field(M31), K, seed=5))
    fn_plain, plan = pc.ps_encode(A, device="cpu", pipeline="pipeline")
    ir = pc._apply_pipeline(plan.to_ir(A), "pipeline")
    n_overlap = sum(1 for s in ir.steps if isinstance(s, LocalOp) and s.overlap)
    assert n_overlap > 0
    x = random_vector(Field(M31), (K, 6), seed=1).astype(np.uint32)
    fn, out, tracer, reg = _traced(ir, x)
    assert torch.equal(out, fn_plain(x))
    assert np.array_equal(to_numpy(out).astype(np.uint64), encode_oracle(x.astype(np.uint64), A))
    stamped = [s for s in tracer.spans if s.attrs.get("overlap")]
    assert len(stamped) == n_overlap and all(s.attrs["overlap_out_slots"] > 0 for s in stamped)
    snap = reg.snapshot()
    assert sum(v["count"] for k, v in snap.items() if k.startswith("encode.round_us")) == ir.c1
    assert snap["encode.rounds"]["value"] == ir.c1


# ---------------------------------------------------------------------------
# one subprocess: the reference's mesh executors, plain and traced
# ---------------------------------------------------------------------------


def test_port_equals_reference_mesh_runs_and_traced_spans(tmp_path):
    """8 forced host devices: the reference runs ``hierarchical_encode_jit``
    (4×2), ``multilevel_encode_jit`` (2×2×2) and the traced ``ir_encode_jit``
    (K = 8: the multilevel IR on its hierarchy, and a pipelined
    prepare-and-shoot IR on the flat default) and writes outputs, span
    records without times, and metric counts; the port must equal them."""
    out_file, span_file = tmp_path / "ref.npz", tmp_path / "spans.json"
    code = f"""
        import json
        import numpy as np, jax.numpy as jnp
        from repro.launch.mesh import make_mesh
        from repro.core.field import M31, NTT, Field
        from repro.core.matrices import distinct_points, random_matrix, random_vector, vandermonde
        from repro.core.schedule import plan_prepare_shoot
        from repro.dist.collectives import (
            _apply_pipeline, hierarchical_encode_jit, ir_encode_jit, multilevel_encode_jit)
        from repro.obs import MetricsRegistry, Tracer
        from repro.topo import Hierarchy, plan_multilevel
        K = 8
        res, spans = {{}}, {{}}
        mesh2 = make_mesh((4, 2), ("inter", "intra"))
        mesh3 = make_mesh((2, 2, 2), ("pod", "slice", "chip"))
        axes3 = ("pod", "slice", "chip")
        for q, tag in ((M31, "m31"), (NTT, "ntt")):
            f = Field(q)
            A = np.asarray(random_matrix(f, K, seed=2))
            x = jnp.asarray(random_vector(f, (K, 16), seed=3).astype(np.uint32))
            for p in (1, 2):
                fn, _ = hierarchical_encode_jit(mesh2, "inter", "intra", A, p=p, q=q)
                res[f"hier_{{tag}}_{{p}}"] = np.asarray(fn(x))
                fn, _ = multilevel_encode_jit(mesh3, axes3, A, p=p, q=q)
                res[f"multi_{{tag}}_{{p}}"] = np.asarray(fn(x))
            fn, _ = hierarchical_encode_jit(mesh2, "inter", "intra", A, q=q, pipeline="pipeline")
            res[f"hier_{{tag}}_pipeline"] = np.asarray(fn(x))
        f = Field(M31)
        A = np.asarray(vandermonde(f, distinct_points(f, K, seed=0)))
        x = jnp.asarray(random_vector(f, (K, 32), seed=3).astype(np.uint32))
        for name, ir, axes, mesh, topo in (
            ("multilevel", plan_multilevel(K, 1, (2, 2, 2)).to_ir(A), axes3, mesh3, Hierarchy(levels=(2, 2, 2))),
            ("pipelined", _apply_pipeline(plan_prepare_shoot(K, 1).to_ir(A), "pipeline"),
             "enc", make_mesh((8,), ("enc",)), None),
        ):
            tracer, reg = Tracer(), MetricsRegistry()
            fn = ir_encode_jit(mesh, axes, ir, tracer=tracer, topo=topo, metrics=reg)
            res["traced_" + name] = np.asarray(fn(x))
            res["plain_" + name] = np.asarray(ir_encode_jit(mesh, axes, ir)(x))
            snap = reg.snapshot()
            spans[name] = {{
                "spans": [{{k: v for k, v in s.to_dict().items() if k not in ("ts_us", "dur_us")}}
                          for s in tracer.spans],
                "counters": {{k: v["value"] for k, v in snap.items() if v["type"] == "counter"}},
                "hist_counts": {{k: v["count"] for k, v in snap.items() if v["type"] == "histogram"}},
            }}
        np.savez({str(out_file)!r}, **res)
        with open({str(span_file)!r}, "w") as fh:
            json.dump(spans, fh)
        print("reference mesh runs ok")
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, f"child failed:\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    ref = np.load(out_file)
    ref_spans = json.loads(span_file.read_text())
    K = 8
    for q, tag in ((M31, "m31"), (NTT, "ntt")):
        f = Field(q)
        A = np.asarray(random_matrix(f, K, seed=2))
        x = random_vector(f, (K, 16), seed=3).astype(np.uint32)
        for p in (1, 2):
            fn, _ = pc.hierarchical_encode(A, k_intra=2, p=p, q=q, device="cpu")
            assert np.array_equal(to_numpy(fn(x)), ref[f"hier_{tag}_{p}"]), (tag, p)
            fn, _ = pc.multilevel_encode(A, (2, 2, 2), p=p, q=q, device="cpu")
            assert np.array_equal(to_numpy(fn(x)), ref[f"multi_{tag}_{p}"]), (tag, p)
        fn, _ = pc.hierarchical_encode(A, k_intra=2, q=q, device="cpu", pipeline="pipeline")
        assert np.array_equal(to_numpy(fn(x)), ref[f"hier_{tag}_pipeline"]), tag
    f = Field(M31)
    A = np.asarray(vandermonde(f, distinct_points(f, K, seed=0)))
    x = random_vector(f, (K, 32), seed=3).astype(np.uint32)
    from repro_torch.core.schedule import plan_prepare_shoot
    from repro_torch.topo import plan_multilevel

    for name, ir, topo in (
        ("multilevel", plan_multilevel(K, 1, (2, 2, 2)).to_ir(A), Hierarchy(levels=(2, 2, 2))),
        ("pipelined", pc._apply_pipeline(plan_prepare_shoot(K, 1).to_ir(A), "pipeline"), None),
    ):
        _, out, tracer, reg = _traced(ir, x, topo=topo)
        assert np.array_equal(to_numpy(out), ref["traced_" + name]), name
        assert np.array_equal(ref["traced_" + name], ref["plain_" + name]), name
        want = ref_spans[name]
        assert json.loads(json.dumps(_span_records(tracer.spans))) == want["spans"], name
        snap = reg.snapshot()
        assert {k: v["value"] for k, v in snap.items() if v["type"] == "counter"} == want["counters"]
        assert {k: v["count"] for k, v in snap.items() if v["type"] == "histogram"} == want["hist_counts"]
    assert any(s["attrs"].get("overlap") for s in ref_spans["pipelined"]["spans"])
