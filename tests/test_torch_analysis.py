"""Differential tests of the port's analysis layer (``repro_torch.launch``:
``op_cost``, ``roofline``, ``costpass``, ``dryrun``, ``hillclimb``,
``perf_report``, and ``models.inputs``' spec functions) against the JAX
package on the CPU.

Tolerances:

* products: the op-level counter's product flops equal the reference
  jaxpr walker's ``by_op["dot_general"]`` exactly, for every family's smoke
  config, forward (prefill), decode step and train step;
* totals: the counted flops lie within [0.95, 1.10] of the reference's and
  the bytes within [0.6, 1.3] (measured 0.987-1.045 and 0.707-1.194 over
  these cells). They differ because the port counts eager aten ops where
  the reference counts jaxpr equations: casts, reductions and gathers fall
  into other classes. The floor is the reference's own check of its walker
  (``tests/test_dryrun_results.py``: at least 0.8x);
* ``model_flops``, the specs, ``analyze``'s flops, bytes and useful ratio
  and the rendered reports are exactly equal; ``analyze``'s time terms are
  equal once multiplied by each package's peak;
* the cost pass's extrapolation equals the full count exactly (flops,
  bytes, tile bytes and every per-op term).

The reference's ``launch/dryrun.py``, ``costpass.py`` and ``hillclimb.py``
set ``XLA_FLAGS`` when imported, so none of them is imported here; the
reference's walker is ``repro.launch.jaxpr_cost.cost_of_fn``.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get as r_get
from repro.configs import smoke_config as r_smoke_config
from repro.configs.base import ShapeSpec as RShapeSpec
from repro.launch import perf_report as r_perf_report
from repro.launch import roofline as r_roofline
from repro.launch.jaxpr_cost import cost_of_fn as r_cost_of_fn
from repro.models import build_model as r_build_model
from repro.models import decode_input_specs as r_decode_input_specs
from repro.models import train_batch_specs as r_train_batch_specs
from repro.train import OptConfig as ROptConfig
from repro.train import make_train_step as r_make_train_step
from repro.train import state_specs as r_state_specs
from repro.train.train_loop import make_decode_step as r_make_decode_step
from repro.train.train_loop import make_prefill_step as r_make_prefill_step
from repro_torch import tree
from repro_torch.configs import SHAPES, all_arch_names, get, shape_applicable, smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.field import M31, Field
from repro_torch.core.matrices import random_matrix, random_vector
from repro_torch.core.simulator import interpret
from repro_torch.launch import costpass, dryrun, hillclimb, perf_report, roofline
from repro_torch.launch.op_cost import FUSION_DISCOUNT, count_fn, cost_of_fn
from repro_torch.launch.profiles import BASELINE
from repro_torch.models import decode_input_specs, train_batch_specs
from repro_torch.obs import Tracer, write_spans_jsonl
from repro_torch.topo import Hierarchy, plan_multilevel

ARCHS = all_arch_names()
KINDS = ("prefill", "decode", "train")
B, S = 2, 32


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the counter against the jaxpr walker (tests/test_costmodel.py's cases)
# ---------------------------------------------------------------------------


def test_loop_of_products_counts_the_reference_scan():
    def r_f(c, xs):
        return jax.lax.scan(lambda c, x: (c @ x, ()), c, xs)[0]

    def f(c, xs):
        for x in xs:
            c = c @ x
        return c

    want = r_cost_of_fn(r_f, jax.ShapeDtypeStruct((64, 64), jnp.float32),
                        jax.ShapeDtypeStruct((10, 64, 64), jnp.float32)).flops
    got = cost_of_fn(f, meta((64, 64)), meta((10, 64, 64)))
    assert got.flops == want == 10 * 2 * 64**3
    assert got.product_flops == got.flops and dict(got.by_op) == {"mm": want}


def test_nested_loops_count_the_reference_nested_scan():
    def r_f(c, xs):
        def outer(c, x):
            return jax.lax.scan(lambda c2, x2: (c2 @ x2, ()), c, xs)[0], ()
        return jax.lax.scan(outer, c, xs)[0]

    def f(c, xs):
        for _ in xs:
            for x2 in xs:
                c = c @ x2
        return c

    want = r_cost_of_fn(r_f, jax.ShapeDtypeStruct((32, 32), jnp.float32),
                        jax.ShapeDtypeStruct((5, 32, 32), jnp.float32)).flops
    assert cost_of_fn(f, meta((32, 32)), meta((5, 32, 32))).flops == want == 25 * 2 * 32**3


def test_checkpoint_and_backward_count_the_recompute():
    def layer(w, x):
        return torch.tanh(x @ w)

    def loss(w, x):
        return torch.utils.checkpoint.checkpoint(layer, w, x, use_reentrant=False).sum()

    def grad(w, x):
        w = w.detach().requires_grad_(True)
        return torch.autograd.grad(loss(w, x), w)[0]

    w, x = meta((64, 64)), meta((8, 64))
    base = cost_of_fn(loss, w, x).flops
    g = cost_of_fn(grad, w, x)
    assert g.flops >= 2.5 * base  # fwd + recompute + the backward product
    assert g.by_op["mm"] == 3 * 2 * 8 * 64 * 64  # x needs no gradient: one backward product


def test_op_classes():
    """Products 2·MACs with their bytes in full; elementwise |out| flops at a
    quarter of their bytes; views and casts free; heavy ops bytes only;
    attention-sized tiles into ``tile_bytes``."""
    a, b = meta((4, 8)), meta((8, 16))
    c = cost_of_fn(lambda a, b: a @ b, a, b)
    assert (c.flops, c.bytes) == (2 * 4 * 8 * 16, 4 * (32 + 128 + 64))
    c = cost_of_fn(lambda a: torch.exp(a), a)
    assert (c.flops, c.bytes) == (32, 4 * 64 / FUSION_DISCOUNT)
    c = cost_of_fn(lambda a: a.t().reshape(-1).to(torch.bfloat16), a)
    assert (c.flops, c.bytes, dict(c.by_op)) == (0, 0, {})
    c = cost_of_fn(lambda a: a.sum(0), a)
    assert (c.flops, c.bytes, dict(c.by_op)) == (0, 4 * 40, {"sum": 160.0})
    t = meta((1, 2, 256, 256))
    c = cost_of_fn(lambda t: torch.softmax(t, -1), t)
    assert c.tile_bytes == c.bytes == 2 * 4 * 2 * 256 * 256 / FUSION_DISCOUNT


def test_live_bytes_tracker():
    """The peak holds the arguments and every storage alive at once; a view
    costs nothing and keeps its base alive; a freed storage leaves the count."""
    a = meta((1000,))

    def f(a):
        b = a * 2  # +4000
        c = b[:10]  # a view: +0
        s = c.sum()  # +4
        del b, c  # b's storage is freed
        d = a + 1  # +4000
        return s + d.sum()  # +4, +4

    counter = count_fn(f, a)
    m = counter.memory
    assert m["argument_bytes"] == 4000
    assert m["peak_bytes"] == 4000 + 4 + 4000 + 4 + 4  # a, s, d, d.sum() and the result
    assert m["output_bytes"] == 4
    assert counter.live_bytes == 4000  # a: the result was dropped with count_fn's frame


# ---------------------------------------------------------------------------
# every family's smoke config, step by step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def counted(arch: str, kind: str):
    """(reference jaxpr cost, port op cost) of one smoke step, float32 moments."""
    rcfg, cfg = r_smoke_config(arch), smoke_config(arch)
    seq = S + (cfg.vlm.n_patches if cfg.vlm else 0)
    rm = r_build_model(rcfg)
    rp, _ = rm.param_specs()
    rshape = RShapeSpec("smoke", kind, seq, B)
    if kind == "train":
        oc = ROptConfig()
        want = r_cost_of_fn(r_make_train_step(rm, oc), rp, r_state_specs(oc, rp), r_train_batch_specs(rcfg, rshape))
    elif kind == "prefill":
        b = r_train_batch_specs(rcfg, rshape)
        b.pop("labels")
        want = r_cost_of_fn(r_make_prefill_step(rm), rp, b)
    else:
        cache = jax.eval_shape(lambda: rm.init_cache(B, seq))
        d = r_decode_input_specs(rcfg, rshape)
        want = r_cost_of_fn(r_make_decode_step(rm), rp, cache, d["tokens"], d["pos"])
    fn, args = costpass._build_step(cfg, ShapeSpec("smoke", kind, seq, B), moment_dtype="float32")
    return want, count_fn(fn, *args)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_product_flops_equal_reference(arch, kind):
    want, got = counted(arch, kind)
    assert got.cost.product_flops == want.by_op["dot_general"] > 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_total_flops_and_bytes_within_band(arch, kind):
    want, got = counted(arch, kind)
    assert 0.95 <= got.cost.flops / want.flops <= 1.10
    assert 0.6 <= got.cost.bytes / want.bytes <= 1.3
    assert got.cost.flops >= 0.8 * want.flops  # the reference's own floor


@pytest.mark.parametrize("arch", ARCHS)
def test_tracker_peak_holds_the_state(arch):
    _, got = counted(arch, "train")
    fn, (params, opt, batch) = costpass._build_step(smoke_config(arch), ShapeSpec("smoke", "train", S, B),
                                                    moment_dtype="float32")
    nbytes = lambda t: sum(x.numel() * x.element_size() for x in tree.leaves(t))
    state = nbytes(params) + nbytes(opt)
    m = got.memory
    assert m["argument_bytes"] >= state
    assert m["peak_bytes"] >= m["argument_bytes"] + m["output_bytes"] >= 2 * nbytes(params)


# ---------------------------------------------------------------------------
# model_flops, the specs, analyze, the reports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch, shape):
    assert roofline.model_flops(get(arch), SHAPES[shape]) == r_roofline.model_flops(r_get(arch), R_SHAPES[shape])


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, shape):
    def same(mine, ref):
        assert set(mine) == set(ref)
        for k in ref:
            assert mine[k].device.type == "meta"
            assert tuple(mine[k].shape) == tuple(ref[k].shape), k
            assert str(mine[k].dtype).split(".")[-1] == str(ref[k].dtype), k

    same(train_batch_specs(get(arch), SHAPES[shape]), r_train_batch_specs(r_get(arch), R_SHAPES[shape]))
    same(decode_input_specs(get(arch), SHAPES[shape]), r_decode_input_specs(r_get(arch), R_SHAPES[shape]))


def test_roofline_peaks_are_the_h100_data_sheet():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW, roofline.P_LINKS) == (989e12, 3.35e12, 450e9, 1)


def a_record(arch: str, shape: str, flops: float, nbytes: float, tile: float, coll: int) -> dict:
    """One dry-run record both packages' ``analyze`` read: the reference's
    ``jaxpr_cost`` and the port's ``op_cost`` hold the same numbers."""
    cost = {"flops_global": flops, "bytes_global": nbytes, "tile_bytes_global": tile}
    return {"arch": arch, "shape": shape, "mesh": "1xH100", "status": "ok", "n_chips": 1,
            "jaxpr_cost": dict(cost), "op_cost": dict(cost), "collective_bytes_per_device": coll,
            "memory": {"argument_bytes": 3e9, "temp_bytes": 2e9, "output_bytes": 1e9, "peak_bytes": 6e9}}


@pytest.mark.parametrize("arch,shape,flops,nbytes,tile,coll", [
    ("qwen3-1.7b", "train_4k", 1.7e16, 2.2e14, 3e13, 0),
    ("jamba-v0.1-52b", "prefill_32k", 3.0e16, 2.0e14, 1e13, 12345678),
    ("deepseek-v3-671b", "decode_32k", 4.1e14, 3.4e12, 0.0, 0),
])
def test_analyze_reads_the_record_as_the_reference_does(arch, shape, flops, nbytes, tile, coll):
    rec = a_record(arch, shape, flops, nbytes, tile, coll)
    mine, ref = roofline.analyze(rec), r_roofline.analyze(rec)
    assert mine.hlo_flops_global == ref.hlo_flops_global == flops
    assert mine.model_flops == ref.model_flops
    assert mine.useful_ratio == ref.useful_ratio
    assert mine.hbm_gb_per_dev == ref.hbm_gb_per_dev == 6.0
    assert mine.compute_s * roofline.PEAK_FLOPS == pytest.approx(ref.compute_s * r_roofline.PEAK_FLOPS, rel=1e-15)
    assert mine.memory_s * roofline.HBM_BW == pytest.approx(ref.memory_s * r_roofline.HBM_BW, rel=1e-15)
    assert mine.memory_s * roofline.HBM_BW == nbytes - tile
    assert mine.collective_s * roofline.NVLINK_BW == pytest.approx(ref.collective_s * r_roofline.ICI_BW, rel=1e-15)
    skipped = {"arch": arch, "shape": shape, "mesh": "1xH100", "status": "skipped", "reason": "by design"}
    assert roofline.render_table([roofline.analyze(skipped)]) == r_roofline.render_table([r_roofline.analyze(skipped)])


def test_perf_report_render_is_the_reference_string(tmp_path):
    rec = hillclimb.measure("qwen3-1.7b", "decode_32k", BASELINE)
    rec["hypothesis"] = "the decode tick reads every weight once"
    other = dict(rec, profile="gather", levers={**rec["levers"], "moe_gather": True}, hypothesis="")
    path = tmp_path / "log.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in (rec, other)))
    assert perf_report.render(str(path)) == r_perf_report.render(str(path))
    assert "qwen3-1.7b×decode_32k×1xH100" in perf_report.render(str(path))


def test_perf_report_render_topology_is_the_reference_string(tmp_path):
    table = {"mesh": "1x8", "topology": "Hierarchy(levels=(2, 2, 2))", "autotuner_choice": "multilevel",
             "predicted": {"multilevel": {"c1": 3, "c2": 4, "us": 12.25}, "prepare-and-shoot": {"c1": 3, "c2": 5, "us": 20.0}},
             "measured_us": {"multilevel": 101.5}}
    rec = {"K": 8, "p": 1, "payload_elems": 16384, **table, "three_level": dict(table, mesh="2x2x2")}
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(rec))
    assert perf_report.render_topology(str(path)) == r_perf_report.render_topology(str(path))


def test_perf_report_render_drift_is_the_reference_string(tmp_path):
    f = Field(M31)
    K = 8
    A = np.asarray(random_matrix(f, K, seed=3))
    ir = plan_multilevel(K, 1, (2, 2, 2)).to_ir(A)
    tracer = Tracer()
    interpret(ir, random_vector(f, (K,), seed=4), f, tracer=tracer, topo=Hierarchy(levels=(2, 2, 2)))
    path = str(tmp_path / "spans.trace.jsonl")
    write_spans_jsonl(tracer.spans, path)
    assert perf_report.render_drift(path) == r_perf_report.render_drift(path)
    assert perf_report.render_drift(path, threshold=1e9) == r_perf_report.render_drift(path, threshold=1e9)
    assert perf_report.render_drift([]) == r_perf_report.render_drift([])


# ---------------------------------------------------------------------------
# the cost pass's extrapolation, the dry run, the hill-climb
# ---------------------------------------------------------------------------


EXTRAPOLATED = {
    # config, shape: every axis, and each pair that a cell of the registry combines
    "dense-prefill-repeats-chunks": (lambda: smoke_config("qwen3-1.7b").replace(n_layers=4),
                                     ShapeSpec("p", "prefill", 6 * 1024, 1)),
    "dense-train-repeats-chunks": (lambda: smoke_config("qwen3-1.7b").replace(n_layers=4),
                                   ShapeSpec("t", "train", 6 * 1024, 1)),
    "moe-decode-repeats": (lambda: smoke_config("arctic-480b").replace(n_layers=3),
                           ShapeSpec("d", "decode", 512, 2)),
    "mla-prefill-repeats-chunks": (lambda: smoke_config("deepseek-v3-671b").replace(n_layers=4),
                                   ShapeSpec("p", "prefill", 5 * 1024, 1)),
    "rwkv-train-repeats-steps": (lambda: smoke_config("rwkv6-3b").replace(n_layers=3),
                                 ShapeSpec("t", "train", 64, 2)),
    "jamba-train-repeats-steps": (lambda: smoke_config("jamba-v0.1-52b").replace(n_layers=12),
                                  ShapeSpec("t", "train", 64, 2)),
    "rwkv-prefill-chunks-steps": (lambda: smoke_config("rwkv6-3b").replace(n_layers=1),
                                  ShapeSpec("p", "prefill", 5 * 1024, 1)),
    "whisper-train-repeats": (lambda: smoke_config("whisper-base").replace(
        n_layers=3, encdec=smoke_config("whisper-base").encdec.__class__(n_enc_layers=3, n_frames=8)),
        ShapeSpec("t", "train", 64, 2)),
}


@pytest.mark.parametrize("case", sorted(EXTRAPOLATED))
def test_costpass_extrapolation_equals_the_full_count(case):
    make, shape = EXTRAPOLATED[case]
    cfg = make()
    assert costpass.sample_axes(cfg, shape), "the case must extrapolate along some axis"
    c1, m1, method = costpass.count_cell(cfg, shape)
    c0, m0, full = costpass.count_cell(cfg, shape, axes={})
    assert full == "full" and method != "full"
    assert (c1.flops, c1.bytes, c1.tile_bytes) == (c0.flops, c0.bytes, c0.tile_bytes)
    assert {k: v for k, v in c1.by_op.items() if v} == {k: v for k, v in c0.by_op.items() if v}
    assert (m1["argument_bytes"], m1["output_bytes"]) == (m0["argument_bytes"], m0["output_bytes"])
    assert m1["peak_bytes"] == pytest.approx(m0["peak_bytes"], rel=0.15)  # extrapolated, not exact


def test_sample_axes_of_the_registry():
    def axes(arch, shape):
        return set(costpass.sample_axes(get(arch), SHAPES[shape]))

    assert axes("qwen3-1.7b", "train_4k") == {"repeats"}
    assert axes("qwen3-1.7b", "prefill_32k") == {"repeats", "chunks"}
    assert axes("qwen3-1.7b", "decode_32k") == {"repeats"}
    assert axes("jamba-v0.1-52b", "prefill_32k") == {"repeats", "chunks", "steps"}
    assert axes("rwkv6-3b", "long_500k") == {"repeats"}
    assert axes("whisper-base", "train_4k") == {"repeats"}


def test_dryrun_one_arch_and_roofline_table(tmp_path):
    out = str(tmp_path)
    recs = dryrun.run_all(out, archs=["qwen3-1.7b"])
    by_shape = {r["shape"]: r for r in recs}
    assert set(by_shape) == set(SHAPES)
    for name, rec in by_shape.items():
        ok, reason = shape_applicable(get("qwen3-1.7b"), SHAPES[name])
        assert rec["status"] == ("ok" if ok else "skipped")
        if not ok:
            assert rec["reason"] == reason
            continue
        assert rec["mesh"] == "1xH100" and rec["n_chips"] == 1 and rec["collective_bytes_per_device"] == 0
        assert rec["op_cost"]["flops_global"] > 0 and rec["memory"]["peak_bytes"] >= rec["param_bytes"]
        assert rec["fits"] == (rec["memory"]["peak_bytes"] <= dryrun.CARD_BYTES)
    # bf16 weights, two float32 moments and the int32 step
    assert by_shape["train_4k"]["state_bytes"] == by_shape["train_4k"]["param_bytes"] * 5 + 4
    assert by_shape["decode_32k"]["cache_bytes"] == 2 * 28 * 128 * 32768 * 8 * 128 * 2
    rows = roofline.load_all(out)
    assert [r.status for r in rows].count("ok") == 3
    table = roofline.render_table(rows)
    assert sum(line.startswith("qwen3-1.7b ") for line in table.splitlines()) == 4 and "op-cost+flash" in table
    train = next(r for r in rows if r.shape == "train_4k")
    assert train.hlo_flops_global == by_shape["train_4k"]["op_cost"]["flops_global"]
    assert 0 < train.useful_ratio < 1  # block remat recomputes the forward


def test_costpass_recounts_a_record_in_place(tmp_path):
    """``costpass`` recounts a dry-run record: extrapolated, then ``--full``
    at full size, the same flops and bytes (a decode cell: 28 layers)."""
    out = str(tmp_path)
    rec = dryrun.dryrun_cell("qwen3-1.7b", "decode_32k", out)
    path = str(tmp_path / "qwen3-1.7b__decode_32k__1xH100.json")
    costpass.main(["--out", out, "--arch", "qwen3-1.7b", "--full"])
    with open(path) as fh:
        full = json.load(fh)
    assert full["op_cost"]["method"] == "full" and rec["op_cost"]["method"] == "repeats 1,2->28"
    for k in ("flops_global", "bytes_global", "tile_bytes_global", "product_flops_global"):
        assert full["op_cost"][k] == rec["op_cost"][k], k
    assert full["memory"]["argument_bytes"] == rec["memory"]["argument_bytes"]


def test_hillclimb_appends_its_own_log(tmp_path):
    log = tmp_path / "perf.jsonl"
    hillclimb.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--hypothesis", "h1", "--log", str(log)])
    hillclimb.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--levers", "bf16_moments",
                    "--log", str(log)])
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["profile"] for r in rows] == ["baseline", "bf16_moments"]
    assert rows[0]["mesh"] == "1xH100" and rows[0]["collective_s"] == 0.0 and rows[0]["bottleneck"] == "memory"
    assert rows[0]["compute_s"] == pytest.approx(rows[0]["useful_ratio"] ** -1 * roofline.model_flops(
        get("qwen3-1.7b"), SHAPES["decode_32k"]) / roofline.PEAK_FLOPS, rel=1e-12)
