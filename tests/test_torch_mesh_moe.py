"""The MoE and MLA families on a mesh of ranks against the reference, on a
(data=2, model=2) mesh of four gloo ranks on the CPU.

One JAX child with 8 forced host devices writes the reference's outputs
(``torch_mesh_moe_harness.reference_outputs``); the port's cases run in six
groups (``torch_mesh_moe_harness.PORT_GROUPS``), each in a 4-rank world of
its own under a deadline of its own (``DEADLINE_S``), so that a slow world
fails only its own tests; the tests below assert on the results. Each
deadline is at least 3x the group's world alone on an 8-core CPU machine
with no other load (seconds, measured with ``run_ranks``, the reference child
run first): the sharded draw 10.1 (deadline 90), ``moe_block`` 11.9 (90),
the MLA decode 15.2 (90), the engines with the guard 37.9 (240), the train
steps 68.2 (300), the launcher 20.5 (150); the reference child took 145.4.
All six worlds in one, as before, took 134.7 s alone there. Under the whole
suite in six workers they took 10.6, 10.3, 15.0, 67.8, 88.1 and 37.9 s. The sharding specs
of Arctic and DeepSeek-V3 at full width are compared leaf by leaf on a mesh
made by hand (only its axis names and sizes are read), under ``train_4k``,
``decode_32k`` and ``long_500k`` with the baseline, ``opt`` and
``moe_resident`` profiles.

Tolerances:

* ``moe_block`` on the mesh against the reference's: output ``MOE_RTOL``
  (1e-5) relative and ``MOE_ATOL`` (1e-6) absolute, the aux term
  ``AUX_ATOL`` (1e-6); the pairs the router drops are counted on the global
  tokens and equal the reference's (an integer: no tolerance);
* the meshed ``mla_decode`` against the reference's: output at the same
  tolerance; the latent cache it writes within ``MOE_ATOL`` of the
  reference's (XLA and PyTorch round the down-projection's sums at other
  points) and of the port's one-process decode on the same values, and bit
  for bit against the latter under ``opt``, where the down-projections are
  whole (under the baseline's FSDP the products over ``d_model`` are summed
  over the ``data`` axis, in another order);
* greedy tokens of the float32 engines on the mesh, guarded or not, and the
  launcher's token lines: equal;
* the train step at ``tests/test_torch_train.py``'s float32 tolerances:
  loss ``LOSS_ATOL`` (1e-5), global norm relative ``NORM_RTOL`` (1e-5),
  each parameter within 2 · lr · ``STEP_SLACK`` plus ``STEP_TIGHT`` of the
  reference's, at most ``STEP_FRACTION`` of a leaf's elements beyond
  ``STEP_TIGHT``;
* ``Model.init(generator, shardings=)`` against ``place(model.init(generator),
  shardings)``: bit for bit.
"""

import functools
import json

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate

import jax  # noqa: F401 - both packages in one test process, JAX on the CPU

import torch_mesh_moe_harness as H
from repro.configs import SHAPES as R_SHAPES
from repro_torch import tree
from repro_torch.configs import SHAPES, get
from repro_torch.launch.mesh import RankMesh
from repro_torch.launch.profiles import BASELINE, OPT, profile_with, rules_for
from repro_torch.models import build_model
from repro_torch.train import OptConfig
from repro_torch.train.train_loop import batch_shardings, cache_shardings, opt_state_shardings, param_shardings
from torch_ranks_harness import run_ranks

MOE_RTOL, MOE_ATOL, AUX_ATOL = 1e-5, 1e-6, 1e-6
LOSS_ATOL, NORM_RTOL = 1e-5, 1e-5
STEP_SLACK, STEP_TIGHT, STEP_FRACTION = 1.05, 1e-6, 0.02
DEADLINE_S = {"init": 90.0, "moe": 90.0, "mla": 90.0, "engines": 240.0, "train": 300.0, "launch": 150.0}

PROFILES = {"baseline": BASELINE, "opt": OPT, "resident": profile_with("resident", moe_resident=True)}
CASES = [f"{a}/{s}/{p}" for a, s, p in H.SPEC_CASES]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_moe_ref"))
    path = H.reference_outputs(d)
    data = dict(np.load(path))
    return {"path": path, "dir": d, "data": data, "specs": json.loads(str(data["specs"]))}


def world(ref, group):
    """The results of ``group``'s own 4-rank world, under its own deadline."""
    return run_ranks(4, "torch_mesh_moe_harness:port_main", ref["path"], ref["dir"], group,
                     deadline=DEADLINE_S[group])


@pytest.fixture(scope="module")
def port_init(ref):
    return world(ref, "init")


@pytest.fixture(scope="module")
def port_moe(ref):
    return world(ref, "moe")


@pytest.fixture(scope="module")
def port_mla(ref):
    return world(ref, "mla")


@pytest.fixture(scope="module")
def port_engines(ref):
    return world(ref, "engines")


@pytest.fixture(scope="module")
def port_train(ref):
    return world(ref, "train")


@pytest.fixture(scope="module")
def port_launch(ref):
    return world(ref, "launch")


def hand_mesh():
    return RankMesh(None, H.MESH[0], H.MESH[1], 0, (0, 0), (0, 1, 2, 3), torch.device("cpu"))


def as_json(spec):
    return json.loads(json.dumps([None if e is None else e if isinstance(e, str) else list(e) for e in spec]))


@functools.lru_cache(maxsize=2)
def full_model(arch):
    return build_model(get(arch))


def case(c):
    arch, shape, prof = c.split("/")
    return full_model(arch), rules_for(get(arch), SHAPES[shape], PROFILES[prof]), SHAPES[shape]


# ---------------------------------------------------------------------------
# the sharding functions at full width, leaf by leaf against the reference's specs
# ---------------------------------------------------------------------------


def test_the_cases_cover_the_reference_shapes_and_both_families():
    assert all(s in R_SHAPES for _, s, _ in H.SPEC_CASES)
    assert {a for a, _, _ in H.SPEC_CASES} == set(H.ARCHS)


@pytest.mark.parametrize("c", CASES)
def test_param_shardings_equal_the_reference(ref, c):
    model, rules, _ = case(c)
    got = [as_json(s.spec) for s in tree.leaves(param_shardings(model, hand_mesh(), rules))]
    assert got == ref["specs"][c + "/params"]


@pytest.mark.parametrize("c", CASES)
def test_opt_state_shardings_equal_the_reference(ref, c):
    model, rules, _ = case(c)
    ost = opt_state_shardings(OptConfig(moment_dtype="bfloat16"), model, hand_mesh(), rules)
    assert [as_json(s.spec) for s in tree.leaves(ost)] == ref["specs"][c + "/opt"]
    assert ost["step"].spec == () and all(isinstance(p, Replicate) for p in ost["step"].placements)


@pytest.mark.parametrize("c", CASES)
def test_batch_shardings_equal_the_reference(ref, c):
    model, rules, shape = case(c)
    kind = "decode" if shape.kind == "decode" else "train"
    got = {k: as_json(v.spec) for k, v in batch_shardings(model, hand_mesh(), rules, kind).items()}
    assert got == ref["specs"][c + "/batch"]


@pytest.mark.parametrize("c", CASES)
def test_cache_shardings_equal_the_reference(ref, c):
    model, rules, _ = case(c)
    cache = model.init_cache(*H.CACHE, device="meta")
    got = [as_json(s.spec) for s in tree.leaves(cache_shardings(model, hand_mesh(), rules, cache))]
    assert got == ref["specs"][c + "/cache"]


def test_the_expert_leaves_are_split_as_the_profiles_say(ref):
    """The levers reach the expert weights: ``moe_ep`` puts experts over
    ``data`` and ``moe_ff`` over ``model``, ``moe_resident`` experts over
    both axes with ``expert_d`` whole, the baseline FSDPs ``expert_d``."""
    def w_gate(c):
        model, rules, _ = case(c)
        return param_shardings(model, hand_mesh(), rules)["body"]["b0"]["moe"]["w_gate"].spec

    assert w_gate("deepseek-v3-671b/decode_32k/opt") == (None, "data", None, "model")
    assert w_gate("deepseek-v3-671b/decode_32k/resident") == (None, ("model", "data"), None, None)
    assert w_gate("arctic-480b/train_4k/baseline") == (None, None, "data", "model")


# ---------------------------------------------------------------------------
# the 4-rank world: the sharded draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", H.ARCHS)
@pytest.mark.parametrize("prof", ["baseline", "opt"])
@pytest.mark.parametrize("slabs", [False, True], ids=["whole", "slabs"])
def test_sharded_init_equals_placing_the_whole_draw(port_init, arch, prof, slabs):
    """Each rank draws every slab and keeps its block: the same bits as the
    whole draw placed, under the default slab size and under one small
    enough that every expert leaf and the vocabulary are drawn in slabs."""
    from repro_torch.models import layers as L

    slab = 64 * 32 if slabs else L.SLAB_ELEMENTS
    assert port_init[0]["init"][f"{arch}/{prof}/{slab}"]


# ---------------------------------------------------------------------------
# moe_block and mla_decode on the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", H.ARCHS)
@pytest.mark.parametrize("prof", H.PROFILES)
@pytest.mark.parametrize("form", H.FORMS)
def test_meshed_moe_block_equals_the_reference(ref, port_moe, arch, prof, form):
    got, d = port_moe[0]["moe"][f"{arch}/{prof}/{form}"], ref["data"]
    assert got["dropped"] > 0 and got["dropped"] == int(d[f"moe/{arch}/dropped"])
    assert got["placed"]
    np.testing.assert_allclose(got["y"], d[f"moe/{arch}/{form}/y"], rtol=MOE_RTOL, atol=MOE_ATOL)
    assert abs(got["aux"] - float(d[f"moe/{arch}/{form}/aux"])) <= AUX_ATOL


@pytest.mark.parametrize("prof", ["baseline", "opt"])
def test_meshed_mla_decode_equals_the_reference_across_a_kv_block(ref, port_mla, prof):
    got, d = port_mla[0]["mla"][prof], ref["data"]
    assert got["split"][1] == "S(1)"  # positions over the model axis: blocks of 4, crossed at step 4
    for t in range(H.MLA_STEPS):
        np.testing.assert_allclose(got["y"][t], d[f"mla/y/{t}"], rtol=MOE_RTOL, atol=MOE_ATOL)
    for k in ("c_kv", "k_rope"):
        if prof == "opt":  # the down-projections whole (no FSDP): the one process's products, bit for bit
            assert np.array_equal(got[k], got["one"][k]), k
        np.testing.assert_allclose(got[k], got["one"][k], rtol=0, atol=MOE_ATOL)
        np.testing.assert_allclose(got[k], d[f"mla/{k}"], rtol=0, atol=MOE_ATOL)


# ---------------------------------------------------------------------------
# engines, the guard, a train step, the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", H.ARCHS)
@pytest.mark.parametrize("prof", ["baseline", "opt"])
def test_continuous_engine_2x2_tokens_equal_the_reference(ref, port_engines, arch, prof):
    want = [ref["data"][f"tokens/{arch}/{i}"].tolist() for i in range(len(H.PROMPTS))]
    assert port_engines[0]["engine"][f"{arch}/{prof}"] == want
    assert all(r["engine"] == port_engines[0]["engine"] for r in port_engines)


def test_guarded_meshed_deepseek_engine_tokens_equal_the_unguarded(ref, port_engines):
    g = port_engines[0]["guarded"]
    assert g["tokens"] == port_engines[0]["engine"]["deepseek-v3-671b/opt"]
    assert g["stats"]["injected_faults"] == 1 and g["stats"]["recoveries"] >= 1
    assert 3 not in g["alive"]
    assert all(r["guarded"]["tokens"] == g["tokens"] for r in port_engines)


@pytest.mark.parametrize("key", [f"{a}/{p}/{m}" for a, p, m in H.TRAIN_CASES])
def test_train_step_on_the_mesh_equals_the_reference(ref, port_train, key):
    arch, _, mdt = key.split("/")
    st, d, pre = port_train[0]["train"][key], ref["data"], f"step/{arch}/{mdt}"
    assert st["kept"] and st["moments"] == {f"torch.{mdt}"}
    for k in ("loss", "ce", "aux", "mtp_ce"):
        if f"{pre}/{k}" in d:
            assert abs(st["metrics"][k] - float(d[f"{pre}/{k}"])) <= LOSS_ATOL, k
    assert ("mtp_ce" in st["metrics"]) == (arch == "deepseek-v3-671b")
    np.testing.assert_allclose(st["metrics"]["grad_norm"], float(d[f"{pre}/grad_norm"]), rtol=NORM_RTOL)
    lr = st["metrics"]["lr"]
    assert lr == pytest.approx(float(d[f"{pre}/lr"]), rel=1e-6)
    for i, a in enumerate(st["params"]):
        diff = np.abs(a - d[f"{pre}/params/{i}"])
        assert diff.max() <= 2 * lr * STEP_SLACK + STEP_TIGHT, i
        assert (diff > STEP_TIGHT).mean() <= STEP_FRACTION, i


@pytest.mark.parametrize("arch", H.ARCHS)
def test_serve_launcher_2x2_prints_the_reference_token_lines(ref, port_launch, arch):
    want = [s for s in json.loads(str(ref["data"][f"launch/{arch}"])) if s.startswith("cli-")]
    got = [s for s in port_launch[0]["launch"][arch] if s.startswith("cli-")]
    assert len(want) == 2 and got == want
