"""The device half of the sharding substrate against the reference, on a
(data=2, model=2) mesh of four gloo ranks on the CPU.

One JAX child with 8 forced host devices writes the reference's outputs
(``torch_mesh_harness.reference_outputs``); one 4-rank world runs every port
case at once (``torch_mesh_harness.port_main``, deadline 120 s: 4.9x the
24.3 s it took alone on an 8-core CPU machine with no other load, the
reference child run first); the tests below assert on the results. The sharding specs are compared on a mesh made
by hand (only its axis names and sizes are read).

Tolerances: the engine's greedy tokens are equal at float32, as the
reference's own mesh test holds them; ``shard_map`` and the GPipe output at
rtol 1e-6 (``tests/test_distributed.py``'s); the train step at
``tests/test_torch_train.py``'s float32 tolerances (loss 1e-5, global norm
relative 1e-5, each parameter within 2 · lr · 1.05 plus 1e-6 of the
reference's, at most 2 % of a leaf's elements beyond 1e-6); the checkpoint,
the restore and the reshards bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import jax  # noqa: F401 - both packages in one test process, JAX on the CPU

import torch_mesh_harness as H
from repro.configs import SHAPES as R_SHAPES
from repro_torch import tree
from repro_torch.configs import SHAPES, get
from repro_torch.dist import staging
from repro_torch.dist.sharding import ShardingRules, constrain, placements_for
from repro_torch.launch.mesh import RankMesh, make_production_mesh
from repro_torch.launch.profiles import BASELINE, OPT, rules_for
from repro_torch.models import build_model
from repro_torch.train import OptConfig
from repro_torch.train.train_loop import batch_shardings, cache_shardings, opt_state_shardings, param_shardings
from torch_ranks_harness import run_ranks

STEP_SLACK, STEP_TIGHT, STEP_FRACTION = 1.05, 1e-6, 0.02


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = H.reference_outputs(str(tmp_path_factory.mktemp("mesh_ref")))
    data = dict(np.load(path))
    return {"path": path, "data": data, "specs": json.loads(str(data["specs"]))}


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    return run_ranks(4, "torch_mesh_harness:port_main", ref["path"], str(tmp_path_factory.mktemp("mesh_port")),
                     deadline=120.0)


def hand_mesh():
    return RankMesh(None, H.MESH[0], H.MESH[1], 0, (0, 0), (0, 1, 2, 3), torch.device("cpu"))


def as_json(spec):
    return json.loads(json.dumps([None if e is None else e if isinstance(e, str) else list(e) for e in spec]))


def case_rules(case):
    shape, prof = case.split("/")
    return rules_for(get(H.ARCH), SHAPES[shape], {"baseline": BASELINE, "opt": OPT}[prof]), SHAPES[shape]


CASES = [f"{s}/{p}" for s, p in H.SPEC_CASES]


# ---------------------------------------------------------------------------
# the sharding functions, leaf by leaf against the reference's specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_param_shardings_equal_the_reference(ref, case):
    rules, _ = case_rules(case)
    got = [as_json(s.spec) for s in tree.leaves(param_shardings(build_model(get(H.ARCH)), hand_mesh(), rules))]
    assert got == ref["specs"][case + "/params"]


@pytest.mark.parametrize("case", CASES)
def test_opt_state_shardings_equal_the_reference(ref, case):
    rules, _ = case_rules(case)
    ost = opt_state_shardings(OptConfig(), build_model(get(H.ARCH)), hand_mesh(), rules)
    assert [as_json(s.spec) for s in tree.leaves(ost)] == ref["specs"][case + "/opt"]
    assert ost["step"].spec == () and all(isinstance(p, Replicate) for p in ost["step"].placements)


@pytest.mark.parametrize("case", CASES)
def test_batch_shardings_equal_the_reference(ref, case):
    rules, shape = case_rules(case)
    kind = "decode" if shape.kind == "decode" else "train"
    got = {k: as_json(v.spec) for k, v in batch_shardings(build_model(get(H.ARCH)), hand_mesh(), rules, kind).items()}
    assert got == ref["specs"][case + "/batch"]


@pytest.mark.parametrize("case", CASES)
def test_cache_shardings_equal_the_reference(ref, case):
    rules, _ = case_rules(case)
    model = build_model(get(H.ARCH))
    cache = model.init_cache(*H.CACHE, device="meta")
    got = [as_json(s.spec) for s in tree.leaves(cache_shardings(model, hand_mesh(), rules, cache))]
    assert got == ref["specs"][case + "/cache"]


@pytest.mark.parametrize("case", CASES)
def test_named_sharding_lowers_each_spec_to_placements(ref, case):
    """Each mesh dim is ``Shard(i)`` where tensor dim i's spec entry names its
    axis, ``Replicate()`` elsewhere, for every parameter of the reference's
    specs."""
    mesh = hand_mesh()
    rules, _ = case_rules(case)
    for s, want in zip(tree.leaves(param_shardings(build_model(get(H.ARCH)), mesh, rules)),
                       ref["specs"][case + "/params"]):
        expect = [Replicate()] * 2
        for i, entry in enumerate(want):
            for ax in ([] if entry is None else [entry] if isinstance(entry, str) else entry):
                expect[mesh.axis_names.index(ax)] = Shard(i)
        assert list(s.placements) == expect == list(placements_for(mesh, s.spec))


def test_the_cases_cover_the_reference_shapes():
    assert all(s in R_SHAPES for s, _ in H.SPEC_CASES)


def test_a_spec_naming_two_axes_shards_one_dim_over_both():
    mesh = RankMesh(None, (2, 2, 2), ("pod", "data", "model"), 0, (0, 0, 0), tuple(range(8)), torch.device("cpu"))
    assert placements_for(mesh, (("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert placements_for(mesh, (None, None)) == (Replicate(),) * 3


def test_constrain_of_a_plain_tensor_is_the_identity():
    x = torch.ones(4, 2)
    assert constrain(x, hand_mesh(), ShardingRules(), ("batch", "d_ff")) is x
    assert constrain(x, None, None, ("batch", None)) is x


# ---------------------------------------------------------------------------
# the 4-rank world
# ---------------------------------------------------------------------------


def test_the_ranks_sit_row_major(port):
    assert [r["coords"] for r in port] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_place_keeps_each_rank_its_block(port):
    p = port[0]["place"]
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    assert p["spec"] == ("data", "model") and p["full_equal"]
    assert p["placements"] == [str(Shard(0)), str(Shard(1))]
    assert np.array_equal(p["local"], full[:4, :3].numpy())  # rank 0: the first block of each dim


def test_constrain_redistributes_a_dtensor(port):
    c = port[0]["constrain"]
    assert c["full_equal"] and c["plain_identity"] and c["replace_same"]
    assert c["placements"] == [str(Shard(1)), str(Shard(0))]


def test_shard_map_product_equals_the_reference(ref, port):
    np.testing.assert_allclose(port[0]["shard_map"]["prod"], ref["data"]["sm/prod"], rtol=1e-6)


def test_shard_map_psum_equals_the_reference(ref, port):
    got = port[0]["shard_map"]["psum"]
    assert tuple(got.shape) == ref["data"]["sm/psum"].shape
    np.testing.assert_allclose(got, ref["data"]["sm/psum"], rtol=1e-6)


def test_pipeline_equals_the_reference_gpipe(ref, port):
    """The reference's GPipe test on its own inputs: the pipeline against the
    stages applied in sequence, at its rtol 1e-6; and against the
    reference's pipeline at rtol 1e-5, atol 1e-7: XLA's and PyTorch's tanh
    and dot products round differently, and four stages carry it (measured
    9e-8 absolute, 3.6e-6 relative on a value near 0.02)."""
    np.testing.assert_allclose(port[0]["pipeline"], port[0]["pipeline_sequential"], rtol=1e-6)
    np.testing.assert_allclose(port[0]["pipeline"], ref["data"]["pipe/out"], rtol=1e-5, atol=1e-7)


def test_continuous_engine_2x2_tokens_equal_the_reference(ref, port):
    want = [ref["data"][f"tokens/{i}"].tolist() for i in range(len(H.PROMPTS))]
    assert port[0]["tokens"] == want


def test_every_rank_serves_the_same_tokens(port):
    assert all(r["tokens"] == port[0]["tokens"] for r in port)
    assert port[0]["engine_placed"]


def test_train_step_on_the_mesh_equals_the_reference(ref, port):
    st, d = port[0]["step"], ref["data"]
    for k in ("loss", "ce"):
        assert abs(st["metrics"][k] - float(d[f"step/{k}"])) <= 1e-5, k
    np.testing.assert_allclose(st["metrics"]["grad_norm"], float(d["step/grad_norm"]), rtol=1e-5)
    lr = st["metrics"]["lr"]
    assert lr == pytest.approx(float(d["step/lr"]), rel=1e-6)
    for i, a in enumerate(st["params"]):
        r = d[f"step/params/{i}"]
        diff = np.abs(a - r)
        assert diff.max() <= 2 * lr * STEP_SLACK + STEP_TIGHT, i
        assert (diff > STEP_TIGHT).mean() <= STEP_FRACTION, i


def test_train_step_keeps_the_state_on_its_shardings(port):
    assert port[0]["step"]["kept"] and port[0]["step"]["step_replicated"]


def test_checkpoint_of_a_meshed_state_holds_the_full_arrays(port, tmp_path):
    """Rank 0 wrote the file; its arrays are byte for byte those a
    one-process save of the same full values writes."""
    from repro_torch.configs import smoke_config
    from repro_torch.train import save_checkpoint, state_specs

    ck = port[0]["ckpt"]
    assert ck["step"] == 1
    model = build_model(H._small_cfg(smoke_config))
    like = {"params": model.param_specs(), "opt": state_specs(OptConfig(**H.OPT), model.param_specs())}
    save_checkpoint(str(tmp_path), tree.unflatten(tree.structure(like), [torch.from_numpy(a) for a in ck["full"]]), 1)
    one = dict(np.load(tmp_path / "state_00000001.npz"))
    assert sorted(ck["file"]) == sorted(one)
    for k in one:
        assert ck["file"][k].dtype == one[k].dtype and ck["file"][k].tobytes() == one[k].tobytes(), k


def test_restore_checkpoint_under_shardings_is_bit_exact(port):
    assert port[0]["ckpt"]["restored_local"]


def test_reshard_state_onto_4x1_and_back_is_bit_exact(port):
    ck = port[0]["ckpt"]
    assert ck["moved_full"] and ck["back_local"] and ck["moved_sharded"] > 0
    assert ck["moved_mesh"] == [str([[0], [1], [2], [3]])]


def test_make_production_mesh_refuses_a_group_of_the_wrong_size(port):
    one, two = port[0]["production"]
    assert "256" in one and "has 4" in one
    assert "512" in two and "has 4" in two


def test_make_production_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh()


def test_staging_backend_runs_gloo_on_host_tensors(tmp_path):
    """The port's staging backend (``"port"``) in a world of one rank: CPU
    tensors go to gloo as they are and nothing is staged (staging is for
    CUDA tensors, held on the card by ``tools/gloo_cuda_probe.py --backend
    port`` and ``chip_smoke.py`` phase ``mesh``)."""
    staging.register()
    staging.reset_counts()
    dist.init_process_group(staging.BACKEND, init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        t = torch.arange(4.0)
        dist.all_reduce(t)
        out = torch.empty(4)
        dist.all_gather_into_tensor(out, torch.arange(4.0))
        assert torch.equal(t, torch.arange(4.0)) and torch.equal(out, torch.arange(4.0))
        assert dist.get_backend() == staging.BACKEND and staging.staged_bytes() == {}
    finally:
        dist.destroy_process_group()
