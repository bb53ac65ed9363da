"""Differential tests of the port's sharding rules and profiles
(``repro_torch.dist.sharding``, ``launch.rules``, ``launch.profiles``,
``launch.roofline.param_counts``, ``Model.param_dims``) against the JAX
package on the CPU.

Everything here is host arithmetic over names, integers and plans, so every
comparison is equality: the rules' axes and flags, each partition spec (a
plain tuple in the port, ``tuple(PartitionSpec(...))`` in the reference),
the logical dims trees, the parameter counts, and the autotuner's choice
(algorithm, pipeline, plan levels, prices). Every case of
``tests/test_profiles.py`` is here, with a ``launch.mesh.RankMesh`` (a tuple
``shape`` beside ``axis_names``) in place of a JAX mesh; the last one trains
the Arctic smoke config under ``OPT``'s rules, since Jamba waits for Mamba
(ROADMAP.md queue A4.3).
"""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from repro.configs import ARCHS as R_ARCHS
from repro.configs import SHAPES as R_SHAPES
from repro.configs import smoke_config as r_smoke_config
from repro.dist.sharding import DEFAULT_RULES as R_DEFAULT_RULES
from repro.dist.sharding import ShardingRules as RShardingRules
from repro.dist.sharding import spec_for as r_spec_for
from repro.launch import profiles as RP
from repro.launch.roofline import param_counts as r_param_counts
from repro.launch.rules import big_model as r_big_model
from repro.models import build_model as r_build_model
from repro.train import OptConfig as ROptConfig
from repro.train import init_state as r_init_state
from repro.train import make_train_step as r_make_train_step
from repro_torch import tree
from repro_torch.configs import SHAPES, get, smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.dist import sharding
from repro_torch.dist.sharding import DEFAULT_RULES, ShardingRules, constrain, named_sharding, spec_for
from repro_torch.launch.mesh import RankMesh, production_topology
from repro_torch.launch.profiles import (
    BASELINE,
    OPT,
    Profile,
    apply_profile_cfg,
    generator_kind_for,
    profile_with,
    resolve_profile,
    rules_for,
)
from repro_torch.launch.roofline import param_counts
from repro_torch.launch.rules import big_model
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model
from repro_torch.train import OptConfig, init_state, make_train_step

PROFILES = {
    "baseline": BASELINE,
    "opt": OPT,
    "moe_resident": Profile("x", moe_resident=True),
    "dp_only": Profile("x", dp_only=True),
    "gather": profile_with("gather", moe_gather=True),
}
PORTED = ["qwen3-1.7b", "qwen1.5-32b", "deepseek-coder-33b", "internlm2-20b", "arctic-480b", "deepseek-v3-671b"]


def r_profile(p: Profile):
    return RP.Profile(**dataclasses.asdict(p))


def rank_mesh(shape, names) -> RankMesh:
    """A mesh-like object: the port's mesh of ranks, without a group."""
    n = int(np.prod(shape))
    return RankMesh(None, tuple(shape), tuple(names), 0, (0,) * len(shape), tuple(range(n)), torch.device("cpu"))


def same_rules(got: ShardingRules, want: RShardingRules):
    names = set(DEFAULT_RULES) | set(R_DEFAULT_RULES) | {"no_such_dim"}
    assert {n: got.axes_for(n) for n in names} == {n: want.axes_for(n) for n in names}
    assert got.flags == want.flags


# ---------------------------------------------------------------------------
# ShardingRules and spec_for
# ---------------------------------------------------------------------------


def test_default_rules_and_rule_algebra_equal_the_reference():
    assert DEFAULT_RULES == R_DEFAULT_RULES
    r, rr = ShardingRules(), RShardingRules()
    same_rules(r, rr)
    o = r.override(seq="model", d_model=("data",), kv_seq=None).with_flags(["moe_gather"])
    ro = rr.override(seq="model", d_model=("data",), kv_seq=None).with_flags(["moe_gather"])
    same_rules(o, ro)
    assert o.axes_for("seq") == ("model",) and o.has("moe_gather") and not r.has("moe_gather")
    assert o == ShardingRules({"seq": "model", "d_model": "data"}, ["moe_gather"]) and o != r and r != "rules"
    assert hash(o) == hash(ShardingRules({"seq": ("model",), "d_model": ("data",)}, ["moe_gather"]))
    assert repr(o) == repr(ro)
    with pytest.raises(AttributeError):
        r.extra = 1  # immutable


@pytest.mark.parametrize("shape, names", [((2, 4), ("data", "model")), ((2, 2, 4), ("pod", "data", "model")),
                                          ((1, 1), ("data", "model")), ((3,), ("model",))])
@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("arch", ["arctic-480b", "qwen3-1.7b", "deepseek-v3-671b"])
def test_spec_for_every_parameter_leaf_equals_the_reference(arch, profile, shape, names):
    """Every parameter leaf of the model's dims tree, on meshes with and
    without a pod axis and with axes that do not divide some dims, under the
    rules of each profile for train and decode (DeepSeek-V3 at 4 layers: its
    3 dense prefix layers, one MoE layer and MTP)."""
    n_layers = 4 if arch == "deepseek-v3-671b" else 2
    cfg = get(arch).replace(n_layers=n_layers)
    m = build_model(cfg)
    dims, specs = m.param_dims(), m.param_specs()
    r_dims = r_build_model(R_ARCHS[arch].replace(n_layers=n_layers))._dims_tree()
    assert dims == r_dims
    mesh, r_mesh = rank_mesh(shape, names), SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)
    leaves = tree.leaves(specs)
    flat_dims = _flat_dims(dims, specs)
    assert len(flat_dims) == len(leaves)
    for shape_kind in ("train_4k", "decode_32k"):
        rules = rules_for(cfg, SHAPES[shape_kind], PROFILES[profile])
        r_rules = RP.rules_for(R_ARCHS[arch].replace(n_layers=n_layers), R_SHAPES[shape_kind],
                               r_profile(PROFILES[profile]))
        same_rules(rules, r_rules)
        for t, d in zip(leaves, flat_dims):
            for shp in (tuple(t.shape), None):
                got = spec_for(mesh, rules, d, shp)
                assert isinstance(got, tuple) and got == tuple(r_spec_for(r_mesh, r_rules, d, shp)), (d, shp)


def _flat_dims(dims, like) -> list:
    """The dims tree's tuples in the order of ``like``'s leaves."""
    if isinstance(like, dict):
        return [d for k in sorted(like) for d in _flat_dims(dims[k], like[k])]
    return [dims]


def test_spec_for_on_a_mapping_mesh_and_its_edges():
    r = ShardingRules().override(batch=("pod", "data", "model"))
    mesh = SimpleNamespace(shape={"data": 2, "model": 4}, axis_names=("data", "model"))
    assert spec_for(mesh, r, ("batch", None, "heads")) == (("data", "model"), None, None)  # model used once
    assert spec_for(mesh, r, ("batch",), (6,)) == ("data",)  # 6 % 8 != 0: model dropped
    assert spec_for(mesh, None, ("vocab", "d_ff"), (5, 8)) == (None, "model")  # 5 % 4: vocab replicated
    for args in ((r, ("batch", None, "heads")), (r, ("batch",), (6,)), (None, ("vocab", "d_ff"), (5, 8))):
        assert spec_for(mesh, *args) == tuple(r_spec_for(mesh, *(RShardingRules().override(
            batch=("pod", "data", "model")) if args[0] is not None else None, *args[1:])))
    assert spec_for(rank_mesh((2, 4), ("data", "model")), None, ("d_ff",)) == ("model",)


@pytest.mark.parametrize("fn", [named_sharding, lambda *a: constrain(torch.ones(2), *a[:2], ("batch",))])
def test_placing_across_devices_waits_for_a3(fn):
    mesh = rank_mesh((1, 1), ("data", "model"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A3"):
        fn(mesh, ShardingRules(), ("batch",))
    assert sharding.__all__ == ["ShardingRules", "spec_for", "named_sharding", "constrain", "DEFAULT_RULES"]


# ---------------------------------------------------------------------------
# rules_for, profiles, param_counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("profile", sorted(PROFILES) + ["no_fsdp", "ep"])
@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_rules_for_every_arch_shape_and_profile_equal_the_reference(arch, profile):
    prof = PROFILES.get(profile) or Profile(profile, no_fsdp=profile == "no_fsdp", moe_ep=profile == "ep")
    for name in SHAPES:
        same_rules(rules_for(get(arch), SHAPES[name], prof), RP.rules_for(R_ARCHS[arch], R_SHAPES[name],
                                                                           r_profile(prof)))
    assert big_model(get(arch)) == r_big_model(R_ARCHS[arch])
    assert dataclasses.asdict(apply_profile_cfg(get(arch), OPT)) == \
        dataclasses.asdict(RP.apply_profile_cfg(R_ARCHS[arch], RP.OPT))


@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_param_counts_equal_the_reference(arch):
    assert param_counts(get(arch)) == r_param_counts(R_ARCHS[arch])
    assert param_counts(smoke_config(arch)) == r_param_counts(r_smoke_config(arch))


def test_param_counts_of_the_ported_models_count_their_matrices():
    """The count leaves out norm scales and nothing else of a ported model,
    and, as the reference's, the MTP head (DeepSeek-V3, at 4 layers: its 3
    dense prefix layers and one MoE layer)."""
    for arch in PORTED:
        cfg = get(arch).replace(n_layers=4 if arch == "deepseek-v3-671b" else 2)
        names = tree.flatten_with_names(build_model(cfg).param_specs())
        n = sum(t.numel() for k, t in names.items()
                if k.split("/")[-1] not in ("scale", "bq", "bk", "bv") and not k.startswith("mtp/"))
        assert n == param_counts(cfg)["total"], arch


def test_moe_resident_unshards_expert_d():
    cfg = get("deepseek-v3-671b")
    shape = SHAPES["train_4k"]
    base = rules_for(cfg, shape, BASELINE)
    opt = rules_for(cfg, shape, Profile("x", moe_resident=True))
    assert base.axes_for("expert_d") == ("data",)
    assert opt.axes_for("expert_d") == ()
    assert opt.axes_for("experts") == ("model", "data")


def test_dp_only_batch_all_axes():
    mesh = rank_mesh((1, 1), ("data", "model"))
    cfg = get("qwen3-1.7b")
    r = rules_for(cfg, SHAPES["train_4k"], Profile("x", dp_only=True))
    assert r.axes_for("batch") == ("pod", "data", "model")
    assert r.axes_for("d_model") == ()
    # spec on a (batch=256, seq) array over (data=1, model=1) degrades fine
    assert spec_for(mesh, r, ("batch", "seq"), (256, 4096)) == (("data", "model"), None)


def test_flags_propagate():
    cfg = get("qwen3-1.7b")
    r = rules_for(cfg, SHAPES["train_4k"], Profile("x", attn_heads=True, logits_vocab=True))
    assert r.has("attn_heads") and r.has("logits_vocab")
    assert not rules_for(cfg, SHAPES["train_4k"], BASELINE).has("attn_heads")
    assert rules_for(get("arctic-480b"), SHAPES["decode_32k"], profile_with("g", moe_gather=True)).has("moe_gather")


def test_decode_rules_shard_kv_seq():
    cfg = get("deepseek-coder-33b")
    r = rules_for(cfg, SHAPES["decode_32k"], BASELINE)
    assert r.axes_for("kv_seq") == ("model",)
    r5 = rules_for(get("rwkv6-3b"), SHAPES["long_500k"], BASELINE)
    assert r5.axes_for("kv_seq") == ("data", "model")


# ---------------------------------------------------------------------------
# resolve_profile: the coded checkpoint's encode, chosen by the autotuner
# ---------------------------------------------------------------------------


def same_choice(got, want):
    assert got.algorithm == want.algorithm and got.pipeline == want.pipeline
    assert got.levels == want.levels and tuple(got.topology.levels) == tuple(want.topology.levels)
    assert (got.plan is None) == (want.plan is None)
    if got.plan is not None:
        assert type(got.plan).__name__ == type(want.plan).__name__
        assert getattr(got.plan, "levels", None) == getattr(want.plan, "levels", None)
    assert [(c.algorithm, c.predicted_time) for c in got.tune.candidates] == \
        [(c.algorithm, c.predicted_time) for c in want.tune.candidates]


@pytest.mark.parametrize("multi_pod", [True, False])
def test_resolve_profile_picks_hierarchical_from_mesh_topology(multi_pod):
    prof = resolve_profile(multi_pod=multi_pod, calibration=False)
    same_choice(prof, RP.resolve_profile(multi_pod=multi_pod, calibration=False))
    if multi_pod:
        assert prof.algorithm.split("+")[0] == "multilevel"
        assert prof.levels == (4, 4, 2) == prof.plan.levels
    else:
        assert prof.algorithm.split("+")[0] == "hierarchical" and prof.levels == (4, 4)
    assert prof.topology.levels == production_topology(multi_pod=multi_pod).levels
    assert prof.tune.chosen.plan is prof.plan and prof.ir is prof.tune.chosen.ir


def test_resolve_profile_from_live_mesh_shape():
    mesh = rank_mesh((2, 2, 2), ("pod", "slice", "chip"))
    axes = ("pod", "slice", "chip")
    prof = resolve_profile(mesh=mesh, axes=axes, payload_bytes=65536, calibration=False)
    r_mesh = SimpleNamespace(shape={"pod": 2, "slice": 2, "chip": 2})
    same_choice(prof, RP.resolve_profile(mesh=r_mesh, axes=axes, payload_bytes=65536, calibration=False))
    assert prof.algorithm.split("+")[0] == "multilevel"
    assert prof.plan.levels == (2, 2, 2)
    with pytest.raises(ValueError):
        resolve_profile(mesh=mesh)  # axes required with mesh


def test_resolve_profile_measured_override():
    base = resolve_profile(multi_pod=True, calibration=False)
    slow = {c.algorithm: 1.0 for c in base.tune.candidates if c.algorithm != "prepare-shoot"}
    measured = {**slow, "prepare-shoot": 1e-9}
    forced = resolve_profile(multi_pod=True, calibration=False, measured=measured)
    assert forced.algorithm == "prepare-shoot"
    same_choice(forced, RP.resolve_profile(multi_pod=True, calibration=False, measured=measured))


def test_generator_kind_taxonomy():
    for kind in ("cauchy", "random", "general", "vandermonde", "dft"):
        assert generator_kind_for(kind) == RP.generator_kind_for(kind)
    assert generator_kind_for("cauchy") == "general" and generator_kind_for("dft") == "dft"
    with pytest.raises(ValueError, match="unknown generator matrix kind"):
        generator_kind_for("hilbert")


def test_resolve_profile_threads_generator_kind():
    from repro_torch.core.field import NTT

    default = resolve_profile(multi_pod=False, calibration=False)
    names = {c.base_algorithm for c in default.tune.candidates}
    assert "multilevel-dft" not in names and "draw-loose" not in names
    dft = resolve_profile(multi_pod=False, q=NTT, generator="dft", calibration=False, kernels="cuda")
    same_choice(dft, RP.resolve_profile(multi_pod=False, q=NTT, generator="dft", calibration=False))
    dft_names = {c.base_algorithm for c in dft.tune.candidates}
    assert "hierarchical-dft" in dft_names or "multilevel-dft" in dft_names
    assert dft.kernels == "cuda"


def test_resolve_profile_prices_with_fitted_calibration(tmp_path):
    from repro_torch.topo import LinkCost, load_fitted_costs

    rows = [
        {"level": 0, "alpha_s": 0.5, "beta_s_per_elem": 1e-6},
        {"level": 1, "alpha_s": 2.0, "beta_s_per_elem": 1e-5},
    ]
    path = tmp_path / "BENCH_topology.json"
    path.write_text(json.dumps({"calibration": {"fitted_level_costs": rows}}))
    fitted = load_fitted_costs(str(path))
    assert fitted == (LinkCost(0.5, 1e-6), LinkCost(2.0, 1e-5))
    assert load_fitted_costs(str(tmp_path / "missing.json")) is None

    prof = resolve_profile(multi_pod=False, calibration=str(path))
    assert prof.fitted_costs == fitted and tuple(prof.topology.costs) == fitted
    assert prof.tune.chosen.predicted_time > 1.0
    same_choice(prof, RP.resolve_profile(multi_pod=False, calibration=str(path)))
    base = resolve_profile(multi_pod=False, calibration=False)
    assert base.fitted_costs is None and base.tune.chosen.predicted_time < 1.0

    deep = resolve_profile(multi_pod=True, calibration=str(path))
    assert len(deep.fitted_costs) == len(deep.topology.levels) == 3
    assert deep.fitted_costs[0] == fitted[0] and deep.fitted_costs[-1] == fitted[-1]
    same_choice(deep, RP.resolve_profile(multi_pod=True, calibration=str(path)))
    # a trace that cannot be read prices on the defaults, as in the reference
    bad = tmp_path / "none.trace.json"
    same_choice(resolve_profile(multi_pod=False, calibration=str(bad)),
                RP.resolve_profile(multi_pod=False, calibration=str(bad)))


# ---------------------------------------------------------------------------
# rules in the train step and the launcher
# ---------------------------------------------------------------------------


def test_opt_profile_smoke_train_step_equals_the_reference():
    """``OPT``'s rules drive a train step of the Arctic smoke config (the
    reference's case trains Jamba, which waits for ROADMAP.md queue A4.3):
    the loss equals the reference step's under the same rules without a
    mesh, and the gather form's loss equals the scatter form's."""
    cfg, rcfg = smoke_config("arctic-480b"), r_smoke_config("arctic-480b")
    r = rules_for(cfg, SHAPES["train_4k"], OPT)
    rm = r_build_model(rcfg)
    rp = rm.init(jax.random.key(0))
    m = build_model(cfg)
    p = params_from_reference(jax.tree.map(np.asarray, rp), m, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    _, _, met = make_train_step(m, OptConfig(), rules=r)(p, init_state(OptConfig(), p), batch)
    rstep = jax.jit(r_make_train_step(rm, ROptConfig(), rules=RP.rules_for(rcfg, R_SHAPES["train_4k"], RP.OPT)))
    _, _, rmet = rstep(rp, r_init_state(ROptConfig(), rp), {"tokens": toks, "labels": toks})
    assert float(met["loss"]) > 0
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]), rtol=0, atol=1e-4)
    gather = r.with_flags(["moe_gather"])
    _, _, gmet = make_train_step(m, OptConfig(), rules=gather)(p, init_state(OptConfig(), p), batch)
    assert float(gmet["loss"]) == float(met["loss"]) and float(gmet["grad_norm"]) == float(met["grad_norm"])


def test_launcher_trains_arctic_smoke_under_both_profiles():
    argv = ["--arch", "arctic-480b", "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16", "--steps", "2",
            "--coded-every", "0"]
    runs = {prof: train_main(argv + ["--profile", prof]) for prof in ("baseline", "opt")}
    for prof, run in runs.items():
        want = RP.rules_for(r_smoke_config("arctic-480b"), R_SHAPES["train_4k"].__class__("cli", "train", 16, 2),
                            RP.OPT if prof == "opt" else RP.BASELINE)
        same_rules(run["rules"], want)
        assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in run["history"])
    assert runs["opt"]["rules"].has("attn_heads") and not runs["baseline"]["rules"].flags
    # neither profile sets a flag the model reads on one card: the same steps
    assert [h["loss"] for h in runs["opt"]["history"]] == [h["loss"] for h in runs["baseline"]["history"]]
