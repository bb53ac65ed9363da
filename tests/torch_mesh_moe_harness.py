"""The reference's side and the port's side of ``tests/test_torch_mesh_moe.py``.

:func:`reference_outputs` runs :func:`reference_main` in one JAX child with
8 forced host devices: the reference's sharding specs (``param_shardings``,
``opt_state_shardings``, ``batch_shardings``, ``cache_shardings`` on a
(data=2, model=2) mesh) for Arctic and DeepSeek-V3 at full width under
three shapes and three profiles, its ``moe_block`` in both dispatch forms on
inputs the router overloads, its absorbed ``mla_decode`` over 8 steps, its
one-process continuous engine and one train step of each float32 smoke
config, and its serving launcher with ``--mesh 2x2`` on a checkpoint of the
reference's bf16 smoke weights, which the child writes. Inputs and outputs
go to an ``.npz``, the specs as JSON. :func:`port_main` is the port's side,
one group of cases (:data:`PORT_GROUPS`) at a time, run on every rank of a
4-rank gloo world of the group's own (``torch_ranks_harness.run_ranks``) over
the same inputs. Nothing here imports JAX outside the child.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np

MESH = ((2, 2), ("data", "model"))
ARCHS = ("deepseek-v3-671b", "arctic-480b")
SHAPES = ("train_4k", "decode_32k", "long_500k")
PROFILES = ("baseline", "opt", "resident")  # resident: the reference's moe_resident lever alone
SPEC_CASES = [(a, s, p) for a in ARCHS for s in SHAPES for p in PROFILES]
CACHE = (4, 64)  # the cache whose shardings are compared: slots, positions
MOE_X = (4, 16, 10.0)  # batch, sequence, the push towards expert 0 (in router-column norms)
FORMS = ("scatter", "gather")
MLA_STEPS, MLA_B, MLA_SMAX = 8, 4, 8  # the cache's kv_seq blocks hold 4 positions: step 4 crosses
PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 10, 1], [2], [7, 5, 5, 5, 1, 2]]
ENGINE = dict(n_slots=4, max_len=16, buckets=(8, 16), max_new_tokens=8)  # kv_seq blocks of 8: decode crosses
SERVE_SHAPE = ("serve-test", "decode", 16, 4)
MAX_NEW, SYNC = 6, 2
OPT_CFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_BATCH = (4, 16, 5)  # batch, sequence, seed
TRAIN_CASES = [(a, p, "float32") for a in ARCHS for p in ("baseline", "opt")] + \
    [("deepseek-v3-671b", "opt", "bfloat16")]  # big_model's bf16 moments
RANK_K, RANK_R, RANK_KILLS = 2, 2, ((2, 3),)  # the rank form over the four ranks as hosts
LAUNCH_PROMPTS = "1,2,3;7,8"


def _spec(s) -> list:
    """A PartitionSpec (or the port's tuple) as JSON: entries None, a name or
    a list of names."""
    return [None if e is None else e if isinstance(e, str) else list(e) for e in tuple(s)]


def _repo() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch_argv(arch: str, ckpt: str) -> list:
    return ["--arch", arch, "--smoke", "--mesh", "2x2", "--prompts", LAUNCH_PROMPTS, "--max-new", "6", "--ckpt", ckpt]


# ---------------------------------------------------------------------------
# the reference, in a JAX child
# ---------------------------------------------------------------------------


def reference_main(path: str, ckpt_dir: str):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.launch.serve as r_serve
    from repro.configs import SHAPES as R_SHAPES
    from repro.configs import get, smoke_config
    from repro.configs.base import ShapeSpec
    from repro.dist.sharding import ShardingRules
    from repro.launch import profiles as RP
    from repro.models import build_model
    from repro.models import layers as RL
    from repro.models import mla as RMLA
    from repro.models.inputs import make_batch
    from repro.obs.metrics import MetricsRegistry
    from repro.serve import ContinuousEngine, Request
    from repro.train import save_checkpoint
    from repro.train import train_loop as TL
    from repro.train.optimizer import OptConfig, init_state

    assert jax.device_count() == 8
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(MESH[0]), MESH[1])
    profiles = {"baseline": RP.BASELINE, "opt": RP.OPT, "resident": RP.Profile("resident", moe_resident=True)}
    out: dict = {}
    specs: dict = {}
    for arch, shape, prof in SPEC_CASES:
        model = build_model(get(arch))
        rules = RP.rules_for(get(arch), R_SHAPES[shape], profiles[prof])
        key = f"{arch}/{shape}/{prof}"
        specs[key + "/params"] = [_spec(s.spec) for s in jax.tree.leaves(TL.param_shardings(model, mesh, rules))]
        specs[key + "/opt"] = [_spec(s.spec) for s in jax.tree.leaves(TL.opt_state_shardings(None, model, mesh, rules))]
        kind = "decode" if R_SHAPES[shape].kind == "decode" else "train"
        specs[key + "/batch"] = {k: _spec(v.spec) for k, v in TL.batch_shardings(model, mesh, rules, kind).items()}
        cache = jax.eval_shape(lambda: model.init_cache(*CACHE))
        specs[key + "/cache"] = [_spec(s.spec) for s in jax.tree.leaves(TL.cache_shardings(model, mesh, rules, cache))]
    out["specs"] = np.array(json.dumps(specs))

    for arch in ARCHS:
        cfg = smoke_config(arch).replace(dtype="float32")
        # moe_block in both forms, on tokens pushed towards expert 0: the router overloads it
        mp = RL.moe_init(jax.random.key(1), cfg, jnp.float32)
        for k, v in zip(("router", "w_gate", "w_up", "w_down"), (mp["router"], mp["w_gate"], mp["w_up"], mp["w_down"])):
            out[f"moe/{arch}/p/{k}"] = np.asarray(v)
        if "shared" in mp:
            for k, v in mp["shared"].items():
                out[f"moe/{arch}/p/shared/{k}"] = np.asarray(v)
        B, S, push = MOE_X
        r0 = np.asarray(mp["router"])[:, 0]
        x = np.random.default_rng(4).normal(size=(B, S, cfg.d_model)).astype(np.float32)
        x = (x + push * 0.05 * r0 / np.linalg.norm(r0) ** 2).astype(np.float32)  # expert 0's logit + push · 0.05
        out[f"moe/{arch}/x"] = x
        for form in FORMS:
            ctx = RL.Ctx(rules=ShardingRules().with_flags(["moe_gather"]) if form == "gather" else None)
            y, aux = RL.moe_block(mp, jnp.asarray(x), cfg, ctx)
            out[f"moe/{arch}/{form}/y"], out[f"moe/{arch}/{form}/aux"] = np.asarray(y), np.asarray(aux)
        T, E, k = B * S, cfg.moe.n_experts, cfg.moe.top_k
        lg = jnp.asarray(x).reshape(T, -1) @ mp["router"]
        if cfg.moe.router_softmax_topk:
            _, eidx = jax.lax.top_k(jax.nn.softmax(lg, axis=-1), k)
        else:
            _, eidx = jax.lax.top_k(lg, k)
        C = max(int(np.ceil(T * k / E * cfg.moe.capacity_factor)), 4)
        load = np.bincount(np.asarray(eidx).reshape(-1), minlength=E)
        out[f"moe/{arch}/dropped"] = np.array(int(np.maximum(load - C, 0).sum()))

        # the continuous engine, one process, float32
        m = build_model(cfg)
        params = m.init(jax.random.key(0))
        for i, leaf in enumerate(jax.tree.leaves(params)):
            out[f"params/{arch}/{i}"] = np.asarray(leaf)
        eng = ContinuousEngine(m, params, **ENGINE, metrics=MetricsRegistry())
        reqs = [Request(id=f"r{i}", prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(PROMPTS)]
        for i, r in enumerate(eng.serve(reqs, greedy=True, sync_every=SYNC).results):
            out[f"tokens/{arch}/{i}"] = np.asarray(r.tokens, np.int64)

        # the launcher with --mesh 2x2 on a checkpoint of the bf16 smoke weights
        ck = os.path.join(ckpt_dir, arch)
        rm = build_model(smoke_config(arch))
        save_checkpoint(ck, rm.init(jax.random.key(0)), step=1)
        sys.argv = ["repro.launch.serve", *launch_argv(arch, ck)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r_serve.main()
        out[f"launch/{arch}"] = np.array(json.dumps(buf.getvalue().splitlines()))

    b = make_batch(smoke_config(ARCHS[0]), TRAIN_BATCH[0], TRAIN_BATCH[1], seed=TRAIN_BATCH[2])
    for k, v in b.items():
        out[f"batch/{k}"] = np.asarray(v)
    for arch, prof, mdt in TRAIN_CASES:
        if prof != "baseline" and mdt == "float32":
            continue  # the reference's step is one program; the port's profiles are held against it
        cfg = smoke_config(arch).replace(dtype="float32")
        m = build_model(cfg)
        params = m.init(jax.random.key(0))
        ocfg = OptConfig(**OPT_CFG, moment_dtype=mdt)
        rules = RP.rules_for(cfg, ShapeSpec("t", "train", TRAIN_BATCH[1], TRAIN_BATCH[0]), RP.BASELINE)
        newp, news, met = jax.jit(TL.make_train_step(m, ocfg, rules=rules))(
            params, init_state(ocfg, params), {k: jnp.asarray(v) for k, v in b.items()})
        key = f"step/{arch}/{mdt}"
        for i, leaf in enumerate(jax.tree.leaves(newp)):
            out[f"{key}/params/{i}"] = np.asarray(leaf)
        for k in ("loss", "ce", "aux", "grad_norm", "lr", "mtp_ce"):
            if k in met:
                out[f"{key}/{k}"] = np.asarray(met[k])

    # the absorbed MLA decode, 8 steps, float32
    cfg = smoke_config(ARCHS[0]).replace(dtype="float32")
    mp = RMLA.mla_init(jax.random.key(3), cfg, jnp.float32)
    for k, v in mp.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out[f"mla/p/{k}/{kk}"] = np.asarray(vv)
        else:
            out[f"mla/p/{k}"] = np.asarray(v)
    cache = RMLA.mla_cache_init(cfg, MLA_B, MLA_SMAX, jnp.float32)
    rng = np.random.default_rng(7)
    for t in range(MLA_STEPS):
        x = rng.normal(size=(MLA_B, 1, cfg.d_model)).astype(np.float32)
        pos = mla_positions(t)
        y, cache = RMLA.mla_decode(mp, jnp.asarray(x), cfg, cache, jnp.asarray(pos))
        out[f"mla/x/{t}"], out[f"mla/y/{t}"] = x, np.asarray(y)
    out["mla/c_kv"], out["mla/k_rope"] = np.asarray(cache["c_kv"]), np.asarray(cache["k_rope"])
    np.savez(path, **out)


def mla_positions(t: int) -> np.ndarray:
    """Step t's positions of the four slots: two walk 0..7 (crossing the
    boundary of the model axis's blocks at 4), one stops at 5, one walks
    down from 7."""
    return np.array([t, t, min(t, 5), MLA_SMAX - 1 - t], np.int32)


def reference_outputs(tmp_dir: str) -> str:
    """Run :func:`reference_main` in a child with 8 forced host devices;
    returns the path of the ``.npz`` it wrote (the checkpoints it wrote lie
    beside it, one directory an arch)."""
    path = os.path.join(tmp_dir, "mesh_moe_reference.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(_repo(), "src"), os.path.join(_repo(), "tests")])
    code = f"import torch_mesh_moe_harness as h; h.reference_main({path!r}, {tmp_dir!r})"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=900)
    assert r.returncode == 0, f"reference child failed:\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return path


# ---------------------------------------------------------------------------
# the port, on every rank of one world
# ---------------------------------------------------------------------------


def _leaves_from(ref, prefix: str, specs):
    """The reference's arrays ``{prefix}{i}`` as tensors in the tree of
    ``specs``."""
    import torch

    from repro_torch import tree

    leaves, treedef = tree.flatten(specs)
    return tree.unflatten(treedef, [torch.from_numpy(ref[f"{prefix}{i}"]) for i in range(len(leaves))])


def _dropped(moe_route, moe_capacity, router, x, cfg) -> int:
    """Pairs the router sends past an expert's capacity, on the global tokens."""
    import torch

    T = x.shape[0] * x.shape[1]
    _, _, eidx = moe_route(router, x.reshape(T, -1), cfg)
    load = torch.bincount(eidx.reshape(-1), minlength=cfg.moe.n_experts)
    return int(torch.clamp_min(load - moe_capacity(T, cfg), 0).sum())


#: the port's cases in groups, each run in a 4-rank world of its own (``port_main``'s ``group``)
PORT_GROUPS = ("init", "moe", "mla", "engines", "train", "launch")


def port_main(rank: int, world: int, ref_path: str, ckpt_dir: str, group: str) -> dict:
    """The port cases of ``group`` (one of :data:`PORT_GROUPS`) on this
    rank; rank 0 returns the whole results, the others what every rank must
    agree on (the engines' tokens)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    ref = dict(np.load(ref_path))
    mesh = make_mesh(*MESH, device="cpu")
    res = {"init": _port_init, "moe": _port_moe, "mla": _port_mla, "engines": _port_engines,
           "train": _port_train, "launch": _port_launch}[group](rank, world, ref, mesh, ckpt_dir)
    dist.barrier()
    agreed = {k: res[k] for k in ("engine", "guarded") if k in res}
    return _numpy(res) if rank == 0 else _numpy(agreed)


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _profiles() -> dict:
    from repro_torch.launch.profiles import BASELINE, OPT, profile_with

    return {"baseline": BASELINE, "opt": OPT, "resident": profile_with("resident", moe_resident=True)}


def _serve_rules(cfg, prof: str):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.profiles import rules_for

    return rules_for(cfg, ShapeSpec(*SERVE_SHAPE), _profiles()[prof])


def _requests():
    from repro_torch.serve import Request

    return [Request(id=f"r{i}", prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(PROMPTS)]


def _params_of(ref, arch: str):
    """(model, the reference's float32 smoke weights) of ``arch``."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    model = build_model(smoke_config(arch).replace(dtype="float32"))
    return model, _leaves_from(ref, f"params/{arch}/", model.param_specs())


def _port_init(rank, world, ref, mesh, ckpt_dir) -> dict:
    """``Model.init(shardings=)`` against ``place(init)``, whole leaves and in slabs."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch import tree
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.train.train_loop import param_shardings, place

    init = {}
    for arch in ARCHS:
        cfg = smoke_config(arch)
        model = build_model(cfg)
        for prof in ("baseline", "opt"):
            ps = param_shardings(model, mesh, _serve_rules(cfg, prof))
            for slab in (L.SLAB_ELEMENTS, 64 * 32):
                saved, L.SLAB_ELEMENTS = L.SLAB_ELEMENTS, slab
                try:
                    a = model.init(torch.Generator().manual_seed(0), shardings=ps)
                    b = place(model.init(torch.Generator().manual_seed(0)), ps)
                finally:
                    L.SLAB_ELEMENTS = saved
                init[f"{arch}/{prof}/{slab}"] = all(
                    isinstance(x, DTensor) and tuple(x.placements) == tuple(y.placements) and x.shape == y.shape
                    and x.to_local().is_contiguous() and torch.equal(x.to_local(), y.to_local())
                    for x, y in zip(tree.leaves(a), tree.leaves(b), strict=True))
    return {"init": init}


def _port_moe(rank, world, ref, mesh, ckpt_dir) -> dict:
    """``moe_block`` on the mesh, both forms, three profiles."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.sharding import named_sharding
    from repro_torch.launch.profiles import rules_for
    from repro_torch.models import layers as L
    from repro_torch.train.train_loop import place

    moe = {}
    for arch in ARCHS:
        cfg = smoke_config(arch).replace(dtype="float32")
        pre = f"moe/{arch}/p/"
        mp = {k[len(pre):]: torch.from_numpy(v) for k, v in ref.items() if k.startswith(pre) and "/shared/" not in k}
        if f"{pre}shared/w_gate" in ref:
            mp["shared"] = {k: torch.from_numpy(ref[f"{pre}shared/{k}"]) for k in ("w_gate", "w_up", "w_down")}
        x = torch.from_numpy(ref[f"moe/{arch}/x"])
        for prof in PROFILES:
            for form in FORMS:
                rules = rules_for(cfg, ShapeSpec("t", "train", x.shape[1], x.shape[0]), _profiles()[prof])
                if form == "gather":
                    rules = rules.with_flags(["moe_gather"])
                specs = L.moe_specs(cfg)
                p = place(mp, _shardings(named_sharding, mesh, rules, specs, mp))
                xd = named_sharding(mesh, rules, ("batch", "seq", "d_model"), tuple(x.shape)).place(x)
                y, aux = L.moe_block(p, xd, cfg, L.Ctx(mesh, rules))
                moe[f"{arch}/{prof}/{form}"] = dict(y=_whole(y), aux=float(_whole(aux)),
                                                    dropped=_dropped(L.moe_route, L.moe_capacity, mp["router"], x, cfg),
                                                    placed=isinstance(y, DTensor))
    return {"moe": moe}


def _port_mla(rank, world, ref, mesh, ckpt_dir) -> dict:
    """The absorbed MLA decode over 8 steps, the cache split over kv_seq."""
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.sharding import named_sharding
    from repro_torch.launch.profiles import rules_for
    from repro_torch.models import layers as L
    from repro_torch.models import mla as MLA
    from repro_torch.train.train_loop import place

    mla = {}
    cfg = smoke_config(ARCHS[0]).replace(dtype="float32")
    pre = "mla/p/"
    flat = {k[len(pre):]: torch.from_numpy(v) for k, v in ref.items() if k.startswith(pre)}
    mp = {}
    for k, v in flat.items():
        if "/" in k:
            mp.setdefault(k.split("/")[0], {})[k.split("/")[1]] = v
        else:
            mp[k] = v
    for prof in ("baseline", "opt"):
        rules = rules_for(cfg, ShapeSpec("d", "decode", MLA_SMAX, MLA_B), _profiles()[prof])
        p = place(mp, _shardings(named_sharding, mesh, rules, MLA.mla_specs(cfg), mp))
        c0 = MLA.mla_cache_init(cfg, MLA_B, MLA_SMAX, torch.float32, "cpu")
        cache = place(c0, _shardings(named_sharding, mesh, rules, MLA.mla_cache_dims(), c0))
        ys = []
        for t in range(MLA_STEPS):
            x = named_sharding(mesh, rules, ("batch", "seq", "d_model"), (MLA_B, 1, cfg.d_model)).place(
                torch.from_numpy(ref[f"mla/x/{t}"]))
            y, out = MLA.mla_decode(p, x, cfg, cache, torch.from_numpy(mla_positions(t)), L.Ctx(mesh, rules))
            assert out is cache
            ys.append(_whole(y))
        mla[prof] = dict(y=ys, c_kv=_whole(cache["c_kv"]), k_rope=_whole(cache["k_rope"]),
                         split=[str(pl) for pl in cache["c_kv"].placements])
        # the same steps in one process, on the same values
        c1 = MLA.mla_cache_init(cfg, MLA_B, MLA_SMAX, torch.float32, "cpu")
        for t in range(MLA_STEPS):
            MLA.mla_decode(mp, torch.from_numpy(ref[f"mla/x/{t}"]), cfg, c1, torch.from_numpy(mla_positions(t)))
        mla[prof]["one"] = dict(c_kv=c1["c_kv"], k_rope=c1["k_rope"])
    return {"mla": mla}


def _port_engines(rank, world, ref, mesh, ckpt_dir) -> dict:
    """The 2x2 continuous engine, float32, on the reference's weights; then
    the rank form of the guard on the meshed DeepSeek-V3 engine, host 3
    killed."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import CodedServeGuard, ContinuousEngine, FaultInjector

    engine = {}
    for arch in ARCHS:
        model, params = _params_of(ref, arch)
        for prof in ("baseline", "opt"):
            eng = ContinuousEngine(model, params, **ENGINE, mesh=mesh, rules=_serve_rules(model.cfg, prof),
                                   metrics=MetricsRegistry())
            engine[f"{arch}/{prof}"] = [r.tokens for r in eng.serve(_requests(), greedy=True, sync_every=SYNC).results]

    model, params = _params_of(ref, ARCHS[0])
    hosts = make_mesh((world,), ("hosts",), group=dist.new_group(backend="gloo"), device="cpu")
    guard = CodedServeGuard(K=RANK_K, R=RANK_R, injector=FaultInjector(kills=RANK_KILLS), mesh=hosts, axis="hosts")
    rep = ContinuousEngine(model, params, **ENGINE, mesh=mesh, rules=_serve_rules(model.cfg, "opt"),
                           metrics=MetricsRegistry()).serve(_requests(), greedy=True, sync_every=SYNC, guard=guard)
    guarded = dict(tokens=[r.tokens for r in rep.results], stats=rep.coded, alive=sorted(guard.alive))
    return {"engine": engine, "guarded": guarded}


def _port_train(rank, world, ref, mesh, ckpt_dir) -> dict:
    """One train step of each smoke config on the mesh."""
    from repro_torch import tree
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.profiles import rules_for
    from repro_torch.train import OptConfig, init_state, make_train_step
    from repro_torch.train.data import to_device
    from repro_torch.train.train_loop import batch_shardings, opt_state_shardings, param_shardings, place

    steps = {}
    batch = to_device({k[len("batch/"):]: ref[k] for k in ref if k.startswith("batch/")}, "cpu")
    for arch, prof, mdt in TRAIN_CASES:
        model, params = _params_of(ref, arch)
        ocfg = OptConfig(**OPT_CFG, moment_dtype=mdt)
        rules = rules_for(model.cfg, ShapeSpec("t", "train", TRAIN_BATCH[1], TRAIN_BATCH[0]), _profiles()[prof])
        psh, osh = param_shardings(model, mesh, rules), opt_state_shardings(ocfg, model, mesh, rules)
        bsh = batch_shardings(model, mesh, rules)
        p0, s0 = place(params, psh), place(init_state(ocfg, params), osh)
        newp, news, met = make_train_step(model, ocfg, rules=rules, mesh=mesh)(
            p0, s0, place(batch, {k: bsh[k] for k in batch}))
        steps[f"{arch}/{prof}/{mdt}"] = dict(
            params=[_whole(t) for t in tree.leaves(newp)], metrics={k: float(_whole(v)) for k, v in met.items()},
            kept=all(tuple(a.placements) == tuple(b.placements)
                     for a, b in zip(tree.leaves((newp, news["m"], news["v"])), tree.leaves((p0, s0["m"], s0["v"])))),
            moments={str(t.dtype) for t in tree.leaves((news["m"], news["v"]))})
    return {"train": steps}


def _port_launch(rank, world, ref, mesh, ckpt_dir) -> dict:
    """The serving launcher with --mesh 2x2 on the reference's checkpoints (rank 0 prints)."""
    from repro_torch.launch.serve import main as serve_main

    launch = {}
    for arch in ARCHS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_main([*launch_argv(arch, os.path.join(ckpt_dir, arch)), "--device", "cpu"])
        launch[arch] = buf.getvalue().splitlines()
    return {"launch": launch}


def _shardings(named_sharding, mesh, rules, dims, values):
    """One ``NamedSharding`` a leaf of ``values``, from the dims tree ``dims``
    (a nested dict of the same keys)."""
    if isinstance(values, dict):
        return {k: _shardings(named_sharding, mesh, rules, dims[k], v) for k, v in values.items()}
    return named_sharding(mesh, rules, dims, tuple(values.shape))


def _numpy(x):
    """Tensors as numpy arrays (a tensor through the result queue would pass
    a shared-memory handle that dies with the rank)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_numpy(v) for v in x]
    return x
