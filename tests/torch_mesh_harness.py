"""The reference's side and the port's side of ``tests/test_torch_mesh.py``.

:func:`reference_outputs` runs :func:`reference_main` in one JAX child with
8 forced host devices: the reference's sharding specs (``param_shardings``,
``opt_state_shardings``, ``batch_shardings``, ``cache_shardings`` on a
(data=2, model=2) mesh for Qwen3-1.7B's presets and profiles), its
``shard_map`` on two functions, its GPipe test (``tests/test_distributed.py``),
its plain continuous engine on the staggered trace of
``tests/test_serve.py``'s mesh test at float32, and one train step; inputs
and outputs go to an ``.npz``, the specs as JSON. :func:`port_main` is the
port's side, run on every rank of one 4-rank gloo world
(``torch_ranks_harness.run_ranks``) over the same inputs. Nothing here
imports JAX outside the child.
"""

from __future__ import annotations

import json
import os

import numpy as np

MESH = ((2, 2), ("data", "model"))
ARCH = "qwen3-1.7b"
SPEC_CASES = [(shape, prof) for shape in ("train_4k", "decode_32k", "long_500k") for prof in ("baseline", "opt")]
PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 10, 1], [2], [7, 5, 5, 5, 1, 2]]
ENGINE = dict(max_len=32, buckets=(8, 16), max_new_tokens=8)
MAX_NEW = 6
SERVE_SHAPE = ("serve-test", "decode", 32, 4)
CACHE = (4, 64)  # the cache whose shardings are compared: slots, positions
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_BATCH = (4, 16, 5)  # batch, sequence, seed
PIPE = dict(S=4, d=8, N=6, mb=3)


def _small_cfg(smoke_config):
    return smoke_config(ARCH).replace(n_layers=2, dtype="float32")


def _spec(s) -> list:
    """A PartitionSpec (or the port's tuple) as JSON: entries None, a name or
    a list of names."""
    return [None if e is None else e if isinstance(e, str) else list(e) for e in tuple(s)]


# ---------------------------------------------------------------------------
# the reference, in a JAX child
# ---------------------------------------------------------------------------


def reference_main(path: str):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.configs import SHAPES, get, smoke_config
    from repro.configs.base import ShapeSpec
    from repro.dist._compat import shard_map
    from repro.dist.pipeline import pipeline_apply, stack_stage_params
    from repro.launch import profiles as RP
    from repro.models import build_model
    from repro.models.inputs import make_batch
    from repro.obs.metrics import MetricsRegistry
    from repro.serve import ContinuousEngine, Request
    from repro.train import train_loop as TL
    from repro.train.optimizer import OptConfig, init_state

    assert jax.device_count() == 8
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(MESH[0]), MESH[1])
    out: dict = {}
    specs: dict = {}
    model = build_model(get(ARCH))
    for shape, prof in SPEC_CASES:
        rules = RP.rules_for(get(ARCH), SHAPES[shape], {"baseline": RP.BASELINE, "opt": RP.OPT}[prof])
        key = f"{shape}/{prof}"
        specs[key + "/params"] = [_spec(s.spec) for s in jax.tree.leaves(TL.param_shardings(model, mesh, rules))]
        ost = TL.opt_state_shardings(None, model, mesh, rules)
        specs[key + "/opt"] = [_spec(s.spec) for s in jax.tree.leaves(ost)]
        kind = "decode" if SHAPES[shape].kind == "decode" else "train"
        specs[key + "/batch"] = {k: _spec(v.spec) for k, v in TL.batch_shardings(model, mesh, rules, kind).items()}
        cache = jax.eval_shape(lambda: model.init_cache(*CACHE))
        specs[key + "/cache"] = [_spec(s.spec) for s in jax.tree.leaves(TL.cache_shardings(model, mesh, rules, cache))]
    out["specs"] = np.array(json.dumps(specs))

    # shard_map: a blockwise product, and a psum over the model axis
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    out["sm/x"], out["sm/w"] = x, w
    f1 = shard_map(lambda a, b: a @ b, mesh, in_specs=(P("data", None), P(None, "model")), out_specs=P("data", "model"))
    out["sm/prod"] = np.asarray(jax.jit(f1)(x, w))
    f2 = shard_map(lambda a: jax.lax.psum(a, "model"), mesh, in_specs=(P(None, "model"),), out_specs=P())
    out["sm/psum"] = np.asarray(jax.jit(f2)(x))

    # the GPipe test
    pmesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
    rng = np.random.default_rng(0)
    S, d = PIPE["S"], PIPE["d"]
    plist = [(rng.normal(size=(d, d)).astype(np.float32) * 0.3, rng.normal(size=(d,)).astype(np.float32) * 0.1)
             for _ in range(S)]
    xp = rng.normal(size=(PIPE["N"], PIPE["mb"], d)).astype(np.float32)

    def stage(params, a):
        W, b = params
        return jnp.tanh(a @ W + b)

    got = jax.jit(lambda p, a: pipeline_apply(stage, p, a, mesh=pmesh, axis="pipe"))(
        stack_stage_params([tuple(jnp.asarray(t) for t in pw) for pw in plist]), jnp.asarray(xp))
    for i, (W, b) in enumerate(plist):
        out[f"pipe/W{i}"], out[f"pipe/b{i}"] = W, b
    out["pipe/x"], out["pipe/out"] = xp, np.asarray(got)

    # the plain continuous engine on the mesh test's trace, float32
    cfg = _small_cfg(smoke_config)
    m = build_model(cfg)
    params = m.init(jax.random.key(0))
    for i, leaf in enumerate(jax.tree.leaves(params)):
        out[f"params/{i}"] = np.asarray(leaf)
    eng = ContinuousEngine(m, params, n_slots=2, **ENGINE, metrics=MetricsRegistry())
    reqs = [Request(id=f"r{i}", prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(PROMPTS)]
    for i, r in enumerate(eng.serve(reqs, greedy=True, sync_every=3).results):
        out[f"tokens/{i}"] = np.asarray(r.tokens, np.int64)

    # one train step
    ocfg = OptConfig(**OPT)
    b = make_batch(smoke_config(ARCH), TRAIN_BATCH[0], TRAIN_BATCH[1], seed=TRAIN_BATCH[2])
    for k, v in b.items():
        out[f"batch/{k}"] = np.asarray(v)
    rules = RP.rules_for(cfg, ShapeSpec("t", "train", TRAIN_BATCH[1], TRAIN_BATCH[0]), RP.BASELINE)
    newp, news, met = jax.jit(TL.make_train_step(m, ocfg, rules=rules))(params, init_state(ocfg, params),
                                                                         {k: jnp.asarray(v) for k, v in b.items()})
    for i, leaf in enumerate(jax.tree.leaves(newp)):
        out[f"step/params/{i}"] = np.asarray(leaf)
    for k in ("loss", "ce", "grad_norm", "lr"):
        out[f"step/{k}"] = np.asarray(met[k])
    np.savez(path, **out)


def reference_outputs(tmp_dir: str) -> str:
    """Run :func:`reference_main` in a child with 8 forced host devices;
    returns the path of the ``.npz`` it wrote."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(tmp_dir, "mesh_reference.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(repo, "src"), os.path.join(repo, "tests")])
    code = f"import torch_mesh_harness as h; h.reference_main({path!r})"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"reference child failed:\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return path


# ---------------------------------------------------------------------------
# the port, on every rank of one world
# ---------------------------------------------------------------------------


def port_main(rank: int, world: int, ref_path: str, tmp_dir: str) -> dict:
    """Every port case on this rank; rank 0 returns the whole results."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch import tree
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist import constrain, named_sharding, pipeline_apply, shard_map, stack_stage_params
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.launch.profiles import BASELINE, rules_for
    from repro_torch.models import build_model
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import ContinuousEngine, Request
    from repro_torch.train import OptConfig, init_state, make_train_step, reshard_state, restore_checkpoint
    from repro_torch.train import save_checkpoint, state_specs
    from repro_torch.train.data import to_device
    from repro_torch.train.train_loop import batch_shardings, opt_state_shardings, param_shardings, place

    ref = dict(np.load(ref_path))
    res: dict = {}
    mesh = make_mesh(*MESH, device="cpu")
    res["coords"] = mesh.coords
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t  # noqa: E731

    # place and constrain round trips
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    rules = ShardingRules()
    sh = named_sharding(mesh, rules, ("batch", "d_ff"), full.shape)
    placed = sh.place(full)
    res["place"] = dict(spec=sh.spec, placements=[str(p) for p in placed.placements],
                        local=placed.to_local().clone(), full_equal=bool(torch.equal(placed.full_tensor(), full)))
    moved = constrain(placed, mesh, rules, ("d_ff", "batch"))
    res["constrain"] = dict(placements=[str(p) for p in moved.placements],
                            full_equal=bool(torch.equal(moved.full_tensor(), full)),
                            plain_identity=constrain(full, mesh, rules, ("batch", None)) is full,
                            replace_same=sh.place(placed) is placed)

    # shard_map against the reference's
    x, w = torch.from_numpy(ref["sm/x"]), torch.from_numpy(ref["sm/w"])
    f1 = shard_map(lambda a, b: a @ b, mesh, (("data", None), (None, "model")), ("data", "model"))
    group = mesh.axis_group("model")

    def psum(a):
        a = a.clone()
        dist.all_reduce(a, group=group)
        return a

    f2 = shard_map(psum, mesh, ((None, "model"),), (None, None))
    res["shard_map"] = dict(prod=f1(x, w), psum=f2(x))

    # the GPipe test
    pmesh = make_mesh((world,), ("pipe",), device="cpu")
    plist = [(torch.from_numpy(ref[f"pipe/W{i}"]), torch.from_numpy(ref[f"pipe/b{i}"])) for i in range(PIPE["S"])]
    stage = lambda p, a: torch.tanh(a @ p[0] + p[1])  # noqa: E731
    xp = torch.from_numpy(ref["pipe/x"])
    res["pipeline"] = pipeline_apply(stage, stack_stage_params(plist), xp, mesh=pmesh, axis="pipe")
    seq = xp
    for pw in plist:
        seq = stage(pw, seq)
    res["pipeline_sequential"] = seq

    # the 2x2 continuous engine
    cfg = _small_cfg(smoke_config)
    model = build_model(cfg)
    leaves, treedef = tree.flatten(model.param_specs())
    params = tree.unflatten(treedef, [torch.from_numpy(ref[f"params/{i}"]) for i in range(len(leaves))])
    srules = rules_for(cfg, ShapeSpec(*SERVE_SHAPE), BASELINE)
    eng = ContinuousEngine(model, params, n_slots=4, **ENGINE, mesh=mesh, rules=srules, metrics=MetricsRegistry())
    reqs = [Request(id=f"r{i}", prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(PROMPTS)]
    res["tokens"] = [r.tokens for r in eng.serve(reqs, greedy=True, sync_every=2).results]
    res["engine_placed"] = all(isinstance(t, DTensor) for t in tree.leaves(eng.params))

    # one train step
    ocfg = OptConfig(**OPT)
    trules = rules_for(cfg, ShapeSpec("t", "train", TRAIN_BATCH[1], TRAIN_BATCH[0]), BASELINE)
    psh, osh = param_shardings(model, mesh, trules), opt_state_shardings(ocfg, model, mesh, trules)
    bsh = batch_shardings(model, mesh, trules)
    p0, s0 = place(params, psh), place(init_state(ocfg, params), osh)
    batch = to_device({k[len("batch/"):]: ref[k] for k in ref if k.startswith("batch/")}, "cpu")
    newp, news, met = make_train_step(model, ocfg, rules=trules, mesh=mesh)(p0, s0, place(batch, {k: bsh[k] for k in batch}))
    res["step"] = dict(params=[whole(t) for t in tree.leaves(newp)],
                       metrics={k: float(whole(v)) for k, v in met.items()},
                       kept=all(tuple(a.placements) == tuple(b.placements)
                                for a, b in zip(tree.leaves((newp, news["m"], news["v"])), tree.leaves((p0, s0["m"], s0["v"])))),
                       step_replicated=all(isinstance(pl, Replicate) for pl in news["step"].placements))

    # the checkpoint: saved whole by rank 0, restored under shardings, resharded onto 4 x 1
    state = {"params": newp, "opt": news}
    ck = os.path.join(tmp_dir, "ckpt")
    save_checkpoint(ck, state, 1)
    like = {"params": model.param_specs(), "opt": state_specs(ocfg, model.param_specs())}
    restored, step = restore_checkpoint(ck, like, shardings={"params": psh, "opt": osh})
    mesh41 = make_mesh((4, 1), MESH[1], device="cpu")
    moved = reshard_state(state, {"params": param_shardings(model, mesh41, trules),
                                  "opt": opt_state_shardings(ocfg, model, mesh41, trules)})
    back = reshard_state(moved, {"params": psh, "opt": osh})
    full_state = [whole(t) for t in tree.leaves(state)]
    res["ckpt"] = dict(
        step=step, full=full_state, file=dict(np.load(os.path.join(ck, "state_00000001.npz"))),
        restored_local=all(torch.equal(a.to_local(), b.to_local()) and a.placements == b.placements
                           for a, b in zip(tree.leaves(restored), tree.leaves(state))),
        moved_full=all(torch.equal(whole(a), b) for a, b in zip(tree.leaves(moved), full_state)),
        moved_mesh=[str(t.device_mesh.mesh.tolist()) for t in tree.leaves(moved)][:1],
        moved_sharded=sum(any(isinstance(pl, Shard) for pl in t.placements) for t in tree.leaves(moved)),
        back_local=all(torch.equal(a.to_local(), b.to_local()) for a, b in zip(tree.leaves(back), tree.leaves(state))))
    dist.barrier()

    # the production mesh on a group of the wrong size
    errors = []
    for multi in (False, True):
        try:
            make_production_mesh(multi_pod=multi, device="cpu")
        except ValueError as e:
            errors.append(str(e))
    res["production"] = errors
    return _numpy(res) if rank == 0 else {"coords": res["coords"], "tokens": res["tokens"]}


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
