"""The reference's side and the port's side of ``tests/test_torch_coded_mesh.py``.

:func:`reference_outputs` runs :func:`reference_main` in one JAX child with 8
forced host devices: the reference's ``ContinuousEngine`` on a (data=2,
model=2) mesh at float32, plain and under ``CodedServeGuard(K=3, R=2)`` with
two scheduled kills (its first snapshot's state and coded shards kept), its
serving launcher with ``--mesh 2x2 --coded 3,2`` and without ``--coded``
(both reading one ``--ckpt`` of the reference's weights, which the child
writes), and its ``CodedStateGuard(K=8)`` snapshot of a train state after one
step. Inputs and outputs go to an ``.npz``. :func:`port_main` is the port's
side on every rank of one 4-rank gloo world, :func:`port_hosts` the port of
the reference's ``test_coded_serve_mesh_8_host_devices_sigkill`` on 8 ranks,
and :func:`collective_rows` a second JAX child that encodes the 8-rank run's
limbs with the reference's ``lcc_encode_collective`` on an 8-wide host mesh.
Nothing here imports JAX outside the children.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np

ARCH = "qwen3-1.7b"
MESH = ((2, 2), ("data", "model"))
PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 10, 1], [2], [7, 5, 5, 5, 1, 2]]
ENGINE = dict(n_slots=4, max_len=32, buckets=(8, 16), max_new_tokens=8)
SERVE_SHAPE = ("serve-test", "decode", 32, 4)
MAX_NEW, SYNC = 6, 2
K, R, KILLS = 3, 2, ((1, 0), (5, 4))  # the guard of tests/test_coded_serve.py's staggered-kill test
RANK_K, RANK_R, RANK_KILLS = 2, 2, ((2, 3),)  # the rank form over the four ranks as hosts
LAUNCH_ARGV = ["--arch", ARCH, "--smoke", "--mesh", "2x2"]
LAUNCH_CODED = ["--coded", "3,2", "--kill", "2:0", "--kill", "6:4"]
TRAIN_K = 8  # the launchers' --coded-k default
TRAIN_LOST = [1, 4, 6]
TRAIN_ARGV = ["--arch", ARCH, "--smoke", "--mesh", "2x2", "--device", "cpu", "--batch", "4", "--seq", "32",
              "--steps", "3"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_BATCH = (4, 16, 5)  # batch, sequence, seed
# the reference's test_coded_serve_mesh_8_host_devices_sigkill
HOSTS_K, HOSTS_R, HOSTS_KILLS = 6, 2, ((1, 3),)
HOSTS_PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2], [2]]
HOSTS_ENGINE = dict(n_slots=2, max_len=32, buckets=(8, 16), max_new_tokens=6)


def _repo() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(code: str, timeout: int = 600) -> None:
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(_repo(), "src"), os.path.join(_repo(), "tests")])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=timeout)
    assert r.returncode == 0, f"reference child failed:\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"


def _bits(a: np.ndarray) -> np.ndarray:
    """An array by its bits: a bfloat16 one (which ``np.savez`` cannot
    name) as uint16, anything else as it is."""
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _reqs(Request, prompts=PROMPTS, max_new=MAX_NEW):
    return [Request(id=f"r{i}", prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]


# ---------------------------------------------------------------------------
# the reference, in JAX children
# ---------------------------------------------------------------------------


def reference_main(path: str, ckpt: str):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.launch.serve as r_serve
    from repro.configs import smoke_config
    from repro.configs.base import ShapeSpec
    from repro.launch import profiles as RP
    from repro.models import build_model
    from repro.models.inputs import make_batch
    from repro.obs.metrics import MetricsRegistry
    from repro.serve import CodedServeGuard, ContinuousEngine, FaultInjector, Request
    from repro.train import CodedStateGuard, save_checkpoint
    from repro.train import train_loop as TL
    from repro.train.optimizer import OptConfig, init_state

    assert jax.device_count() == 8
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(MESH[0]), MESH[1])
    out: dict = {}

    # the 2x2 engine at float32, plain and guarded
    cfg = smoke_config(ARCH).replace(n_layers=2, dtype="float32")
    m = build_model(cfg)
    params = m.init(jax.random.key(0))
    for i, leaf in enumerate(jax.tree.leaves(params)):
        out[f"params/{i}"] = np.asarray(leaf)
    rules = RP.rules_for(cfg, ShapeSpec(*SERVE_SHAPE), RP.BASELINE)

    def engine():
        return ContinuousEngine(m, params, **ENGINE, mesh=mesh, rules=rules, metrics=MetricsRegistry())

    for i, r in enumerate(engine().serve(_reqs(Request), greedy=True, sync_every=SYNC).results):
        out[f"plain/{i}"] = np.asarray(r.tokens, np.int64)
    guard = CodedServeGuard(K=K, R=R, injector=FaultInjector(kills=KILLS))
    snap, first = guard.snapshot, {}

    def snapshot(cache, state, tick):
        if not first:
            first["leaves"] = [np.asarray(x) for x in jax.tree.leaves((cache, state))]
        snap(cache, state, tick)
        if "rows" not in first:
            first["rows"] = np.stack([np.asarray(guard.group._mem[j]) for j in range(K + R)])

    guard.snapshot = snapshot
    rep = engine().serve(_reqs(Request), greedy=True, sync_every=SYNC, guard=guard)
    for i, r in enumerate(rep.results):
        out[f"guarded/{i}"] = np.asarray(r.tokens, np.int64)
    out["guarded_stats"] = np.array(json.dumps(rep.coded))
    for i, leaf in enumerate(first["leaves"]):
        out[f"first/{i}"] = leaf
    out["first_rows"] = first["rows"]

    # the launcher, both ways, on one checkpoint of the reference's bf16 smoke weights
    rm = build_model(smoke_config(ARCH))
    save_checkpoint(ckpt, rm.init(jax.random.key(0)), step=1)
    for name, extra in (("launch_plain", []), ("launch_coded", LAUNCH_CODED)):
        sys.argv = ["repro.launch.serve", *LAUNCH_ARGV, "--ckpt", ckpt, *extra]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r_serve.main()
        out[name] = np.array(json.dumps(buf.getvalue().splitlines()))

    # a train state after one step, and the guard's snapshot of it
    scfg = smoke_config(ARCH)
    sm = build_model(scfg)
    sp = sm.init(jax.random.key(0))
    ocfg = OptConfig(**OPT)
    b = make_batch(scfg, TRAIN_BATCH[0], TRAIN_BATCH[1], seed=TRAIN_BATCH[2])
    trules = RP.rules_for(scfg, ShapeSpec("t", "train", TRAIN_BATCH[1], TRAIN_BATCH[0]), RP.BASELINE)
    newp, news, _ = jax.jit(TL.make_train_step(sm, ocfg, rules=trules))(sp, init_state(ocfg, sp),
                                                                        {k: jnp.asarray(v) for k, v in b.items()})
    state = {"params": newp, "opt": news}
    for i, leaf in enumerate(jax.tree.leaves(state)):
        out[f"train/{i}"] = _bits(np.asarray(leaf))
    tg = CodedStateGuard(K=TRAIN_K)
    tg.snapshot(state, 1)
    out["train/shards"], out["train/parity"] = np.asarray(tg._shards), np.asarray(tg._parity)
    np.savez(path, **out)


def reference_outputs(tmp_dir: str) -> tuple[str, str]:
    """Run :func:`reference_main` in a child; returns the paths of the
    ``.npz`` and of the checkpoint it wrote."""
    path, ckpt = os.path.join(tmp_dir, "coded_mesh_reference.npz"), os.path.join(tmp_dir, "ckpt")
    _child(f"import torch_coded_mesh_harness as h; h.reference_main({path!r}, {ckpt!r})")
    return path, ckpt


def collective_main(limbs_path: str, out_path: str):
    """The reference's ``lcc_encode_collective`` on an 8-wide host mesh, of
    the K limb shards in ``limbs_path``."""
    import jax
    import jax.numpy as jnp

    from repro.coded import build_lcc, lcc_encode_collective, lcc_pad
    from repro.launch.mesh import make_mesh

    assert jax.device_count() == 8
    plan = build_lcc(HOSTS_K, R=HOSTS_R)
    fn = lcc_encode_collective(make_mesh((8,), ("hosts",)), "hosts", plan)
    shards = np.load(limbs_path)
    np.save(out_path, np.asarray(fn(jnp.asarray(lcc_pad(plan, shards))), dtype=np.uint32))


def collective_rows(limbs: np.ndarray, tmp_dir: str) -> np.ndarray:
    """:func:`collective_main` in a child on ``limbs`` (K, S)."""
    src, dst = os.path.join(tmp_dir, "hosts_limbs.npy"), os.path.join(tmp_dir, "hosts_rows.npy")
    np.save(src, np.asarray(limbs, dtype=np.uint32))
    _child(f"import torch_coded_mesh_harness as h; h.collective_main({src!r}, {dst!r})")
    return np.load(dst)


# ---------------------------------------------------------------------------
# the port, on every rank of one world
# ---------------------------------------------------------------------------


def _record_first(guard, rank, sink: dict, extra=None):
    """Wrap ``guard.snapshot`` so that, at the first snapshot, ``sink``
    gets ``extra(cache, state)`` (called on every rank before the snapshot)
    and, on rank 0, the coded shards as the guard's decode group holds
    them (fetched from its host processes when it has them)."""
    snap = guard.snapshot

    def snapshot(cache, state, tick):
        if "rows" in sink:
            return snap(cache, state, tick)
        sink["extra"] = extra(cache, state) if extra is not None else None
        snap(cache, state, tick)
        grp = guard.group
        if rank == 0:
            sink["rows"] = np.stack([grp._mem[j] if grp.hosts is None else grp.hosts.fetch(j) for j in range(guard.N)])
        else:
            sink["rows"] = None

    guard.snapshot = snapshot


def port_main(rank: int, world: int, ref_path: str, ckpt: str) -> dict:
    """Every 4-rank case on this rank; rank 0 returns the whole results."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import tree
    from repro_torch.coded import build_lcc, lcc_encode
    from repro_torch.coded.rs_checkpoint import gather_state, shard_state_limbs
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.field import to_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.profiles import BASELINE, rules_for
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build_model
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import CodedServeGuard, ContinuousEngine, FaultInjector, Request
    from repro_torch.train import CodedStateGuard, OptConfig, reshard_state, state_specs
    from repro_torch.train.train_loop import opt_state_shardings, param_shardings, place

    ref = dict(np.load(ref_path))
    res: dict = {}
    mesh = make_mesh(*MESH, device="cpu")

    # the 2x2 engine at float32 on the reference's weights: plain, under the
    # single-program guard, and under the rank form over the four ranks
    cfg = smoke_config(ARCH).replace(n_layers=2, dtype="float32")
    model = build_model(cfg)
    leaves, treedef = tree.flatten(model.param_specs())
    params = tree.unflatten(treedef, [torch.from_numpy(ref[f"params/{i}"]) for i in range(len(leaves))])
    rules = rules_for(cfg, ShapeSpec(*SERVE_SHAPE), BASELINE)
    eng = ContinuousEngine(model, params, **ENGINE, mesh=mesh, rules=rules, metrics=MetricsRegistry())
    res["plain"] = [r.tokens for r in eng.serve(_reqs(Request), greedy=True, sync_every=SYNC).results]
    reg = MetricsRegistry()
    eng = ContinuousEngine(model, params, **ENGINE, mesh=mesh, rules=rules, metrics=reg)
    guard = CodedServeGuard(K=K, R=R, injector=FaultInjector(kills=KILLS), device="cpu")
    first: dict = {}
    def first_state(c, s):  # copies: the engine updates its state in place
        w = gather_state((c, s), keep=rank == 0)
        return None if w is None else [t.clone() for t in tree.leaves(w)]

    _record_first(guard, rank, first, extra=first_state)
    rep = eng.serve(_reqs(Request), greedy=True, sync_every=SYNC, guard=guard)
    res["guarded"] = [r.tokens for r in rep.results]
    res["guarded_stats"] = {**rep.coded, "alive": sorted(guard.alive), "faults": guard.faults,
                            "metric_recoveries": reg.snapshot()["serve.recoveries"]["value"],
                            "cache_placed": all(isinstance(t, DTensor) for t in tree.leaves(eng.params))}
    if rank == 0:
        res["first_rows"] = first["rows"]
        res["first_leaves"] = [t.numpy() for t in first["extra"]]

    hosts = make_mesh((world,), ("hosts",), group=dist.new_group(backend="gloo"), device="cpu")
    rguard = CodedServeGuard(K=RANK_K, R=RANK_R, injector=FaultInjector(kills=RANK_KILLS), mesh=hosts, axis="hosts")
    plan = build_lcc(RANK_K, R=RANK_R)
    rfirst: dict = {}

    def single_program(c, s):  # the same limbs through the one-program encode
        w = gather_state((c, s), keep=rank == 0)
        return None if w is None else to_numpy(lcc_encode(plan, shard_state_limbs(w, RANK_K, "cpu")[0]))

    _record_first(rguard, rank, rfirst, extra=single_program)
    rep = ContinuousEngine(model, params, **ENGINE, mesh=mesh, rules=rules, metrics=MetricsRegistry()).serve(
        _reqs(Request), greedy=True, sync_every=SYNC, guard=rguard)
    res["ranks"] = {"tokens": [r.tokens for r in rep.results], "stats": rep.coded, "alive": sorted(rguard.alive),
                    "device": str(rguard.device), "host": rguard._host}
    if rank == 0:
        res["ranks"].update(rows=rfirst["rows"], single=rfirst["extra"])

    # the launcher, both ways, on the reference's checkpoint (rank 0 prints)
    for name, extra in (("launch_plain", []), ("launch_coded", LAUNCH_CODED)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_main([*LAUNCH_ARGV, "--ckpt", ckpt, "--device", "cpu", *extra])
        res[name] = buf.getvalue().splitlines()

    # the train guard on the reference's state, carried across onto the mesh
    scfg = smoke_config(ARCH)
    sm = build_model(scfg)
    ocfg = OptConfig(**OPT)
    like = {"params": sm.param_specs(), "opt": state_specs(ocfg, sm.param_specs())}
    lv, td = tree.flatten(like)
    state = tree.unflatten(td, [torch.from_numpy(ref[f"train/{i}"]).view(spec.dtype).reshape(spec.shape)
                                for i, spec in enumerate(lv)])
    trules = rules_for(scfg, ShapeSpec("t", "train", TRAIN_BATCH[1], TRAIN_BATCH[0]), BASELINE)
    tshard = {"params": param_shardings(sm, mesh, trules), "opt": opt_state_shardings(ocfg, sm, mesh, trules)}
    tguard = CodedStateGuard(K=TRAIN_K, device="cpu")
    tguard.snapshot(place(state, tshard), 1)
    res["train_carried"] = {"step": tguard.step, "held": tguard._shards is not None}
    if rank == 0:
        res["train_carried"].update(shards=tguard._shards, parity=tguard._parity)

    # the train launcher with --coded-every 1 and 0, and the recovery put back on the mesh
    runs = {}
    for every in ("1", "0"):
        with contextlib.redirect_stdout(io.StringIO()):
            runs[every] = train_main([*TRAIN_ARGV, "--coded-every", every])
    run = runs["1"]
    g = run["guard"]
    final = run["state"]
    rec = {"losses": {k: [h["loss"] for h in v["history"]] for k, v in runs.items()}, "step": g.step,
           "held": g._shards is not None}
    one = gather_state(final, keep=rank == 0)
    if rank == 0:  # a one-process guard over the gathered state
        og = CodedStateGuard(K=TRAIN_K, device="cpu")
        og.snapshot(one, g.step)
        rec["one_process_equal"] = (np.array_equal(og._shards, g._shards) and np.array_equal(og._parity, g._parity))
    back, step = g.fail_and_recover(TRAIN_LOST)
    rec["recovered_step"] = step
    rec["recovered_plain"] = not any(isinstance(t, DTensor) for t in tree.leaves(back))
    tmesh = next(t for t in tree.leaves(final) if isinstance(t, DTensor))
    m2 = make_mesh(*MESH, device="cpu")
    shardings = {"params": param_shardings(run["model"], m2, run["rules"]),
                 "opt": opt_state_shardings(run["opt_cfg"], run["model"], m2, run["rules"])}
    placed = reshard_state(back, shardings)
    rec["blocks_equal"] = all(
        type(a) is type(b) and (torch.equal(a.to_local().reshape(-1).view(torch.uint8),
                                            b.to_local().reshape(-1).view(torch.uint8))
                                and tuple(a.placements) == tuple(b.placements) if isinstance(a, DTensor)
                                else torch.equal(a, b))
        for a, b in zip(tree.leaves(placed), tree.leaves(final)))
    rec["same_mesh"] = tmesh.device_mesh == next(t for t in tree.leaves(placed) if isinstance(t, DTensor)).device_mesh
    res["train_launcher"] = rec
    return res if rank == 0 else {k: res[k] for k in ("plain", "guarded", "guarded_stats", "ranks", "train_carried",
                                                      "train_launcher", "launch_plain", "launch_coded")}


def port_hosts(rank: int, world: int, out_dir: str) -> dict:
    """The reference's 8-host SIGKILL test on 8 ranks: the port's engine on
    every rank, the guard's encode on the ranks (an 8-wide ``hosts`` axis,
    K = 6, R = 2), rank 0's ``ProcessHostPool`` host 3 SIGKILLed at tick 1.
    Rank 0 also keeps the first snapshot's limbs and coded shards."""
    import torch

    from repro_torch.coded import build_lcc, lcc_encode
    from repro_torch.coded.rs_checkpoint import shard_state_limbs
    from repro_torch.configs import smoke_config
    from repro_torch.core.field import to_numpy, to_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import CodedServeGuard, ContinuousEngine, FaultInjector, ProcessHostPool, Request

    model = build_model(smoke_config(ARCH).replace(n_layers=2))
    params = model.init(torch.Generator().manual_seed(0))
    reg = MetricsRegistry()
    eng = ContinuousEngine(model, params, **HOSTS_ENGINE, metrics=reg)
    base = [r.tokens for r in eng.serve(_reqs(Request, HOSTS_PROMPTS), greedy=True, sync_every=2).results]
    mesh = make_mesh((8,), ("hosts",), device="cpu")
    res: dict = {"base": base}
    with contextlib.ExitStack() as stack:
        pool = stack.enter_context(ProcessHostPool(8)) if rank == 0 else None
        guard = CodedServeGuard(K=HOSTS_K, R=HOSTS_R, injector=FaultInjector(kills=HOSTS_KILLS), hosts=pool,
                                mesh=mesh, axis="hosts")
        first: dict = {}
        _record_first(guard, rank, first,
                      extra=lambda c, s: to_numpy(shard_state_limbs((c, s), HOSTS_K, "cpu")[0]) if rank == 0 else None)
        rep = eng.serve(_reqs(Request, HOSTS_PROMPTS), greedy=True, sync_every=2, guard=guard)
        res.update(got=[r.tokens for r in rep.results], recoveries=rep.recoveries,
                   metric=reg.snapshot()["serve.recoveries"]["value"], alive=sorted(guard.alive),
                   faults=guard.faults, kernels=guard._ranks.kernels, transport=guard._ranks.transport)
        if rank == 0:
            res.update(pool_alive=[pool.alive(h) for h in range(8)], limbs=first["extra"], rows=first["rows"],
                       single=to_numpy(lcc_encode(build_lcc(HOSTS_K, R=HOSTS_R), to_tensor(first["extra"], "cpu"))))
    return res


RAISE_SEED = 41  # the two train states of port_raise


def port_raise(rank: int, world: int) -> dict:
    """A raise in the root's encode on a 2x2 mesh, on this rank. Two float32
    smoke-config parameter states (seeds ``RAISE_SEED`` and + 1) placed on
    the mesh; for each guard the first is snapshotted (step 3, tick 4), then
    the second with rank 0's encode made to raise: ``"keep"`` the train guard
    as it stands, ``"drop"`` with rank 0's ``host_holds_both`` saying no,
    ``"serve"`` the single-program ``CodedServeGuard(K=3, R=2)`` over the
    state as its cache. Returns each case's error, step or tick and recovery
    (leaves as numpy arrays); rank 0 also the first state whole, as nested
    dicts of numpy arrays."""
    import warnings

    import torch

    import repro_torch.serve.coded as psc
    from repro_torch import tree
    from repro_torch.coded.rs_checkpoint import gather_state
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.profiles import BASELINE, rules_for
    from repro_torch.models import build_model
    from repro_torch.serve import CodedServeGuard
    from repro_torch.train import CodedStateGuard, elastic
    from repro_torch.train.train_loop import param_shardings, place

    mesh = make_mesh(*MESH, device="cpu")
    cfg = smoke_config(ARCH).replace(dtype="float32")
    model = build_model(cfg)
    shard = param_shardings(model, mesh, rules_for(cfg, ShapeSpec("t", "train", TRAIN_BATCH[1], TRAIN_BATCH[0]),
                                                  BASELINE))
    placed = [place(model.init(torch.Generator().manual_seed(RAISE_SEED + i)), shard) for i in range(2)]

    def fail(*args, **kwargs):
        raise MemoryError("the root's encode")

    def attempt(fn) -> str | None:
        try:
            fn()
        except Exception as e:  # every rank's error, reported
            return f"{type(e).__name__}: {e}"
        return None

    def leaves(state) -> list:
        return [t.numpy().copy() for t in tree.leaves(state)]

    res: dict = {}
    for case in ("keep", "drop"):
        guard = CodedStateGuard(K=TRAIN_K, device="cpu")
        guard.snapshot(placed[0], 3)
        patched = {"encode_parity": fail} if case == "keep" else {
            "encode_parity": fail, "host_holds_both": lambda need: (False, 1)}
        saved = {k: getattr(elastic, k) for k in patched}
        if rank == 0:
            for k, v in patched.items():
                setattr(elastic, k, v)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            raised = attempt(lambda: guard.snapshot(placed[1], 5))
        for k, v in saved.items():
            setattr(elastic, k, v)
        rec = {"raised": raised, "step": guard.step, "held": guard._shards is not None,
               "warned": [str(w.message) for w in seen if issubclass(w.category, RuntimeWarning)]}
        got = {}
        rec["recover_raised"] = attempt(lambda: got.update(zip(("state", "step"), guard.fail_and_recover(TRAIN_LOST))))
        if "state" in got:
            rec.update(recovered_step=got["step"], leaves=leaves(got["state"]))
        res[case] = rec

    guard = CodedServeGuard(K=K, R=R, device="cpu")
    guard.snapshot(placed[0], {}, tick=4)
    real = psc.lcc_encode
    if rank == 0:
        psc.lcc_encode = fail
    raised = attempt(lambda: guard.snapshot(placed[1], {}, tick=9))
    psc.lcc_encode = real
    cache, _ = guard.recover([])
    res["serve"] = {"raised": raised, "tick": guard._tick, "snapshots": guard.snapshots, "leaves": leaves(cache)}
    first = gather_state(placed[0], keep=rank == 0)
    if rank == 0:
        res["first"] = tree.map(lambda t: t.numpy().copy(), first)
    return res
