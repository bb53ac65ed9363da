"""Spawned gloo ranks for the rank executor's differential tests
(``tests/test_torch_ranks*.py``), and the cases both sides run.

:func:`run_ranks` starts ``world`` processes with the ``spawn`` method, joins
them into one gloo group through a file store in a fresh temporary directory
(no TCP port is fixed, so parallel test workers do not collide), runs a
module-level function of this file on every rank and returns the results in
rank order. The group has a timeout and the run a deadline: when a rank
raises, or the deadline passes, every rank is terminated and the run fails
with the rank's traceback. Nothing here imports JAX or the JAX package: the
reference's outputs (and the inputs, so both sides see the same bytes) come
from one JAX child a test file, through an ``.npz``, keyed by the case names
of :data:`CASES`.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import numpy as np

M31, NTT = (1 << 31) - 1, 15 * (1 << 27) + 1
CPU_MODES = ("torch", "fused")
GROUP_TIMEOUT_S = 60  # a gloo operation that waits longer raises on its rank


def _case(kind, shape, names, axes, *, q=M31, gen="random", p=1, x=(8, 16), seed=0, pipeline="",
          ref_kernels=(None,), **extra):
    return dict(kind=kind, shape=shape, names=names, axes=axes, q=q, gen=gen, p=p, x=x, seed=seed,
                pipeline=pipeline, ref_kernels=ref_kernels, **extra)


FLAT = ((8,), ("enc",), "enc")
TWO = ((4, 2), ("inter", "intra"), ("inter", "intra"))
TWO_T = ((2, 4), ("inter", "intra"), ("inter", "intra"))
THREE = ((2, 2, 2), ("pod", "slice", "chip"), ("pod", "slice", "chip"))
KERNELS = ("jnp", "fused", "pallas")


def _gens(q):
    return ("random", "vandermonde") + (("dft",) if (q - 1) % 8 == 0 else ())


def _cases() -> dict:
    cases = {}
    # tests/test_distributed.py:31-170
    for p in (1, 2):
        cases[f"ps_p{p}"] = _case("ps", *FLAT, p=p, seed=0, xseed=1)
    cases["allgather"] = _case("allgather", *FLAT, seed=0, xseed=1)
    # an encode over one axis of a 2-D mesh: independent encodes side by side
    cases["ps_inter_of_4x2"] = _case("ps", (4, 2), ("inter", "intra"), "inter", x=(4, 16), xseed=6)
    cases["allgather_intra_of_4x2"] = _case("allgather", (4, 2), ("inter", "intra"), "intra", x=(2, 16), xseed=7)
    cases["butterfly"] = _case("butterfly", *FLAT, q=NTT, gen=None, x=(8, 4), xseed=2)
    cases["butterfly_inverse"] = _case("butterfly", *FLAT, q=NTT, gen=None, x=(8, 4), inverse=True,
                                       input_of="butterfly")
    cases["parity"] = _case("parity", (8,), ("dp",), "dp", gen=None, x=(8, 32), xseed=3, limbs=True)
    cases["parity_2x2x2"] = _case("parity", *THREE, gen=None, x=(8, 16), xseed=4, limbs=True)
    cases["lcc_8"] = _case("lcc", *FLAT, q=NTT, gen=None, x=(8, 12), xseed=5, lcc=(6, 2))
    # tests/test_hierarchical.py:37-200
    for (mesh, tag) in ((TWO, "4x2"), (TWO_T, "2x4")):
        for q in (M31, NTT):
            for gen in _gens(q):
                for p in (1, 2):
                    cases[f"hier_{tag}_{q & 0xffff:x}_{gen}_p{p}"] = _case(
                        "hier", *mesh, q=q, gen=gen, p=p, seed=0 if gen == "random" else 1, xseed=2)
    for q in (M31, NTT):
        for gen in _gens(q):
            for p in (1, 2):
                cases[f"ml_{q & 0xffff:x}_{gen}_p{p}"] = _case(
                    "ml", *THREE, q=q, gen=gen, p=p, seed=0 if gen == "random" else 1, xseed=2)
    for name, mesh, kind in (("flat_ps", FLAT, "ps"), ("flat_hier", TWO, "hier"), ("flat_ml", THREE, "ml")):
        cases[name] = _case(kind, *mesh, gen="vandermonde", seed=3, x=(8, 8), xseed=4)
    # tests/test_fused_encode.py:300-420, every kernel mode
    for q in (M31, NTT):
        for gen in ("lagrange", "random"):
            for pipe in ("", "pipeline"):
                cases[f"modes_ps_{q & 0xffff:x}_{gen}{'_' + pipe if pipe else ''}"] = _case(
                    "ps", *FLAT, q=q, gen=gen, seed=2, x=(8, 16, 3), xseed=3, pipeline=pipe,
                    ref_kernels=KERNELS)
    for kern, pipe in (("fused", "pipeline"), ("pallas", "pipeline"), ("jnp", "pipeline"), ("fused", "")):
        for kind, mesh in (("ml", THREE), ("hier", TWO)):
            cases[f"modes_{kind}_{kern}{'_' + pipe if pipe else ''}"] = _case(
                kind, *mesh, seed=4, x=(8, 7), xseed=5, pipeline=pipe, ref_kernels=(kern,))
    cases["modes_butterfly"] = _case("butterfly", *FLAT, q=NTT, gen=None, x=(8, 5), xseed=6,
                                     ref_kernels=KERNELS)
    for p in (1, 2):
        cases[f"budget_ps_pipeline_p{p}"] = _case("ps", *FLAT, p=p, x=(8, 4), xseed=1, pipeline="pipeline")
    cases["budget_hier_pipeline"] = _case("hier", *TWO, x=(8, 4), xseed=1, pipeline="pipeline")
    cases["budget_ml_pipeline"] = _case("ml", *THREE, x=(8, 4), xseed=1, pipeline="pipeline")
    return cases


CASES = _cases()
# test_obs.py:263-310 and test_fused_encode.py's traced pipelined run: the IR,
# generator, seeds and topology of each traced case
TRACED = {
    "traced_multilevel": dict(gen="vandermonde", seed=0, xseed=3, x=(8, 32), pipeline=""),
    "traced_pipelined": dict(gen="random", seed=0, xseed=1, x=(8, 32), pipeline="pipeline"),
}
# (mesh shape, axis names) and the axes orders whose P(axes) row order the mesh must follow
MESH_ORDERS = [
    ((8,), ("enc",), [("enc",)]),
    ((4, 2), ("inter", "intra"), [("inter", "intra"), ("intra", "inter"), ("inter",), ("intra",)]),
    ((2, 4), ("inter", "intra"), [("inter", "intra"), ("intra", "inter")]),
    ((2, 2, 2), ("pod", "slice", "chip"),
     [("pod", "slice", "chip"), ("chip", "pod", "slice"), ("slice", "chip"), ("slice",), ("chip", "pod")]),
]


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------


def processors(spec: dict) -> int:
    """K of a case: the product of its encode axes' sizes."""
    axes = (spec["axes"],) if isinstance(spec["axes"], str) else spec["axes"]
    return int(np.prod([spec["shape"][spec["names"].index(a)] for a in axes]))


def _rank_main(rank: int, world: int, init: str, target: str, args: tuple, out):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)  # world ranks share the machine's cores
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            if ":" in target:  # a function of another module: "module:function"
                import importlib

                mod, fn = target.split(":")
                result = getattr(importlib.import_module(mod), fn)(rank, world, *args)
            else:
                result = globals()[target](rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put(("ok", rank, result))
    except BaseException:  # reported to the parent, which fails the run
        out.put(("error", rank, traceback.format_exc()))


def run_ranks(world: int, target: str, *args, deadline: float = 120.0) -> list:
    """``target(rank, world, *args)`` (a function of this module, or
    ``"module:function"`` of an importable module) on
    ``world`` spawned gloo ranks; returns the results in rank order. Raises
    AssertionError when a rank raises, dies or the deadline passes, after
    terminating every rank."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, world, init, target, args, out), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        results, t_end = {}, time.monotonic() + deadline
        try:
            while len(results) < world:
                try:
                    status, rank, value = out.get(timeout=max(0.1, min(1.0, t_end - time.monotonic())))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in results]
                    if dead:
                        raise AssertionError(f"rank(s) {dead} died (exit codes "
                                             f"{[procs[r].exitcode for r in dead]})") from None
                    if time.monotonic() > t_end:
                        raise AssertionError(f"ranks {sorted(set(range(world)) - set(results))} did not finish "
                                             f"within {deadline} s") from None
                    continue
                if status == "error":  # gather what the other ranks say before failing
                    errors = {rank: value}
                    t_drain = time.monotonic() + 5.0
                    while time.monotonic() < t_drain and len(errors) + len(results) < world:
                        try:
                            status, rank, value = out.get(timeout=0.5)
                        except queue.Empty:
                            continue
                        if status == "error":
                            errors[rank] = value
                    raise AssertionError("\n".join(f"rank {r} raised:\n{e}" for r, e in sorted(errors.items())))
                results[rank] = value
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
            out.close()
    return [results[r] for r in range(world)]


def _port_fn(name: str, spec: dict, mesh, ref, mode: str):
    """The port's rank callable for a case, and its permutation budget
    (``None``: the callable runs no IR)."""
    from repro_torch.coded.lagrange_compute import build_lcc, lcc_encode_ranks
    from repro_torch.coded.rs_checkpoint import build_parity_plan, encode_parity_ranks
    from repro_torch.dist import collectives as pc
    from repro_torch.dist import ranks as pr

    kind, q, p, pipe = spec["kind"], spec["q"], spec["p"], spec["pipeline"]
    A = ref[f"{name}/A"] if f"{name}/A" in ref else None
    kw = dict(p=p, q=q, kernels=mode, pipeline=pipe)
    if kind == "ps":
        fn, plan = pr.ps_encode_ranks(mesh, spec["axes"], A, **kw)
        return fn, pc.expected_permute_count(plan)
    if kind == "hier":
        fn, plan = pr.hierarchical_encode_ranks(mesh, *spec["axes"], A, **kw)
        return fn, pc.expected_hier_permute_count(plan)
    if kind == "ml":
        fn, plan = pr.multilevel_encode_ranks(mesh, spec["axes"], A, **kw)
        return fn, pc.expected_multilevel_permute_count(plan)
    if kind == "butterfly":
        fn, plan = pr.butterfly_ranks(mesh, spec["axes"], q=q, inverse=spec.get("inverse", False), kernels=mode)
        return fn, plan.H * plan.p
    if kind == "allgather":
        return pr.allgather_encode_ranks(mesh, spec["axes"], A, q=q), None
    if kind == "parity":
        fn = encode_parity_ranks(mesh, spec["axes"], build_parity_plan(mesh.size(spec["axes"]), p=p))
        return fn, fn.permute_count
    if kind == "lcc":
        K, R = spec["lcc"]
        fn = lcc_encode_ranks(mesh, spec["axes"], build_lcc(K, R=R), kernels=mode)
        return fn, fn.permute_count
    raise ValueError(kind)


def port_cases(rank: int, world: int, ref_path: str, names: list, modes: tuple) -> dict:
    """Every case of ``names`` in every CPU kernel mode of ``modes`` on this
    rank: ``(name, mode) → (processor index, block, permutes_run,
    budget)``."""
    from repro_torch.convert import to_numpy
    from repro_torch.launch.mesh import make_mesh

    ref = dict(np.load(ref_path))
    res = {}
    for name in names:
        spec = CASES[name]
        mesh = make_mesh(spec["shape"], spec["names"], device="cpu")
        assert mesh.rank == rank and mesh.ranks == tuple(range(world)), (mesh.rank, mesh.ranks)
        assert mesh.coords == tuple(int(c) for c in np.unravel_index(rank, spec["shape"]))
        k = mesh.index(spec["axes"])
        for mode in (modes if spec["kind"] != "allgather" else ("plain",)):
            fn, budget = _port_fn(name, spec, mesh, ref, mode)
            block = to_numpy(fn(ref[f"{name}/x"][k : k + 1]))
            res[(name, mode)] = (k, block, getattr(fn, "permutes_run", None), budget,
                                 getattr(fn, "transport", None))
    return res


def port_traced(rank: int, world: int, ref_path: str, cal_path: str) -> dict:
    """The traced cases on this rank: two calls each, with the spans (times
    left out), counters, histogram counts and, on rank 0, the calibration fed
    from its own spans into ``cal_path``."""
    from repro_torch.convert import to_numpy
    from repro_torch.dist import collectives as pc
    from repro_torch.dist.ranks import ir_encode_ranks
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import MetricsRegistry, Tracer, feed_calibration, write_chrome_trace
    from repro_torch.topo import Hierarchy, load_fitted_costs, plan_multilevel

    ref = dict(np.load(ref_path))
    mesh = make_mesh((2, 2, 2), ("pod", "slice", "chip"), device="cpu")
    axes = ("pod", "slice", "chip")
    k = mesh.index(axes)
    res = {}
    for name, spec in TRACED.items():
        A = ref[f"{name}/A"]
        ir = pc._apply_pipeline(plan_multilevel(8, 1, (2, 2, 2)).to_ir(A), spec["pipeline"])
        tracer, reg = Tracer(), MetricsRegistry()
        fn = ir_encode_ranks(mesh, axes, ir, tracer=tracer, topo=Hierarchy(levels=(2, 2, 2)), metrics=reg)
        plain = ir_encode_ranks(mesh, axes, ir)
        x = ref[f"{name}/x"][k : k + 1]
        outs = [to_numpy(fn(x)), to_numpy(fn(x))]
        snap = reg.snapshot()
        entry = {
            "k": k,
            "outs": outs,
            "plain": to_numpy(plain(x)),
            "permutes": fn.permutes_run,
            "spans": [{kk: v for kk, v in s.to_dict().items() if kk not in ("ts_us", "dur_us")}
                      for s in tracer.spans],
            "durations": [s.dur_us for s in tracer.spans],
            "counters": {kk: v["value"] for kk, v in snap.items() if v["type"] == "counter"},
            "hist_counts": {kk: v["count"] for kk, v in snap.items() if v["type"] == "histogram"},
        }
        if rank == 0:
            path = os.path.join(cal_path, f"{name}.json")
            fitted = feed_calibration(tracer.spans, path, n_levels=3)
            entry["calibration"] = (tuple(fitted) == tuple(load_fitted_costs(path)), len(fitted))
            entry["trace"] = write_chrome_trace(tracer.spans, os.path.join(cal_path, f"{name}.trace.json"))
        res[name] = entry
    return res


def port_semantics(rank: int, world: int, x: np.ndarray, modes: tuple) -> dict:
    """On 4 ranks: a partial store group raises the reference's error before
    any message, and the hand-made IR with update/overlap LocalOps, uniform
    {0,1} rows, a zero row and a partial add group into a missing slot runs
    (both ``update`` flags, every CPU mode)."""
    from repro_torch.convert import to_numpy
    from repro_torch.core import ir as pir
    from repro_torch.dist.ranks import ir_encode_ranks
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4,), ("enc",), device="cpu")
    k = mesh.index("enc")
    partial = pir.ScheduleIR(
        "partial-store", 4, 1,
        (pir.CommRound(tuple(pir.Transfer(src=j, dst=j + 1, port=1, slots=((0, 1),), mode="store")
                             for j in range(3))),),
    )
    res = {"k": k}
    try:
        ir_encode_ranks(mesh, "enc", partial)
    except ValueError as e:
        res["store_error"] = str(e)
    for update in (True, False):
        for mode in modes:
            fn = ir_encode_ranks(mesh, "enc", hand_made_ir(pir, update), kernels=mode)
            res[(update, mode)] = (to_numpy(fn(x[k : k + 1])), fn.permutes_run, fn.permute_count)
    return res


def hand_made_ir(irm, update: bool):
    """tests/test_torch_executor.py's hand-made IR at K = 4, built with the
    IR module ``irm`` of either package."""
    K = 4
    coeffs = np.zeros((K, 3, 2), dtype=np.uint64)
    coeffs[:, 0, :] = 1  # slot 5 = slot0 + slot1   ({0,1} row)
    coeffs[:, 2, 0] = np.arange(2, 2 + K)  # slot 7 = c_k * slot0  (general row); row 1 stays zero
    steps = (
        irm.CommRound(tuple(irm.Transfer(src=j, dst=(j + 1) % K, port=1, slots=((0, 1),), mode="store")
                            for j in range(K))),
        irm.LocalOp(out_slots=(5, 6, 7), in_slots=(0, 1), coeffs=coeffs, update=update, overlap=True),
        # partial add group: only processors 0 and 1 send, into a slot that does not exist yet
        irm.CommRound(tuple(irm.Transfer(src=j, dst=j + 2, port=1, slots=((7, 9),), coeffs=(3,), mode="add")
                            for j in range(2))),
        irm.LocalOp(out_slots=(0,), in_slots=(5, 9, 6, 0), coeffs=np.ones((K, 1, 4), dtype=np.uint64)),
    )
    return irm.ScheduleIR("hand-made", K, 1, steps)


def port_faulty(rank: int, world: int, ref_path: str) -> None:
    """Rank 2 raises before its first message; the others wait for it in a
    prepare-and-shoot encode."""
    from repro_torch.dist.ranks import ps_encode_ranks
    from repro_torch.launch.mesh import make_mesh

    if rank == 2:
        raise RuntimeError("injected fault on rank 2")
    ref = dict(np.load(ref_path))
    mesh = make_mesh((8,), ("enc",), device="cpu")
    fn, _ = ps_encode_ranks(mesh, "enc", ref["ps_p1/A"])
    k = mesh.index("enc")
    fn(ref["ps_p1/x"][k : k + 1])


# ---------------------------------------------------------------------------
# the reference side: run in ONE child process with 8 forced host devices
# ---------------------------------------------------------------------------


def reference_main(path: str, names: list, traced: bool, orders: bool) -> None:
    """The reference's mesh executors on every case of ``names``: writes
    ``{name}/A`` (where the case has a generator), ``{name}/x`` and
    ``{name}/out@{kernels}`` for each of the case's reference kernel modes
    to ``path`` (an ``.npz``); with ``traced``, the traced cases' outputs and
    span records (times left out) beside it as ``path + ".json"``; with
    ``orders``, the row each mesh position holds under ``P(axes)`` for
    :data:`MESH_ORDERS`. Imports JAX: run it in a child with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=8``."""
    import json

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.coded.lagrange_compute import build_lcc, lcc_encode_collective, lcc_pad
    from repro.coded.rs_checkpoint import build_parity_plan, encode_parity_collective
    from repro.core.field import Field
    from repro.core.matrices import (
        dft_matrix, distinct_points, lagrange_matrix, random_matrix, random_vector, vandermonde)
    from repro.dist import collectives as rc
    from repro.launch.mesh import make_mesh
    from repro.obs import MetricsRegistry, Tracer
    from repro.topo import Hierarchy, plan_multilevel

    def gen(kind, q, K, seed):
        f = Field(q)
        if kind == "random":
            return random_matrix(f, K, seed=seed)
        if kind == "vandermonde":
            return vandermonde(f, distinct_points(f, K, seed=seed))
        if kind == "dft":
            return dft_matrix(f, K)
        return lagrange_matrix(f, distinct_points(f, K, seed=1), distinct_points(f, K, seed=0))

    res, meshes = {}, {}
    for name in names:
        spec = CASES[name]
        key = (spec["shape"], spec["names"])
        mesh = meshes.setdefault(key, make_mesh(*key))
        q, K = spec["q"], processors(spec)
        f = Field(q)
        if spec.get("limbs"):
            x = np.random.default_rng(spec["xseed"]).integers(0, 1 << 16, size=spec["x"], dtype=np.uint32)
        elif spec["kind"] == "butterfly" and spec.get("inverse"):
            x = res[f"{spec['input_of']}/out@None"]
        else:
            x = random_vector(f, spec["x"], seed=spec["xseed"]).astype(np.uint32)
        if spec["kind"] == "lcc":
            lk, lr = spec["lcc"]
            x = np.asarray(lcc_pad(build_lcc(lk, R=lr), jnp.asarray(x[:lk])), dtype=np.uint32)
        res[f"{name}/x"] = x
        A = None
        if spec["gen"] is not None:
            A = np.asarray(gen(spec["gen"], q, K, spec["seed"]))
            res[f"{name}/A"] = A.astype(np.uint64)
        for kern in spec["ref_kernels"]:
            kw = dict(p=spec["p"], q=q, kernels=kern, pipeline=spec["pipeline"])
            kind, axes = spec["kind"], spec["axes"]
            if kind == "ps":
                fn, _ = rc.ps_encode_jit(mesh, axes, A, **kw)
            elif kind == "hier":
                fn, _ = rc.hierarchical_encode_jit(mesh, *axes, A, **kw)
            elif kind == "ml":
                fn, _ = rc.multilevel_encode_jit(mesh, axes, A, **kw)
            elif kind == "butterfly":
                fn, _ = rc.butterfly_jit(mesh, axes, q=q, inverse=spec.get("inverse", False), kernels=kern)
            elif kind == "allgather":
                fn = rc.allgather_encode_jit(mesh, axes, A, q=q)
            elif kind == "parity":
                fn = encode_parity_collective(mesh, axes, build_parity_plan(K, p=spec["p"]))
            else:
                lk, lr = spec["lcc"]
                fn = lcc_encode_collective(mesh, axes, build_lcc(lk, R=lr))
            res[f"{name}/out@{kern}"] = np.asarray(fn(jnp.asarray(x)), dtype=np.uint32)
    spans = {}
    if traced:
        mesh = make_mesh((2, 2, 2), ("pod", "slice", "chip"))
        axes = ("pod", "slice", "chip")
        for name, spec in TRACED.items():
            f = Field(M31)
            A = np.asarray(gen(spec["gen"], M31, 8, spec["seed"]))
            x = random_vector(f, spec["x"], seed=spec["xseed"]).astype(np.uint32)
            ir = rc._apply_pipeline(plan_multilevel(8, 1, (2, 2, 2)).to_ir(A), spec["pipeline"])
            tracer, reg = Tracer(), MetricsRegistry()
            fn = rc.ir_encode_jit(mesh, axes, ir, tracer=tracer, topo=Hierarchy(levels=(2, 2, 2)), metrics=reg)
            res[f"{name}/A"], res[f"{name}/x"] = A.astype(np.uint64), x
            res[f"{name}/out"] = np.asarray(fn(jnp.asarray(x)), dtype=np.uint32)
            snap = reg.snapshot()
            spans[name] = {
                "spans": [{k: v for k, v in s.to_dict().items() if k not in ("ts_us", "dur_us")}
                          for s in tracer.spans],
                "counters": {k: v["value"] for k, v in snap.items() if v["type"] == "counter"},
                "hist_counts": {k: v["count"] for k, v in snap.items() if v["type"] == "histogram"},
            }
    if orders:
        for shape, axis_names, axes_list in MESH_ORDERS:
            mesh = make_mesh(shape, axis_names)
            for axes in axes_list:
                n = int(np.prod([shape[axis_names.index(a)] for a in axes]))
                idx = NamedSharding(mesh, P(axes)).devices_indices_map((n, 1))
                rows = np.zeros(shape, dtype=np.int64)
                for pos in np.ndindex(*shape):
                    rows[pos] = idx[mesh.devices[pos]][0].start or 0
                res[f"order/{shape}/{axis_names}/{axes}"] = rows
    np.savez(path, **res)
    with open(path + ".json", "w") as fh:
        json.dump(spans, fh)
    assert jax.device_count() == 8


def reference_outputs(tmp_dir: str, names: list, *, traced: bool = False, orders: bool = False) -> str:
    """Run :func:`reference_main` in a child with 8 forced host devices;
    returns the path of the ``.npz`` it wrote."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(tmp_dir, "reference.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(repo, "src"), os.path.join(repo, "tests")])
    code = (f"import torch_ranks_harness as h; "
            f"h.reference_main({path!r}, {list(names)!r}, {traced!r}, {orders!r})")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"reference child failed:\nSTDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return path
