"""Dry run: every (architecture × shape) cell at full width and full depth
on ``meta`` tensors, on one card or on a production mesh of ranks, recorded
for the roofline (``launch.roofline``).

Nothing is allocated and nothing runs on a device: each cell builds its
parameters from ``model.param_specs()``, its optimizer state, batch or
decode cache as specs, and its step with the step builders
(``make_train_step``, ``make_prefill_step``, ``make_decode_step``), then
counts the step op by op (``launch.op_cost``, through ``launch.costpass``'s
exact extrapolation): the logical one-card program, on every mesh alike
(the reference's ``jaxpr_cost``). Per cell it writes
``<out>/<arch>__<shape>__<mesh>.json`` with:

    param_bytes, state_bytes (train), cache_bytes (decode)
    op_cost   global flops / bytes / attention-tile bytes, by op
    memory    the live-bytes tracker's argument / output / temp / peak bytes
              (one card: the whole step's; a mesh: a device's local blocks)
    fits      the peak within one H100's 80 GB
    status    ok | skipped (``shape_applicable``'s reason) | error

The mesh is ``1xH100`` unless ``--multi-pod`` or ``--both-meshes`` asks for
the reference's production meshes, ``pod16x16`` (data=16, model=16; 256
ranks) and ``pod2x16x16`` (pod=2, data=16, model=16; 512). There the cell's
step runs on DTensors of ``meta`` blocks under the reference's shardings,
in a process that is rank 0 of a fake world of that size
(``dist.counting``: a group that sends nothing; each mesh's cells run in
worker processes of their own), and the record also holds

    n_chips   256 | 512
    collectives  op → count and output bytes a device, per collective the
              step issues (all-gather, all-reduce, reduce-scatter, all-to-all,
              collective-permute), with the layer body once: what the
              reference's ``parse_collectives`` reads in an HLO that scans
              the body; ``launch.costpass`` corrects it over the depth
    collective_bytes_per_device  their sum
    mesh_s    the seconds the mesh took to build in this worker

A cell whose rules cannot place a tensor on the mesh, or whose step DTensor
cannot run there, is recorded as ``status: error`` with the reason.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--jobs 8] [--out results/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

from .. import tree
from ..configs import SHAPES, get, shape_applicable
from ..configs.registry import all_arch_names
from ..dist.counting import collectives_of
from ..models import build_model
from ..train import OptConfig, state_specs
from . import costpass
from .mesh import dryrun_mesh, production_tag
from .profiles import rules_for
from .rules import big_model

MESH = "1xH100"
CARD_BYTES = 80e9  # one H100 SXM's HBM


def _tree_bytes(specs) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree.leaves(specs)))


def dryrun_cell(arch: str, shape_name: str, out_dir: str, force: bool = False, *,
                multi_pod: bool | None = None) -> dict:
    """One cell's record, written to ``out_dir``: on one card
    (``multi_pod=None``) or on the production mesh (``False``: 256 ranks,
    ``True``: 512), whose fake world this process then joins."""
    mesh_tag = MESH if multi_pod is None else production_tag(multi_pod)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_tag}.json")
    if os.path.exists(path) and not force:
        print(f"[skip existing] {path}")
        with open(path) as fh:
            return json.load(fh)

    cfg = get(arch)
    shape = SHAPES[shape_name]
    rec: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_tag,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
    }
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        with open(path, "w") as fh:
            json.dump(rec, fh, indent=2)
        print(f"[skipped by design] {arch} × {shape_name}: {reason}")
        return rec

    t_start = time.time()
    try:
        model = build_model(cfg)
        pshapes = model.param_specs()
        rec["param_bytes"] = _tree_bytes(pshapes)
        if shape.kind == "train":
            ocfg = OptConfig(moment_dtype="bfloat16" if big_model(cfg) else "float32")
            rec["moment_dtype"] = ocfg.moment_dtype
            rec["state_bytes"] = rec["param_bytes"] + _tree_bytes(state_specs(ocfg, pshapes))
        elif shape.kind == "decode":
            rec["cache_bytes"] = _tree_bytes(model.init_cache(shape.global_batch, shape.seq_len, device="meta"))
        rules = rules_for(cfg, shape)
        cost, memory, method = costpass.count_cell(cfg, shape, rules)
        rec.update(status="ok", n_chips=1, op_cost=costpass.cost_record(cost, method), collective_bytes_per_device=0)
        if multi_pod is not None:
            t_mesh = time.time()
            mesh = dryrun_mesh(multi_pod)
            rec["mesh_s"] = round(time.time() - t_mesh, 3)
            counted = costpass.count_mesh_cell(cfg, shape, mesh, rules)
            colls = collectives_of(counted["calls"][1 if 1 in counted["calls"] else None])  # the body once
            memory = counted["memory"]
            rec.update(n_chips=math.prod(mesh.shape), collectives=colls,
                       collective_bytes_per_device=int(sum(c["bytes"] for c in colls.values())),
                       collective_method=counted["method"])
        rec.update(count_s=round(time.time() - t_start, 2), memory=memory, fits=memory["peak_bytes"] <= CARD_BYTES)
        print(
            f"[ok] {arch} × {shape_name} × {mesh_tag}: counted in {rec['count_s']}s ({method}), "
            f"flops {cost.flops:.3e}, bytes {cost.bytes:.3e}, peak {memory['peak_bytes'] / 1e9:.2f} GB"
            + (f", coll {rec['collective_bytes_per_device'] / 1e6:.1f} MB/dev" if multi_pod is not None else "")
        )
    except Exception as e:  # noqa: BLE001 — one cell's failure is recorded, the sweep goes on
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[ERROR] {arch} × {shape_name} × {mesh_tag}: {rec['error']}")
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=2)
    return rec


def _cell(job) -> dict:
    *args, multi_pod = job
    return dryrun_cell(*args, multi_pod=multi_pod)


def run_cells(cells, out_dir: str, force: bool = False, jobs: int = 1, multi_pod: bool | None = None,
              in_process: bool | None = None) -> list[dict]:
    """The records of ``cells`` ((arch, shape) pairs) on one mesh, in order,
    ``jobs`` at a time in spawned worker processes, or all in this one
    (``in_process``; by default where ``jobs`` is 1 and the mesh is one
    card: a production mesh's cells join its fake world, which a process
    joins once)."""
    jobs_ = [(a, s, out_dir, force, multi_pod) for a, s in cells]
    if in_process is None:
        in_process = jobs <= 1 and multi_pod is None
    if in_process:
        return [_cell(c) for c in jobs_]
    # the costliest cells first, so that no worker starts one last; a worker
    # that dies fails the sweep (BrokenProcessPool) instead of hanging it
    order = sorted(range(len(jobs_)), key=lambda i: SHAPES[jobs_[i][1]].kind != "prefill")
    with ProcessPoolExecutor(max(1, jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        done = list(pool.map(_cell, [jobs_[i] for i in order]))
    recs = [None] * len(jobs_)
    for i, rec in zip(order, done):
        recs[i] = rec
    return recs


def run_all(out_dir: str, force: bool = False, jobs: int = 1, archs=None, meshes=(None,)) -> list[dict]:
    """Every cell of ``archs`` (all by default) × every shape on each mesh
    of ``meshes`` (``None``: one card; ``False`` / ``True``: the production
    mesh of 256 / 512 ranks), each mesh's cells in worker processes of their
    own (:func:`run_cells`); the records in (mesh, cell) order."""
    cells = [(a, s) for a in (archs or all_arch_names()) for s in SHAPES]
    return [rec for mp in meshes for rec in run_cells(cells, out_dir, force, jobs, mp)]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Dry run of every (arch × shape) cell on meta tensors, on one card "
                                             "or on a production mesh of ranks")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="the (pod=2, data=16, model=16) mesh of 512 ranks")
    ap.add_argument("--both-meshes", action="store_true", help="both production meshes (256 and 512 ranks)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1, help="worker processes")
    args = ap.parse_args(argv)
    meshes = [False, True] if args.both_meshes else [True] if args.multi_pod else [None]
    if args.all:
        run_all(args.out, args.force, args.jobs, meshes=meshes)
    else:
        if not (args.arch and args.shape):
            ap.error("pass --all, or --arch and --shape")
        for multi_pod in meshes:  # one mesh's fake world in this process; both in a worker each
            run_cells([(args.arch, args.shape)], args.out, args.force, multi_pod=multi_pod,
                      in_process=len(meshes) == 1)

if __name__ == "__main__":
    main()
