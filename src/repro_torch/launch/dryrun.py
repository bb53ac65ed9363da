"""One-card dry run: every (architecture × shape) cell at full width and
full depth on ``meta`` tensors, recorded for the roofline (``launch.roofline``).

Nothing is allocated and nothing runs on a device: each cell builds its
parameters from ``model.param_specs()``, its optimizer state, batch or
decode cache as specs, and its step with the step builders
(``make_train_step``, ``make_prefill_step``, ``make_decode_step``), then
counts the step op by op (``launch.op_cost``, through ``launch.costpass``'s
exact extrapolation). Per cell it writes
``<out>/<arch>__<shape>__1xH100.json`` with:

    param_bytes, state_bytes (train), cache_bytes (decode)
    op_cost   global flops / bytes / attention-tile bytes, by op
    memory    the live-bytes tracker's argument / output / temp / peak bytes
    fits      the peak within one H100's 80 GB
    status    ok | skipped (``shape_applicable``'s reason) | error

Collectives need a mesh of cards: there are none on one card, and their
count waits for ROADMAP.md queue A3.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 8] [--out results/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

from .. import tree
from ..configs import SHAPES, get, shape_applicable
from ..configs.registry import all_arch_names
from ..models import build_model
from ..train import OptConfig, state_specs
from . import costpass
from .profiles import rules_for
from .rules import big_model

MESH = "1xH100"
CARD_BYTES = 80e9  # one H100 SXM's HBM


def _tree_bytes(specs) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree.leaves(specs)))


def dryrun_cell(arch: str, shape_name: str, out_dir: str, force: bool = False) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{MESH}.json")
    if os.path.exists(path) and not force:
        print(f"[skip existing] {path}")
        with open(path) as fh:
            return json.load(fh)

    cfg = get(arch)
    shape = SHAPES[shape_name]
    rec: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": MESH,
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
        cost, memory, method = costpass.count_cell(cfg, shape, rules_for(cfg, shape))
        rec.update(
            status="ok",
            n_chips=1,
            count_s=round(time.time() - t_start, 2),
            memory=memory,
            op_cost=costpass.cost_record(cost, method),
            collective_bytes_per_device=0,
            fits=memory["peak_bytes"] <= CARD_BYTES,
        )
        print(
            f"[ok] {arch} × {shape_name} × {MESH}: counted in {rec['count_s']}s ({method}), "
            f"flops {cost.flops:.3e}, bytes {cost.bytes:.3e}, peak {memory['peak_bytes'] / 1e9:.2f} GB"
        )
    except Exception as e:  # noqa: BLE001 — one cell's failure is recorded, the sweep goes on
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[ERROR] {arch} × {shape_name} × {MESH}: {rec['error']}")
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=2)
    return rec


def _cell(job) -> dict:
    return dryrun_cell(*job)


def run_all(out_dir: str, force: bool = False, jobs: int = 1, archs=None) -> list[dict]:
    """Every cell of ``archs`` (all by default) × every shape, ``jobs`` at a
    time in spawned worker processes; the records in cell order."""
    cells = [(a, s, out_dir, force) for a in (archs or all_arch_names()) for s in SHAPES]
    if jobs <= 1:
        return [_cell(c) for c in cells]
    # the costliest cells first, so that no worker starts one last; a worker
    # that dies fails the sweep (BrokenProcessPool) instead of hanging it
    order = sorted(range(len(cells)), key=lambda i: SHAPES[cells[i][1]].kind != "prefill")
    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        done = list(pool.map(_cell, [cells[i] for i in order]))
    recs = [None] * len(cells)
    for i, rec in zip(order, done):
        recs[i] = rec
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description="One-card dry run of every (arch × shape) cell on meta tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1, help="worker processes")
    args = ap.parse_args(argv)
    if args.all:
        run_all(args.out, args.force, args.jobs)
    else:
        if not (args.arch and args.shape):
            ap.error("pass --all, or --arch and --shape")
        dryrun_cell(args.arch, args.shape, args.out, force=args.force)


if __name__ == "__main__":
    main()
