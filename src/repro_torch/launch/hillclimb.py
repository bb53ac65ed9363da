"""Hill-climb driver: measure one (arch × shape) cell on one card, or on a
production mesh of ranks (``--multi-pod``: 512; the 256-rank mesh through
:func:`measure`), under a set of optimization levers (``launch.profiles``)
and append the iteration to ``results/perf_iterations_torch.jsonl``
(hypothesis → change → before → after).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch jamba-v0.1-52b \\
      --shape train_4k [--multi-pod] --levers moe_gather,bf16_moments \\
      --hypothesis "..." [--tag iter2]

Metrics per run: the roofline terms against one H100's data-sheet peaks
(``launch.roofline``) from the op-level count on ``meta`` tensors
(``launch.costpass.count_cell``; divided by the mesh's ranks), the
live-bytes tracker's footprint (a device's local blocks on a mesh) and the
useful-flops ratio. On a mesh the collective term is the differential
count of the step's collectives (``launch.costpass.count_mesh_cell``, this
process made rank 0 of a fake world of the mesh's size), priced over the
data sheet's NVLink rate: the mesh levers (``moe_ep``, ``dp_only``,
``no_fsdp``, ``attn_heads``, …) show what they do to it. Nothing runs on a
card; on one card the collective term is 0.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

from ..configs import SHAPES, get
from . import costpass
from .dryrun import MESH
from .mesh import dryrun_mesh, production_tag
from .profiles import Profile, apply_profile_cfg, rules_for
from .roofline import HBM_BW, NVLINK_BW, P_LINKS, PEAK_FLOPS, model_flops


def measure(arch: str, shape_name: str, profile: Profile, multi_pod: bool | None = None) -> dict:
    """The cell's roofline terms under ``profile``: on one card
    (``multi_pod=None``), or on the production mesh of 256 (``False``) or
    512 (``True``) ranks, whose fake world this process then joins."""
    cfg = apply_profile_cfg(get(arch), profile)
    shape = SHAPES[shape_name]
    rules = rules_for(cfg, shape, profile)
    mdt = "bfloat16" if profile.bf16_moments else None
    t0 = time.time()
    c, mem, method = costpass.count_cell(cfg, shape, rules, moment_dtype=mdt)
    n_chips, coll_by_op = 1, {}
    if multi_pod is not None:
        mesh = dryrun_mesh(multi_pod)
        n_chips = math.prod(mesh.shape)
        counted = costpass.count_mesh_cell(cfg, shape, mesh, rules, moment_dtype=mdt)
        mem = counted["memory"]
        coll_by_op = {op: max(v["bytes"], 0) for op, v in
                      costpass.collectives_corrected(counted["calls"], counted["R"]).items()}
    coll_bytes = sum(coll_by_op.values())
    compute_s = c.flops / n_chips / PEAK_FLOPS
    memory_s = c.bytes / n_chips / HBM_BW
    # the bottleneck is judged with the flash-fused memory term: a fused
    # attention kernel keeps the S² score tiles on chip (op_cost.Cost.tile_bytes)
    memory_flash_s = c.bytes_flash / n_chips / HBM_BW
    coll_s = coll_bytes / (P_LINKS * NVLINK_BW)
    terms = {"compute": compute_s, "memory": memory_flash_s, "collective": coll_s}
    mf = model_flops(get(arch), shape)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": MESH if multi_pod is None else production_tag(multi_pod),
        "profile": profile.name,
        "levers": {
            k: getattr(profile, k)
            for k in (
                "attn_heads", "moe_ep", "moe_resident", "moe_gather", "dp_only",
                "bf16_moments", "logits_vocab", "no_fsdp", "time_chunk",
            )
        },
        "compute_s": compute_s,
        "memory_s": memory_s,
        "memory_flash_s": memory_flash_s,
        "collective_s": coll_s,
        "bottleneck": max(terms, key=terms.get),
        "step_time_bound_s": max(terms.values()),
        "roofline_fraction": compute_s / max(terms.values()),
        "useful_ratio": mf / c.flops,
        "collective_gb_per_dev": coll_bytes / 1e9,
        "collective_by_op_gb": {k: v / 1e9 for k, v in sorted(coll_by_op.items(), key=lambda kv: -kv[1])},
        "hbm_gb_per_dev": mem["peak_bytes"] / 1e9,
        "temp_gb_per_dev": mem["temp_bytes"] / 1e9,
        "count_method": method,
        "wall_s": round(time.time() - t0, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="Measure one cell's roofline terms under a set of levers")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true", help="on the (pod=2, data=16, model=16) mesh of 512 ranks")
    ap.add_argument("--levers", default="", help="comma list; empty = baseline")
    ap.add_argument("--time-chunk", type=int, default=0)
    ap.add_argument("--hypothesis", default="")
    ap.add_argument("--tag", default="")
    ap.add_argument("--log", default="results/perf_iterations_torch.jsonl")
    args = ap.parse_args(argv)

    levers = [l for l in args.levers.split(",") if l]
    kw = {l: True for l in levers if l != "time_chunk"}
    if "time_chunk" in levers or args.time_chunk:
        kw["time_chunk"] = args.time_chunk or 256
    prof = Profile(args.tag or (("+".join(levers)) or "baseline"), **kw)
    rec = measure(args.arch, args.shape, prof, multi_pod=True if args.multi_pod else None)
    rec["hypothesis"] = args.hypothesis
    os.makedirs(os.path.dirname(args.log) or ".", exist_ok=True)
    with open(args.log, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
