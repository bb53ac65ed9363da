"""Hill-climb driver: measure one (arch × shape) cell on one card under a
set of optimization levers (``launch.profiles``) and append the iteration
to ``results/perf_iterations_torch.jsonl`` (hypothesis → change → before →
after).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch jamba-v0.1-52b \\
      --shape train_4k --levers moe_gather,bf16_moments \\
      --hypothesis "..." [--tag iter2]

Metrics per run: the roofline terms against one H100's data-sheet peaks
(``launch.roofline``) from the op-level count on ``meta`` tensors
(``launch.costpass.count_cell``), the live-bytes tracker's footprint and
the useful-flops ratio. Nothing runs on the card; on one card the
collective term is 0 (the mesh levers act once there is a mesh, ROADMAP.md
queue A3).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..configs import SHAPES, get
from . import costpass
from .dryrun import MESH
from .profiles import Profile, apply_profile_cfg, rules_for
from .roofline import HBM_BW, PEAK_FLOPS, model_flops


def measure(arch: str, shape_name: str, profile: Profile) -> dict:
    cfg = apply_profile_cfg(get(arch), profile)
    shape = SHAPES[shape_name]
    rules = rules_for(cfg, shape, profile)
    mdt = "bfloat16" if profile.bf16_moments else None
    t0 = time.time()
    c, mem, method = costpass.count_cell(cfg, shape, rules, moment_dtype=mdt)
    compute_s = c.flops / PEAK_FLOPS
    memory_s = c.bytes / HBM_BW
    # the bottleneck is judged with the flash-fused memory term: a fused
    # attention kernel keeps the S² score tiles on chip (op_cost.Cost.tile_bytes)
    memory_flash_s = c.bytes_flash / HBM_BW
    coll_s = 0.0
    terms = {"compute": compute_s, "memory": memory_flash_s, "collective": coll_s}
    mf = model_flops(get(arch), shape)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": MESH,
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
        "collective_gb_per_dev": 0.0,
        "collective_by_op_gb": {},
        "hbm_gb_per_dev": mem["peak_bytes"] / 1e9,
        "temp_gb_per_dev": mem["temp_bytes"] / 1e9,
        "count_method": method,
        "wall_s": round(time.time() - t0, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="Measure one cell's roofline terms under a set of levers")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
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
    rec = measure(args.arch, args.shape, prof)
    rec["hypothesis"] = args.hypothesis
    os.makedirs(os.path.dirname(args.log) or ".", exist_ok=True)
    with open(args.log, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
