"""Worlds of ``tests/test_torch_dryrun_mesh.py``, each in a process of its own
(only one default group fits in a process):

* :func:`real_counts`, on four spawned gloo ranks (``torch_ranks_harness.run_ranks``):
  the float32 smoke config of each family, one decode tick and one train
  step on a (data=2, model=2) mesh of CPU tensors, counted by
  ``dist.counting.CollectiveCounter``;
* :func:`fake_main`, in spawned processes that are rank 0 of a fake world
  of four (``dist.counting.fake_world``): the same steps on ``meta`` blocks,
  and the differential pass against the full count (``CASES``);
* :func:`production_main`, in one spawned process that is rank 0 of a fake
  world of 256 or 512: one full-width cell through the dry run's, the cost
  pass's and the hill-climb's entry points.

Every result is plain Python (counts and bytes), never a tensor.
"""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import costpass
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.profiles import rules_for

FAMILIES = {"dense": "qwen3-1.7b", "moe": "arctic-480b", "mla": "deepseek-v3-671b", "mamba": "jamba-v0.1-52b",
            "rwkv6": "rwkv6-3b", "whisper": "whisper-base", "vlm": "internvl2-26b"}
SHAPES = {"tick": ShapeSpec("tick", "decode", 32, 4), "train": ShapeSpec("train", "train", 16, 4)}
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")

# (b): smoke configs deeper than 2 repeats, counted at repeats 1, 2 and whole
CASES = {
    "dense-tick": ("qwen3-1.7b", {"n_layers": 5}, ShapeSpec("d", "decode", 32, 4)),
    "dense-train": ("qwen3-1.7b", {"n_layers": 4}, ShapeSpec("t", "train", 16, 4)),
    "dense-prefill-chunks": ("qwen3-1.7b", {"n_layers": 4}, ShapeSpec("p", "prefill", 5 * 1024, 2)),
    "moe-train": ("arctic-480b", {"n_layers": 4}, ShapeSpec("t", "train", 16, 4)),
    "mla-tick": ("deepseek-v3-671b", {"n_layers": 5}, ShapeSpec("d", "decode", 32, 4)),
    "rwkv6-train": ("rwkv6-3b", {"n_layers": 4}, ShapeSpec("t", "train", 16, 4)),
    "mamba-train": ("jamba-v0.1-52b", {"n_layers": 12}, ShapeSpec("t", "train", 16, 4)),
}


def small(arch: str, **kw):
    return smoke_config(arch).replace(dtype="float32", **kw)


def _filled(t: torch.Tensor, shape) -> torch.Tensor:
    """A CPU block of ``shape`` and ``t``'s dtype: 0.01 for a float (every
    rank alike), 0 for an integer (token 0, position 0, step 0)."""
    fill = 0.01 if t.dtype.is_floating_point else 0
    return torch.full(tuple(shape), fill, dtype=t.dtype)


def realize(args):
    """The ``meta`` arguments of a step as CPU tensors of the same
    structure, shapes and placements (a DTensor keeps its mesh and
    placements, each rank filling its own block)."""
    from torch.distributed.tensor import DTensor

    def one(t):
        if isinstance(t, DTensor):
            return DTensor.from_local(_filled(t, t.to_local().shape), t.device_mesh, t.placements, run_check=False,
                                      shape=t.shape, stride=t.stride())
        return _filled(t, t.shape)

    leaves, treedef = tree.flatten(args)
    return tree.unflatten(treedef, [one(t) for t in leaves])


def family_counts(mesh, real: bool) -> dict:
    """family → {"tick", "train"} → this rank's calls, as the counter records them."""
    from repro_torch.dist.counting import count_collectives

    out = {}
    for fam, arch in FAMILIES.items():
        cfg = small(arch)
        out[fam] = {}
        for what, shape in SHAPES.items():
            step, args = costpass._build_step(cfg, shape, rules_for(cfg, shape), mesh=mesh)
            if real:
                args = realize(args)
            out[fam][what] = {k: dict(v) for k, v in count_collectives(step, *args).calls.items()}
    return out


def real_counts(rank: int, world: int) -> dict:
    """On a gloo rank: every family's tick and train step on CPU tensors."""
    return family_counts(make_mesh(MESH_SHAPE, MESH_AXES, device="cpu"), real=True)


def fake_main(part: str) -> dict:
    """In a fake world of four, on ``meta`` blocks of a mesh of ``cpu`` type
    (gloo's: DTensor then takes the same all-gather for a shard-to-shard
    step): ``part`` ``"families"``, (a)'s counts; ``"cases"``, each case of
    ``CASES`` counted at repeats 1 and 2 and corrected, and counted whole."""
    from repro_torch.dist.counting import collectives_of, fake_world

    fake_world(4)
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device="meta", device_type="cpu")
    if part == "families":
        return family_counts(mesh, real=False)
    out = {}
    for name, (arch, kw, shape) in CASES.items():
        cfg = small(arch, **kw)
        rules = rules_for(cfg, shape)
        sampled = costpass.count_mesh_cell(cfg, shape, mesh, rules)
        whole = costpass.count_mesh_cell(cfg, shape, mesh, rules, axes={})
        out[name] = {"method": sampled["method"], "R": sampled["R"],
                     "corrected": costpass.collectives_corrected(sampled["calls"], sampled["R"]),
                     "whole": collectives_of(whole["calls"][None]),
                     "memory": sampled["memory"], "memory_whole": whole["memory"]}
    return out


def production_main(out_dir: str, multi_pod: bool) -> dict:
    """In a fake world of 256 (512): Qwen3-1.7B at full width, decode_32k,
    written by the dry run (its CLI with ``--multi-pod`` on the 512-rank
    mesh) and corrected in place by the cost pass; on the 512-rank mesh
    also ``launch.hillclimb --multi-pod`` at the baseline and under
    ``dp_only`` (the batch over every axis, no weight split)."""
    import json
    import os

    from repro_torch.launch import dryrun, hillclimb

    path = os.path.join(out_dir, f"qwen3-1.7b__decode_32k__{'pod2x16x16' if multi_pod else 'pod16x16'}.json")
    if multi_pod:
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--multi-pod", "--out", out_dir])
    else:
        dryrun.dryrun_cell("qwen3-1.7b", "decode_32k", out_dir, multi_pod=False)
    with open(path) as fh:
        res = {"raw": json.load(fh)}
    if multi_pod:
        costpass.main(["--out", out_dir, "--arch", "qwen3-1.7b", "--multi-pod"])
    else:
        costpass.costpass_cell(path)
    with open(path) as fh:
        res["corrected"] = json.load(fh)
    if multi_pod:
        log = os.path.join(out_dir, "perf.jsonl")
        for levers in ("", "dp_only"):
            hillclimb.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--multi-pod", "--levers", levers,
                            "--log", log])
        with open(log) as fh:
            res["hillclimb"] = [json.loads(line) for line in fh]
    return res
