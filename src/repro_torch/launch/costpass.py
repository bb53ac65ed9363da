"""The op-level cost of a dry-run cell, counted on ``meta`` tensors at a few
cut sizes and extrapolated exactly to the full one.

Counting a step op by op (``launch.op_cost``) costs host time for every op
the step dispatches, and the step's Python loops dispatch their bodies again
and again: 28 to 64 layers, 32 × 32 attention chunk pairs a layer at
``prefill_32k``, and a time scan of S steps a Mamba or RWKV layer. So a cell
is counted on a grid of cut sizes along up to three axes, each term of every
count is a polynomial of known degree in each axis, and the polynomial
through the grid gives the full size:

* ``repeats``: the body's repeats (the reference's ``_cfg_with_repeats``,
  the encoder's layers with them), at 1 and 2. Every term is affine in them.
* ``chunks``: a train or prefill sequence of more than ``LONG_CHUNKS``
  attention chunks (``layers.chunked_causal_attention``'s 1,024) is counted
  at 2, 3 and 4 chunks (2 to 5 in a train step). Chunk pairs cost the same,
  so the forward is at most quadratic in the chunk count; the backward is
  cubic, since each pair's gradient of a chunk slice is a tensor of the
  whole sequence, added to the others. (At one chunk a slice is the whole
  tensor and its gradient no copy: that count is off the polynomial.)
* ``steps``: the SSM families' time scans (``models.ssm._scan``) run 2 and 3
  of their steps and repeat the last output for the rest, which makes every
  term affine in the steps run; extrapolated to the scan's length. (With one
  step the last step's decay would reach no output, and its parameters no
  gradient.)

The flops, bytes and per-op terms are exact (``tests/test_torch_analysis.py``
holds the extrapolation against the full count). The live-bytes peak is
extrapolated the same way, which is exact where the peak falls at the same
point of every count.

Usage (recounts the records ``launch.dryrun`` wrote, in place)::

    PYTHONPATH=src python -m repro_torch.launch.costpass [--out results/dryrun_torch] [--arch A] [--full]
"""

from __future__ import annotations

import argparse
import glob
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch

from .. import tree
from ..configs import SHAPES, get
from ..configs.base import ShapeSpec
from ..models import build_model, decode_input_specs, train_batch_specs
from ..models.model import layer_pattern
from ..train import OptConfig, make_train_step, state_specs
from ..train.train_loop import (batch_shardings, cache_shardings, make_decode_step, make_prefill_step,
                                opt_state_shardings, param_shardings)
from .mesh import PRODUCTION_MESHES, dryrun_mesh
from .op_cost import Cost, count_fn
from .profiles import rules_for
from .rules import big_model

ATTN_CHUNK = 1024  # layers.chunked_causal_attention's chunk_q and chunk_k
LONG_CHUNKS = 4  # a train/prefill sequence of more chunks than this is counted at SAMPLE_CHUNKS
SAMPLE_REPEATS = (1, 2)
SAMPLE_CHUNKS = {"prefill": (2, 3, 4), "train": (2, 3, 4, 5)}
SAMPLE_STEPS = (2, 3)
_MEMORY = ("argument_bytes", "output_bytes", "peak_bytes")


def _cfg_with_repeats(cfg, r: int):
    prefix, body, repeats = layer_pattern(cfg)
    n_layers = len(prefix) + r * len(body)
    kw = {"n_layers": n_layers}
    if cfg.encdec is not None:
        kw["encdec"] = cfg.encdec.__class__(n_enc_layers=r, n_frames=cfg.encdec.n_frames)
    return cfg.replace(**kw), repeats


def _build_step(cfg, shape, rules=None, moment_dtype=None, mesh=None):
    """(step, its ``meta`` arguments) for the cell: the train step (AdamW,
    bf16 moments for the big models as the reference's dry run sets them),
    the prefill forward, or one decode step over a cache of ``seq_len``.
    With ``mesh`` (a ``launch.mesh.RankMesh`` of ``meta`` device) the step
    runs on it and every argument is a DTensor of ``meta`` blocks under the
    reference's shardings (``param_shardings``, ``opt_state_shardings``,
    ``batch_shardings``, ``cache_shardings``), but the decode step's tokens
    and positions, which every rank holds whole as the serving engines feed
    them (the reference splits them over ``batch``)."""
    model = build_model(cfg)
    pshapes = model.param_specs()
    if shape.kind == "train":
        ocfg = OptConfig(moment_dtype=moment_dtype or ("bfloat16" if big_model(cfg) else "float32"))
        step = make_train_step(model, ocfg, rules=rules, mesh=mesh)
        args = (pshapes, state_specs(ocfg, pshapes), train_batch_specs(cfg, shape))
        shard = mesh and (opt_state_shardings(ocfg, model, mesh, rules), _fields(model, mesh, rules, args[2]))
    elif shape.kind == "prefill":
        bspecs = train_batch_specs(cfg, shape)
        bspecs.pop("labels")
        step, args = make_prefill_step(model, rules=rules, mesh=mesh), (pshapes, bspecs)
        shard = mesh and (_fields(model, mesh, rules, bspecs),)
    else:
        cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
        dspecs = decode_input_specs(cfg, shape)
        step = make_decode_step(model, rules=rules, mesh=mesh)
        args = (pshapes, cache, dspecs["tokens"], dspecs["pos"])
        shard = mesh and (cache_shardings(model, mesh, rules, cache), None, None)
    if mesh is None:
        return step, args
    shard = (param_shardings(model, mesh, rules), *shard)
    return step, tuple(a if sh is None else meta_blocks(a, sh) for a, sh in zip(args, shard, strict=True))


def _fields(model, mesh, rules, batch) -> dict:
    """``batch_shardings`` of the fields ``batch`` has."""
    shardings = batch_shardings(model, mesh, rules)
    return {k: shardings[k] for k in batch}


def meta_blocks(specs, shardings):
    """Every ``meta`` leaf of ``specs`` as a DTensor under its sharding
    (``shardings`` has the same structure; a ``NamedSharding`` is a leaf of
    it), built from this rank's block shape (``DTensor.from_local``): no
    tensor is distributed, so no collective is issued."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    def block(t, sh):
        dm, pl = sh.mesh.device_mesh, sh.placements
        local, _ = compute_local_shape_and_global_offset(t.shape, dm, pl)
        return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), dm, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    leaves, treedef = tree.flatten(specs)
    return tree.unflatten(treedef, [block(t, sh) for t, sh in zip(leaves, tree.leaves(shardings), strict=True)])


def sample_axes(cfg, shape) -> dict:
    """axis → the sizes it is counted at, for the cell (see the module's
    docstring); an empty dict counts the cell whole."""
    axes = {}
    prefix, body, repeats = layer_pattern(cfg)
    enc_ok = cfg.encdec is None or cfg.encdec.n_enc_layers == repeats
    if repeats > max(SAMPLE_REPEATS) and enc_ok:
        axes["repeats"] = SAMPLE_REPEATS
    if shape.kind != "decode" and shape.seq_len % ATTN_CHUNK == 0 and shape.seq_len // ATTN_CHUNK > LONG_CHUNKS:
        axes["chunks"] = SAMPLE_CHUNKS[shape.kind]
    if cfg.ssm is not None and shape.kind != "decode":
        axes["steps"] = SAMPLE_STEPS
    return axes


def _lagrange(xs, x) -> list[float]:
    """Weights w_i with Σ w_i f(xs_i) = p(x), p the polynomial through the
    points (integers at integer points)."""
    ws = []
    for i, xi in enumerate(xs):
        num, den = 1, 1
        for j, xj in enumerate(xs):
            if j != i:
                num *= x - xj
                den *= xi - xj
        ws.append(num / den)
    return ws


def _terms(counter) -> dict:
    c = counter.cost
    t = {"flops": c.flops, "bytes": c.bytes, "tile_bytes": c.tile_bytes}
    t.update({f"by_op/{k}": v for k, v in c.by_op.items()})
    t.update({k: counter.memory[k] for k in _MEMORY})
    t.update({f"calls/{raw}/{k}": v for raw, c in getattr(counter, "calls", {}).items() for k, v in c.items()})
    return t


def _combine(weighted: list[tuple[float, dict]]) -> dict:
    out: dict = {}
    for w, terms in weighted:
        for k, v in terms.items():
            out[k] = out.get(k, 0.0) + w * v
    return out


def _by_repeat(cfg, shape, axes: dict, count) -> dict:
    """Body repeats → the terms of the cell's step at that depth, at full
    sequence and scan length: ``count(cfg_r, shape_n, m)`` (a counter) at
    each point of the grid of ``axes``, extrapolated over chunks and steps.
    Key ``None`` where the repeats are not sampled."""
    reps = axes.get("repeats", (None,))
    chunks = axes.get("chunks", (None,))
    steps = axes.get("steps", (None,))
    wn = _lagrange(chunks, shape.seq_len // ATTN_CHUNK) if chunks != (None,) else [1.0]
    out = {}
    for r in reps:
        cfg_r = cfg if r is None else _cfg_with_repeats(cfg, r)[0]
        per_n = []
        for n in chunks:
            shape_n = shape if n is None else ShapeSpec(shape.name, shape.kind, n * ATTN_CHUNK, shape.global_batch)
            counts = [count(cfg_r, shape_n, m) for m in steps]
            seen = set().union(*(c.scan_lengths for c in counts))
            if steps != (None,) and len(seen) > 1:
                raise ValueError(f"{cfg.name} × {shape.name}: scans of lengths {sorted(seen)} in one count")
            ws = _lagrange(steps, seen.pop()) if steps != (None,) and seen else [1.0] + [0.0] * (len(steps) - 1)
            per_n.append(_combine(list(zip(ws, map(_terms, counts)))))
        out[r] = _combine(list(zip(wn, per_n)))
    return out


def _method(axes: dict, shape, R: int) -> str:
    parts = []
    if "repeats" in axes:
        parts.append(f"repeats {','.join(map(str, axes['repeats']))}->{R}")
    if "chunks" in axes:
        parts.append(f"chunks {','.join(map(str, axes['chunks']))}->{shape.seq_len // ATTN_CHUNK}")
    if "steps" in axes:
        parts.append(f"steps {','.join(map(str, axes['steps']))}->scan")
    return "; ".join(parts) or "full"


def _memory(terms: dict) -> dict:
    memory = {k: terms.pop(k) for k in _MEMORY}
    memory["temp_bytes"] = memory["peak_bytes"] - memory["argument_bytes"] - memory["output_bytes"]
    return memory


def count_cell(cfg, shape, rules=None, moment_dtype=None, axes: dict | None = None) -> tuple[Cost, dict, str]:
    """The cell's (cost, memory, method): ``axes`` from :func:`sample_axes`
    unless given (``{}``: one count at full size). ``memory`` holds
    ``argument_bytes``, ``output_bytes``, ``peak_bytes`` and ``temp_bytes``
    (peak − argument − output)."""
    axes = sample_axes(cfg, shape) if axes is None else axes
    _, _, R = layer_pattern(cfg)

    def count(cfg_r, shape_n, m):
        fn, args = _build_step(cfg_r, shape_n, rules, moment_dtype)
        return count_fn(fn, *args, scan_steps=m)

    by_r = _by_repeat(cfg, shape, axes, count)
    reps = list(by_r)
    wr = _lagrange(reps, R) if reps != [None] else [1.0]
    terms = _combine([(w, by_r[r]) for w, r in zip(wr, reps)])
    cost = Cost(terms.pop("flops"), terms.pop("bytes"), terms.pop("tile_bytes"))
    memory = _memory(terms)
    for k, v in terms.items():
        cost.by_op[k.split("/", 1)[1]] = v
    return cost, memory, _method(axes, shape, R)


# ---------------------------------------------------------------------------
# the collectives on a mesh: the differential pass
# ---------------------------------------------------------------------------


def collective_axes(cfg, shape) -> dict:
    """The grid a cell's collectives are counted on: :func:`sample_axes`'s,
    with the body always at repeats 1 and 2 (the reference's differential
    pass) where the encoder's depth follows the body's. The chunks and the
    scan steps are sampled for the same reason as the op count's: the
    attention chunks and the time scans run inside regions and issue no
    collective of their own, but the sequence sets the bytes of every
    activation's redistribution."""
    axes = sample_axes(cfg, shape)
    _, _, repeats = layer_pattern(cfg)
    if "repeats" not in axes and (cfg.encdec is None or cfg.encdec.n_enc_layers == repeats):
        axes = {"repeats": SAMPLE_REPEATS, **axes}
    return axes


def count_mesh_cell(cfg, shape, mesh, rules=None, moment_dtype=None, axes: dict | None = None) -> dict:
    """The cell's step on ``mesh`` (a ``meta`` ``RankMesh`` over
    ``dist.counting.fake_world``), counted by ``dist.counting``'s counter
    on the grid of ``axes`` (:func:`collective_axes` unless given; ``{}``:
    once at full size): ``{"calls": by_repeat, "R", "memory", "method"}``.
    ``by_repeat`` maps each sampled body repeat (``None``: the whole body)
    to this rank's calls (staging name → ``count``, ``input_bytes``,
    ``output_bytes``) at full sequence and scan length; ``memory`` is the
    live-bytes tracker's over the local blocks, extrapolated to the full
    depth. Each count runs the step once before, unseen, so that DTensor's
    sharding propagation (which runs ops on tensors of the global shape)
    is cached and only the local blocks are tracked."""
    from ..dist.counting import count_collectives

    axes = collective_axes(cfg, shape) if axes is None else axes
    _, _, R = layer_pattern(cfg)

    def count(cfg_r, shape_n, m):
        step, args = _build_step(cfg_r, shape_n, rules, moment_dtype, mesh=mesh)
        count_collectives(step, *args, scan_steps=m)  # warms DTensor's propagation caches
        return count_collectives(step, *args, scan_steps=m)

    def calls(terms):
        out: dict = {}
        for k, v in terms.items():
            if k.startswith("calls/"):
                _, raw, field = k.split("/")
                out.setdefault(raw, {})[field] = int(round(v))
        return out

    by_r = _by_repeat(cfg, shape, axes, count)
    reps = list(by_r)
    wr = _lagrange(reps, R) if reps != [None] else [1.0]
    memory = _memory({k: v for k, v in _combine([(w, by_r[r]) for w, r in zip(wr, reps)]).items() if k in _MEMORY})
    return {"calls": {r: calls(t) for r, t in by_r.items()}, "R": R, "memory": memory,
            "method": _method(axes, shape, R)}


def collectives_corrected(by_repeat: dict, R: int) -> dict:
    """The reference's differential pass (``costpass.py:172-183``) on the
    counts at body repeats 1 and 2: per op, ``base`` the bytes at one
    repeat, ``per_layer`` the difference, ``bytes = base + (R − 1) ·
    per_layer``, and ``count`` extrapolated alike. A count at full depth
    (key ``None``) is its own correction."""
    from ..dist.counting import collectives_of

    if None in by_repeat:
        return {op: {"bytes": c["bytes"], "base": c["bytes"], "per_layer": 0, "count": c["count"]}
                for op, c in collectives_of(by_repeat[None]).items()}
    c1, c2 = collectives_of(by_repeat[1]), collectives_of(by_repeat[2])
    out = {}
    for op in sorted(set(c1) | set(c2)):
        b1, b2 = c1.get(op, {}).get("bytes", 0), c2.get(op, {}).get("bytes", 0)
        n1, n2 = c1.get(op, {}).get("count", 0), c2.get(op, {}).get("count", 0)
        out[op] = {"bytes": int(b1 + (R - 1) * (b2 - b1)), "base": b1, "per_layer": b2 - b1,
                   "count": int(n1 + (R - 1) * (n2 - n1))}
    return out


def corrected_bytes(corrected: dict) -> int:
    """``collective_bytes_per_device_corrected``: the ops' bytes, each
    clipped at 0, summed (the reference's)."""
    return int(sum(max(v["bytes"], 0) for v in corrected.values()))


def cost_record(cost: Cost, method: str) -> dict:
    """The ``op_cost`` block of a dry-run record."""
    return {
        "flops_global": cost.flops,
        "bytes_global": cost.bytes,
        "tile_bytes_global": cost.tile_bytes,
        "product_flops_global": cost.product_flops,
        "method": method,
        "by_op": {k: v for k, v in sorted(cost.by_op.items(), key=lambda kv: -kv[1])},
    }


def costpass_cell(path: str, full: bool = False) -> dict | None:
    """Recount one dry-run record in place (``full``: at full size, no
    extrapolation): its ``op_cost`` and ``memory``, and on a production
    mesh (whose fake world this process then joins) the differential
    collective pass: ``collectives_corrected`` (op → ``bytes``, ``base``,
    ``per_layer``, ``count``), ``collective_bytes_per_device_corrected``
    and ``memory`` over a device's local blocks."""
    with open(path) as fh:
        rec = json.load(fh)
    if rec.get("status") != "ok":
        return None
    cfg, shape = get(rec["arch"]), SHAPES[rec["shape"]]
    rules = rules_for(cfg, shape)
    t0 = time.time()
    try:
        cost, memory, method = count_cell(cfg, shape, rules, axes={} if full else None)
        rec["op_cost"] = cost_record(cost, method)
        rec["memory"] = memory
        coll = ""
        if rec["mesh"] in PRODUCTION_MESHES:
            counted = count_mesh_cell(cfg, shape, dryrun_mesh(PRODUCTION_MESHES[rec["mesh"]]), rules,
                                      axes={} if full else None)
            rec["collectives_corrected"] = collectives_corrected(counted["calls"], counted["R"])
            rec["collective_bytes_per_device_corrected"] = corrected_bytes(rec["collectives_corrected"])
            rec["collective_method"] = counted["method"]
            rec["memory"] = counted["memory"]
            coll = f", coll_corr {rec['collective_bytes_per_device_corrected'] / 1e9:.3f} GB/dev"
        rec["costpass_s"] = round(time.time() - t0, 2)
        print(f"[cost] {rec['arch']} × {rec['shape']} × {rec['mesh']}: flops {cost.flops:.3e}, "
              f"bytes {cost.bytes:.3e}{coll} ({method}, {rec['costpass_s']}s)")
    except Exception as e:  # noqa: BLE001 — one cell's failure is recorded, the pass goes on
        rec["costpass_error"] = f"{type(e).__name__}: {e}"
        rec["costpass_traceback"] = traceback.format_exc()[-3000:]
        print(f"[cost ERROR] {rec['arch']} {rec['shape']} {rec['mesh']}: {rec['costpass_error']}")
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=2)
    return rec


def _cell(job):
    return costpass_cell(*job)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Recount the port's dry-run records: the op-level cost, and on a "
                                             "production mesh the differential collective pass")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--full", action="store_true", help="count at full size (slow), no extrapolation")
    ap.add_argument("--multi-pod", action="store_true", help="the pod2x16x16 records")
    ap.add_argument("--both-meshes", action="store_true", help="the pod16x16 and pod2x16x16 records")
    ap.add_argument("--jobs", type=int, default=1, help="worker processes (a production mesh's records)")
    args = ap.parse_args(argv)
    tags = ["pod16x16", "pod2x16x16"] if args.both_meshes else ["pod2x16x16"] if args.multi_pod else ["1xH100"]
    for tag in tags:
        jobs = [(p, args.full) for p in sorted(glob.glob(os.path.join(args.out, f"{args.arch or '*'}__*__{tag}.json")))]
        if tag not in PRODUCTION_MESHES or (len(tags) == 1 and args.jobs <= 1):
            for job in jobs:
                _cell(job)
            continue
        # a mesh's fake world is joined once a process: its records in workers of their own
        with ProcessPoolExecutor(max(1, args.jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(_cell, jobs))


if __name__ == "__main__":
    main()
