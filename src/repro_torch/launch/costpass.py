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
import itertools
import json
import os
import time
import traceback

from ..configs import SHAPES, get
from ..configs.base import ShapeSpec
from ..models import build_model, decode_input_specs, train_batch_specs
from ..models.model import layer_pattern
from ..train import OptConfig, make_train_step, state_specs
from ..train.train_loop import make_decode_step, make_prefill_step
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


def _build_step(cfg, shape, rules=None, moment_dtype=None):
    """(step, its ``meta`` arguments) for the cell: the train step (AdamW,
    bf16 moments for the big models as the reference's dry run sets them),
    the prefill forward, or one decode step over a cache of ``seq_len``."""
    model = build_model(cfg)
    pshapes = model.param_specs()
    if shape.kind == "train":
        ocfg = OptConfig(moment_dtype=moment_dtype or ("bfloat16" if big_model(cfg) else "float32"))
        step = make_train_step(model, ocfg, rules=rules)
        return step, (pshapes, state_specs(ocfg, pshapes), train_batch_specs(cfg, shape))
    if shape.kind == "prefill":
        bspecs = train_batch_specs(cfg, shape)
        bspecs.pop("labels")
        return make_prefill_step(model, rules=rules), (pshapes, bspecs)
    cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
    dspecs = decode_input_specs(cfg, shape)
    return make_decode_step(model, rules=rules), (pshapes, cache, dspecs["tokens"], dspecs["pos"])


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
    return t


def _combine(weighted: list[tuple[float, dict]]) -> dict:
    out: dict = {}
    for w, terms in weighted:
        for k, v in terms.items():
            out[k] = out.get(k, 0.0) + w * v
    return out


def count_cell(cfg, shape, rules=None, moment_dtype=None, axes: dict | None = None) -> tuple[Cost, dict, str]:
    """The cell's (cost, memory, method): ``axes`` from :func:`sample_axes`
    unless given (``{}``: one count at full size). ``memory`` holds
    ``argument_bytes``, ``output_bytes``, ``peak_bytes`` and ``temp_bytes``
    (peak − argument − output)."""
    axes = sample_axes(cfg, shape) if axes is None else axes
    _, _, R = layer_pattern(cfg)
    reps = axes.get("repeats", (None,))
    chunks = axes.get("chunks", (None,))
    steps = axes.get("steps", (None,))
    grid: dict = {}
    for r, n in itertools.product(reps, chunks):
        cfg_r = cfg if r is None else _cfg_with_repeats(cfg, r)[0]
        shape_n = shape if n is None else ShapeSpec(shape.name, shape.kind, n * ATTN_CHUNK, shape.global_batch)
        counts = []
        for m in steps:
            fn, args = _build_step(cfg_r, shape_n, rules, moment_dtype)
            counts.append(count_fn(fn, *args, scan_steps=m))
        seen = set().union(*(c.scan_lengths for c in counts))
        if steps != (None,) and len(seen) > 1:
            raise ValueError(f"{cfg.name} × {shape.name}: scans of lengths {sorted(seen)} in one count")
        ws = _lagrange(steps, seen.pop()) if steps != (None,) and seen else [1.0] + [0.0] * (len(steps) - 1)
        grid[r, n] = _combine(list(zip(ws, map(_terms, counts))))
    wr = _lagrange(reps, R) if reps != (None,) else [1.0]
    wn = _lagrange(chunks, shape.seq_len // ATTN_CHUNK) if chunks != (None,) else [1.0]
    terms = _combine([(a * b, grid[r, n]) for (a, r), (b, n) in itertools.product(zip(wr, reps), zip(wn, chunks))])
    cost = Cost(terms.pop("flops"), terms.pop("bytes"), terms.pop("tile_bytes"))
    memory = {k: terms.pop(k) for k in _MEMORY}
    memory["temp_bytes"] = memory["peak_bytes"] - memory["argument_bytes"] - memory["output_bytes"]
    for k, v in terms.items():
        cost.by_op[k.split("/", 1)[1]] = v
    parts = []
    if "repeats" in axes:
        parts.append(f"repeats {','.join(map(str, reps))}->{R}")
    if "chunks" in axes:
        parts.append(f"chunks {','.join(map(str, chunks))}->{shape.seq_len // ATTN_CHUNK}")
    if "steps" in axes:
        parts.append(f"steps {','.join(map(str, steps))}->scan")
    return cost, memory, "; ".join(parts) or "full"


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
    """Recount one dry-run record's ``op_cost`` and ``memory`` in place
    (``full``: at full size, no extrapolation)."""
    with open(path) as fh:
        rec = json.load(fh)
    if rec.get("status") != "ok":
        return None
    cfg, shape = get(rec["arch"]), SHAPES[rec["shape"]]
    t0 = time.time()
    try:
        cost, memory, method = count_cell(cfg, shape, rules_for(cfg, shape), axes={} if full else None)
        rec["op_cost"] = cost_record(cost, method)
        rec["memory"] = memory
        rec["costpass_s"] = round(time.time() - t0, 2)
        print(f"[cost] {rec['arch']} × {rec['shape']}: flops {cost.flops:.3e}, bytes {cost.bytes:.3e} "
              f"({method}, {rec['costpass_s']}s)")
    except Exception as e:  # noqa: BLE001 — one cell's failure is recorded, the pass goes on
        rec["costpass_error"] = f"{type(e).__name__}: {e}"
        rec["costpass_traceback"] = traceback.format_exc()[-3000:]
        print(f"[cost ERROR] {rec['arch']} {rec['shape']}: {rec['costpass_error']}")
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="Recount the op-level cost of the port's dry-run records")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--full", action="store_true", help="count at full size (slow), no extrapolation")
    args = ap.parse_args(argv)
    for path in sorted(glob.glob(os.path.join(args.out, f"{args.arch or '*'}__*.json"))):
        costpass_cell(path, full=args.full)


if __name__ == "__main__":
    main()
