"""Serving demo (PyTorch port): continuous batching vs the fixed-batch
baseline.

Builds a small model, pushes a seeded Poisson trace of mixed-length
requests through the continuous-batching engine (bucketed one-pass prefill
+ slot-scheduled decode), prints per-request latencies, then runs the same
prompts through the fixed-batch engine for contrast. Runs on the card
unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.core.field import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import ContinuousEngine, Engine, LengthBand, poisson_trace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get("qwen3-1.7b").replace(
        name="qwen3-serve-demo",
        n_layers=4,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=768,
        vocab_size=32768,
        vocab_padded=0,
        remat="none",
    )
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    reqs = poisson_trace(
        n_requests=8,
        rate_rps=40.0,
        mix=(LengthBand(2, 6, 0.6), LengthBand(7, 16, 0.4)),
        max_new_tokens=12,
        vocab_size=cfg.vocab_size,
        seed=0,
    )

    eng = ContinuousEngine(
        model, params, n_slots=4, max_len=64, buckets=(8, 16, 32),
        max_new_tokens=12,
    )
    rep = eng.serve(reqs, greedy=True)
    print(
        f"continuous: {len(rep.results)} requests, {rep.tokens_per_s:.1f} tok/s, "
        f"ttft p50/p99 {rep.ttft_ms['p50']:.1f}/{rep.ttft_ms['p99']:.1f} ms, "
        f"occupancy {rep.slot_occupancy:.2f}, "
        f"{rep.prefill_compiles} prefill graphs (incl. compile)"
    )
    for r in rep.results[:4]:
        print(f"  {r.id}: {r.tokens[: r.prompt_len]} => "
              f"{r.tokens[r.prompt_len :][:8]} (ttft {r.ttft_s * 1e3:.1f} ms)")

    prompts = [r.prompt for r in reqs[:4]]
    feng = Engine(model, params, max_len=64)
    t0 = time.time()
    res = feng.generate(prompts, max_new_tokens=12)
    dt = time.time() - t0
    gen = int((res.lengths - res.prompt_lens).sum())
    print(f"fixed batch of {len(prompts)}: {res.steps} decode steps, "
          f"{gen} generated tokens in {dt:.2f}s (incl. compile)")
    res2 = feng.generate(prompts, max_new_tokens=12, greedy=False, seed=7)
    differs = not (res.tokens == res2.tokens).all()
    print("sampled variant differs:", differs)
    return {"continuous": rep, "fixed": res, "sampled_differs": bool(differs)}


if __name__ == "__main__":
    main()
