"""Serving launcher: parameters on the card + a serving engine.

Continuous batching by default (bucketed one-pass prefill + slot
scheduler); ``--engine fixed`` runs the fixed-batch loop instead, and so does
the default for a model with no one-pass prefill (recurrent,
encoder-decoder, VLM), which says so in one line.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke \\
        --prompts "1,2,3;4,5" --max-new 16

``--coded K,R`` makes the run straggler-tolerant: the decode-path state is
LCC-encoded to N = K + R simulated hosts every chunk
(``serve.coded.CodedServeGuard``) and ``--kill TICK:HOST`` (repeatable)
injects host faults mid-trace — in-flight requests are recovered from any K
surviving shards, not dropped:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke \\
        --prompts "1,2,3;4,5" --coded 3,2 --kill 2:0 --kill 6:4

Everything runs on the card unless ``--device cpu`` asks for the CPU. The
weights are random from seed 0 unless ``--ckpt`` names a checkpoint
directory (the reference's format, ``train.checkpoint``). The engines run
under the reference's decode rules (``launch.profiles.rules_for``) for
``--profile`` (``baseline``, the reference launcher's, by default; ``opt``
keeps a model that fits off FSDP), whose flags the model reads.
``--layers N`` cuts the depth to N layers (every width kept).

``--mesh DxM`` serves on a (data, model) mesh of D·M ranks started by
torchrun, each drawing only its own block of the weights from the seed
(``Model.init(generator, shardings=)`` on ``train.train_loop.param_shardings``),
which holds a full-width MoE model (DeepSeek-V3, Arctic) cut in depth on
one card; only rank 0 prints. Every family runs on a mesh, the recurrent,
encoder-decoder and VLM ones through the fixed-batch fall-back:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch rwkv6-3b --mesh 2x2 --smoke --device cpu

On the card the ranks share it over the port's staging backend
(``dist.staging``); on the CPU over gloo. ``--coded`` works on a mesh as on
one card: every rank runs the guard, the mesh's first rank gathers the
meshed decode state, encodes it and holds the coded shards, and a recovery
gives every rank the same rebuilt state:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch qwen3-1.7b --mesh 2x2 --smoke --device cpu --coded 3,2 --kill 2:0 --kill 6:4
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from ..configs import get, smoke_config
from ..configs.base import ShapeSpec
from ..core.field import resolve_device
from ..models import build_model
from ..serve import CodedServeGuard, ContinuousEngine, Engine, FaultInjector, Request
from ..train import latest_step, restore_checkpoint
from ..train.train_loop import param_shardings
from .mesh import launcher_mesh, parse_mesh
from .profiles import BASELINE, OPT, rules_for


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL ranks (under torchrun)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--prompts", default="1,2,3;7,8")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--engine", choices=["continuous", "fixed"], default="continuous")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--profile", default="baseline", choices=["baseline", "opt"],
                    help="the sharding rules (launch.profiles)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument(
        "--coded", default=None, metavar="K,R",
        help="LCC-protect the decode state: K data + R parity shards "
        "over N=K+R simulated hosts (continuous engine only)",
    )
    ap.add_argument(
        "--kill", action="append", default=[], metavar="TICK:HOST",
        help="inject a host fault after decode tick TICK (repeatable; needs --coded)",
    )
    args = ap.parse_args(argv)
    if args.kill and args.coded is None:
        ap.error("--kill requires --coded K,R")
    try:
        parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    dev = resolve_device(args.device)
    try:
        mesh, joined = launcher_mesh(args.mesh, dev)
    except ValueError as e:
        ap.error(str(e))
    try:
        return _serve(args, dev, mesh)
    finally:
        if joined:
            dist.destroy_process_group()


def _serve(args, dev, mesh):
    """The launcher after its flags: build, serve, print (rank 0 alone on a
    mesh)."""
    say = print if mesh is None or dist.get_rank() == 0 else (lambda *a, **k: None)
    cfg = smoke_config(args.arch) if args.smoke else get(args.arch)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    rules = rules_for(cfg, ShapeSpec("cli", "decode", args.max_len, 1), OPT if args.profile == "opt" else BASELINE)
    model = build_model(cfg)
    shardings = None if mesh is None else param_shardings(model, mesh, rules)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, shardings=shardings)
    if args.ckpt and latest_step(args.ckpt) is not None:
        params, _ = restore_checkpoint(args.ckpt, model.param_specs(), device=dev, shardings=shardings)

    prompts = [[int(t) for t in p.split(",") if t] for p in args.prompts.split(";")]
    use_continuous = args.engine == "continuous" and model.supports_prefill
    if args.engine == "continuous" and not use_continuous:
        say(f"{cfg.name}: no one-pass prefill; falling back to fixed-batch")
    if args.coded is not None and not use_continuous:
        raise SystemExit("--coded needs the continuous engine")

    if use_continuous:
        guard = None
        if args.coded is not None:
            K, R = (int(x) for x in args.coded.split(","))
            kills = tuple(tuple(int(x) for x in k.split(":")) for k in args.kill)
            guard = CodedServeGuard(K=K, R=R, injector=FaultInjector(kills=kills) if kills else None, device=dev)
        eng = ContinuousEngine(model, params, n_slots=args.slots, max_len=args.max_len,
                               max_new_tokens=args.max_new, rules=rules, mesh=mesh)
        reqs = [Request(id=f"cli-{i}", prompt=p, max_new_tokens=args.max_new) for i, p in enumerate(prompts)]
        rep = eng.serve(reqs, guard=guard)
        say(
            f"{rep.decode_steps} decode steps, {len(rep.results)} reqs, "
            f"{rep.tokens_per_s:.1f} tok/s, ttft p99 {rep.ttft_ms['p99']:.1f} ms, "
            f"{rep.prefill_compiles} prefill graphs, on {dev}"
        )
        if rep.coded is not None:
            c = rep.coded
            say(
                f"coded K={c['K']} R={c['R']}: {c['injected_faults']} faults "
                f"injected, {c['recoveries']} hosts recovered from, "
                f"{c['requests_recovered']} in-flight requests recovered, "
                f"recovery p99 {c['recovery_us']['p99']:.0f} us"
            )
        for r in rep.results:
            say(f"{r.id}: {r.tokens}")
        return rep
    eng = Engine(model, params, max_len=args.max_len, rules=rules, mesh=mesh)
    t0 = time.time()
    res = eng.generate(prompts, max_new_tokens=args.max_new)
    dt = time.time() - t0
    say(f"{res.steps} decode steps, {len(prompts)} seqs, {dt:.2f}s, on {dev}")
    for i, row in enumerate(res.tokens):
        say(f"seq {i}: {row[: res.lengths[i]].tolist()}")
    return res


if __name__ == "__main__":
    main()
