"""Training launcher: model → train step → synthetic data → checkpoint and
coded-parity cadence, on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --batch 8 --seq 256 --steps 20 --smoke

Every ``--coded-every`` steps ``CodedStateGuard(K=--coded-k)`` encodes the
parity of the train state ``{"params", "opt"}`` on the card; every
``--ckpt-every`` steps, and at the end, ``--ckpt`` receives a checkpoint in
the reference's format, and a run given a ``--ckpt`` that holds one resumes
from its latest step. The weights are random from seed 0.

``--profile`` picks the sharding rules as the reference does
(``launch.profiles.rules_for`` with ``OPT`` or ``BASELINE`` for the run's
batch and sequence) and the train step runs under them; on one card their
flags are what the model reads (neither profile sets ``moe_gather``).

Everything runs on the card unless ``--device cpu`` asks for the CPU.
``--layers N`` cuts the depth to N layers (every width kept). The
encoder-decoder and the VLM get their stub frontend's frames or patches
beside each step's tokens, drawn from the step's seed
(``models.inputs.frontend_inputs``; the reference's launcher feeds its
``SyntheticLM`` tokens alone, which those two families cannot take).

``--mesh DxM`` trains on a (data, model) mesh of D·M ranks started by
torchrun: each rank draws only its own block of the weights from the seed
(``Model.init(generator, shardings=)``), makes its moments beside them, and
draws the same global batch and keeps its shard (``train.train_loop``'s
``param_shardings``, ``opt_state_shardings``, ``batch_shardings``), every
family alike; the checkpoint is written whole by rank 0 and restored under
the same shardings; only rank 0 prints.
``--coded-every`` snapshots the sharded state on every rank together: rank 0
gathers it and alone holds the parity (``train.elastic.CodedStateGuard``),
so the returned guard recovers on rank 0's word, and
``guard.fail_and_recover`` (called on every rank) then ``reshard_state``
put the rebuilt state back on the mesh.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-1.7b --mesh 2x2 --smoke --device cpu --coded-every 1 --steps 3 --batch 4 --seq 32
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import get, smoke_config
from ..configs.base import ShapeSpec
from ..core.field import resolve_device
from ..models import build_model
from ..models.inputs import frontend_inputs
from ..train import (
    CodedStateGuard,
    OptConfig,
    SyntheticLM,
    init_state,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from ..train.data import to_device
from ..train.train_loop import batch_shardings, opt_state_shardings, param_shardings, place
from .mesh import launcher_mesh, parse_mesh
from .profiles import BASELINE, OPT, rules_for


def main(argv=None) -> dict:
    """Run the launcher; returns ``{"state", "history", "guard", "start",
    "seconds", "model", "opt_cfg", "rules"}``: the final ``{"params", "opt"}``, one
    ``{"step", "loss", "grad_norm", "s"}`` record a step (with ``mtp_ce``
    for a model with MTP, as the loss's metrics have it; ``s``: seconds
    since the loop began, read once the step's metrics reached the host), the
    guard, the step the run began at, the loop's wall seconds, the model, the
    optimizer's configuration and the sharding rules the step ran under."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL ranks (under torchrun)")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--profile", default="opt", choices=["baseline", "opt"],
                    help="the sharding rules (launch.profiles)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--coded-every", type=int, default=25)
    ap.add_argument("--coded-k", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
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
        return _train(args, dev, mesh)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, dev, mesh) -> dict:
    """The launcher after its flags (rank 0 alone prints on a mesh)."""
    say = print if mesh is None or dist.get_rank() == 0 else (lambda *a, **k: None)
    cfg = smoke_config(args.arch) if args.smoke else get(args.arch)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    rules = rules_for(cfg, ShapeSpec("cli", "train", args.seq, args.batch), OPT if args.profile == "opt" else BASELINE)
    model = build_model(cfg)
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)
    shardings = None
    if mesh is not None:
        shardings = {"params": param_shardings(model, mesh, rules),
                     "opt": opt_state_shardings(ocfg, model, mesh, rules)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, shardings=None if shardings is None else shardings["params"])
    opt_state = init_state(ocfg, params)
    if shardings is not None:  # the moments are already on the parameters' shardings; the step is placed
        opt_state = place(opt_state, shardings["opt"])
    start = 0
    if args.ckpt and latest_step(args.ckpt) is not None:
        state, start = restore_checkpoint(args.ckpt, {"params": params, "opt": opt_state}, device=dev,
                                          shardings=shardings)
        params, opt_state = state["params"], state["opt"]
        say(f"restored checkpoint at step {start}")

    step_fn = make_train_step(model, ocfg, rules=rules, mesh=mesh)
    bshard = None if mesh is None else batch_shardings(model, mesh, rules)
    ds = SyntheticLM(cfg)
    guard = CodedStateGuard(K=args.coded_k, device=dev)
    history = []
    t0 = time.perf_counter()
    for s in range(start, args.steps):
        batch = to_device({**ds.batch(s, args.batch, args.seq), **frontend_inputs(cfg, args.batch, s)}, dev)
        if bshard is not None:  # every rank drew the same global batch: each keeps its shard
            batch = place(batch, {k: bshard[k] for k in batch})
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in metrics.items()}
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        mtp = {"mtp_ce": float(metrics["mtp_ce"])} if "mtp_ce" in metrics else {}
        history.append({"step": s, "loss": loss, "grad_norm": gnorm, **mtp, "s": time.perf_counter() - t0})
        if s % 10 == 0 or s == args.steps - 1:
            say(f"step {s:5d} loss {loss:.4f} gnorm {gnorm:.3f}" + "".join(f" {k} {v:.4f}" for k, v in mtp.items()))
        if args.coded_every and s and s % args.coded_every == 0:
            guard.snapshot({"params": params, "opt": opt_state}, s)
        if args.ckpt and s and s % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, {"params": params, "opt": opt_state}, s)
    if args.ckpt:
        save_checkpoint(args.ckpt, {"params": params, "opt": opt_state}, args.steps)
    dt = time.perf_counter() - t0
    say(f"done: {args.steps - start} steps in {dt:.1f}s")
    return {"state": {"params": params, "opt": opt_state}, "history": history, "guard": guard, "start": start,
            "seconds": dt, "model": model, "opt_cfg": ocfg, "rules": rules}


if __name__ == "__main__":
    main()
