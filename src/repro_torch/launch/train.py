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

Everything runs on the card unless ``--device cpu`` asks for the CPU. Only a
``1x1`` mesh runs: a larger one waits for the device half of the sharding
substrate (ROADMAP.md queue A3).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get, smoke_config
from ..configs.base import ShapeSpec
from ..core.field import resolve_device
from ..models import build_model
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
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL; only 1x1 runs")
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
    if args.mesh != "1x1":
        ap.error(f"--mesh {args.mesh}: only 1x1 runs; a mesh waits for the sharding substrate "
                 "(ROADMAP.md queue A3)")

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get(args.arch)
    rules = rules_for(cfg, ShapeSpec("cli", "train", args.seq, args.batch), OPT if args.profile == "opt" else BASELINE)
    model = build_model(cfg)
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    opt_state = init_state(ocfg, params)
    start = 0
    if args.ckpt and latest_step(args.ckpt) is not None:
        state, start = restore_checkpoint(args.ckpt, {"params": params, "opt": opt_state}, device=dev)
        params, opt_state = state["params"], state["opt"]
        print(f"restored checkpoint at step {start}")

    step_fn = make_train_step(model, ocfg, rules=rules)
    ds = SyntheticLM(cfg)
    guard = CodedStateGuard(K=args.coded_k, device=dev)
    history = []
    t0 = time.perf_counter()
    for s in range(start, args.steps):
        batch = to_device(ds.batch(s, args.batch, args.seq), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        mtp = {"mtp_ce": float(metrics["mtp_ce"])} if "mtp_ce" in metrics else {}
        history.append({"step": s, "loss": loss, "grad_norm": gnorm, **mtp, "s": time.perf_counter() - t0})
        if s % 10 == 0 or s == args.steps - 1:
            print(f"step {s:5d} loss {loss:.4f} gnorm {gnorm:.3f}" + "".join(f" {k} {v:.4f}" for k, v in mtp.items()))
        if args.coded_every and s and s % args.coded_every == 0:
            guard.snapshot({"params": params, "opt": opt_state}, s)
        if args.ckpt and s and s % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, {"params": params, "opt": opt_state}, s)
    if args.ckpt:
        save_checkpoint(args.ckpt, {"params": params, "opt": opt_state}, args.steps)
    dt = time.perf_counter() - t0
    print(f"done: {args.steps - start} steps in {dt:.1f}s")
    return {"state": {"params": params, "opt": opt_state}, "history": history, "guard": guard, "start": start,
            "seconds": dt, "model": model, "opt_cfg": ocfg, "rules": rules}


if __name__ == "__main__":
    main()
