"""End-to-end training driver (PyTorch port): ~100M-param qwen3-family
model, a few hundred steps on the synthetic pipeline, with coded
fault-tolerance active — a Cauchy parity snapshot of (params, opt state)
every ``--coded-every`` steps, a simulated 3-node failure at ``--fail-at``
recovered bit-exactly from survivors (checked against the snapshot's
state), and a disk checkpoint at the end. Runs on the card unless
``--device cpu``; ``--smoke`` swaps in the family's smoke config (on the
CPU the ~110M-param state's parity takes minutes).

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]
"""

import argparse
import time

import torch

from repro_torch import tree
from repro_torch.configs import get, smoke_config
from repro_torch.core.field import resolve_device
from repro_torch.models import build_model
from repro_torch.train import (
    CodedStateGuard,
    OptConfig,
    SyntheticLM,
    init_state,
    make_train_step,
    save_checkpoint,
)
from repro_torch.train.data import to_device


def model_config(smoke: bool = False):
    """~110M params: qwen3 family, reduced depth/width, full qk-norm/GQA/tied-emb
    (``smoke``: the family's smoke config)."""
    if smoke:
        return smoke_config("qwen3-1.7b")
    return get("qwen3-1.7b").replace(
        name="qwen3-110m",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=6,
        head_dim=64,
        d_ff=2304,
        vocab_size=32768,
        vocab_padded=0,
        remat="none",
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--fail-at", type=int, default=60)
    ap.add_argument("--coded-every", type=int, default=50)
    ap.add_argument("--ckpt", default="results/ckpt_train_lm_torch")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="the family's reduced smoke config instead of ~110M params (a quick CPU run)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_config(args.smoke)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"model: {cfg.name}, {n_params / 1e6:.1f}M params")

    ocfg = OptConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps)
    opt_state = init_state(ocfg, params)
    step_fn = make_train_step(model, ocfg)
    ds = SyntheticLM(cfg)
    guard = CodedStateGuard(K=8, device=dev)

    recovered_exact = None
    losses = []
    t0 = time.time()
    for s in range(args.steps):
        batch = ds.batch(s, args.batch, args.seq)
        params, opt_state, metrics = step_fn(params, opt_state, to_device(batch, dev))
        losses.append(float(metrics["loss"]))
        if s % args.coded_every == 0:
            guard.snapshot({"params": params, "opt": opt_state}, step=s)
            snap = {"params": params, "opt": opt_state}
            print(
                f"step {s:4d}  loss {float(metrics['loss']):.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  lr {float(metrics['lr']):.2e}  "
                f"[coded parity snapshot: C1={guard.plan.c1} rounds]"
            )
        if s == args.fail_at:
            print(f"step {s:4d}  !! simulating loss of replicas {{1, 4, 6}} …")
            state, at = guard.fail_and_recover(lost=[1, 4, 6])
            recovered_exact = all(torch.equal(a, b) for a, b in zip(tree.leaves(state), tree.leaves(snap)))
            assert recovered_exact, "the recovered state differs from the snapshot's"
            params, opt_state = state["params"], state["opt"]
            print(f"           recovered bit-exactly from snapshot at step {at}; resuming")
    dt = time.time() - t0
    print(f"\n{args.steps} steps in {dt:.1f}s ({args.steps / dt:.2f} steps/s)")
    save_checkpoint(args.ckpt, {"params": params, "opt": opt_state}, args.steps)
    print(f"final checkpoint: {args.ckpt}")
    return {"losses": losses, "recovered_exact": recovered_exact, "seconds": dt, "params": n_params}


if __name__ == "__main__":
    main()
