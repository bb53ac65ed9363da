"""Device bytes and walls of the coded entry points on one CUDA device, in the
tree of the current directory (its ``chip_smoke.py`` and ``src/``), so that two
trees can be compared on one card. Run from a tree's root:

    cd <tree> && python3 <checkout>/tools/coded_snapshot_memory.py   # ~2 min on an H100

At the widths of ``chip_smoke.py``'s phase ``coded`` (Qwen3-1.7B; weights
random from its seeds): ``CodedStateGuard(K=16).snapshot`` of one decoder
layer's training state (503 MB), ``encode_parity_collective`` flat and
(4, 4) over its limbs, ``CodedServeGuard(K=6, R=2).snapshot`` with
``collective=False`` and ``True`` over the KV cache of 28 layers (470 MB), and
``lcc_encode`` at K = 48 over 4 layers' cache. For each: the device bytes
held as it starts, at its peak and added (``chip_smoke.peak_of``, the first
call), and the median wall of ``REPS`` more calls, each synchronised. Prints
the card's name and power limit, then one JSON line an entry point.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

REPS = 3


def measure(entry: str, fn) -> dict:
    mem: dict = {}
    with cs.peak_of(mem, entry):
        out = fn()
    del out
    walls = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        del out
    torch.cuda.empty_cache()
    return {"entry": entry, **mem[entry], "wall_ms": statistics.median(walls), "walls_ms": walls}


def main() -> int:
    if not torch.cuda.is_available():
        print("coded_snapshot_memory: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs._build.build_all()
    print(cs.nvidia_smi_line(), flush=True)
    rows = []
    state = cs.make_state(cs.checkpoint_spec(), dev, cs.SEED + 700)
    guard = cs.CodedStateGuard(K=cs.CKPT_K, device=dev)
    rows.append(measure("CodedStateGuard.snapshot", lambda: guard.snapshot(state, step=1)))
    del guard
    shards, _ = cs.shard_state_limbs(state, cs.CKPT_K, dev)
    plan = cs.build_parity_plan(cs.CKPT_K)
    for entry, sizes in (("encode_parity_collective", None), ("encode_parity_collective(4, 4)", (4, 4))):
        fn = cs.encode_parity_collective(plan, sizes, device=dev)
        rows.append(measure(entry, lambda fn=fn: fn(shards)))
    del shards, state
    cache, sstate = cs.make_state(cs.serve_spec(), dev, cs.SEED + 800)
    for collective in (False, True):
        g = cs.CodedServeGuard(K=cs.SERVE_K, R=cs.SERVE_R, collective=collective, device=dev)
        rows.append(measure(f"CodedServeGuard.snapshot(collective={collective})",
                            lambda g=g: g.snapshot(cache, sstate, tick=0)))
        del g
    del cache, sstate
    qplan = cs.build_lcc(cs.SQUARE_K)
    X, _ = cs.shard_state_limbs(cs.make_state(cs.serve_spec(cs.SQUARE_LAYERS), dev, cs.SEED + 800), qplan.K, dev)
    rows.append(measure("lcc_encode", lambda: cs.lcc_encode(qplan, X)))
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
