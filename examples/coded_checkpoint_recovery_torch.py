"""Kill-and-recover demo (Remark 1 application, PyTorch port): 16 DP
replicas hold shards of a training state; one all-to-all encode (Cauchy
generator, universal prepare-and-shoot: C1=4 rounds, C2=Θ(√K)) builds
parity in device memory; we then kill up to 8 replicas and rebuild their
shards bit-exactly — no disk, no master. Runs on the card unless
``--device cpu``.

Run:  PYTHONPATH=src python examples/coded_checkpoint_recovery_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.coded import build_parity_plan, encode_parity, recover_lost, shard_state_limbs, unshard_state_limbs
from repro_torch.core.bounds import CostModel, allgather_baseline_c1_c2
from repro_torch.core.field import resolve_device, to_numpy, to_tensor
from repro_torch.core.schedule import counted_c2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    K = 16
    rng = np.random.default_rng(0)
    state = {
        "params": torch.from_numpy(rng.normal(size=(1_000_000,)).astype(np.float32)).to(dev),
        "m": torch.from_numpy(rng.normal(size=(1_000_000,)).astype(np.float32)).to(dev),
        "v": torch.from_numpy(abs(rng.normal(size=(1_000_000,))).astype(np.float32)).to(dev),
        "step": torch.tensor(1234, dtype=torch.int32, device=dev),
    }

    shards, meta = shard_state_limbs(state, K, device=dev)
    plan = build_parity_plan(K, p=1)
    print(f"state: {meta.total * 2 / 1e6:.1f} MB as {K} shards of {shards.shape[1] * 2 / 1e6:.2f} MB")
    print(f"encode schedule: C1={plan.c1} rounds, C2={counted_c2(plan.ps_plan)} elements/port "
          f"(all-gather baseline: {allgather_baseline_c1_c2(K, 1)[1]})")

    t0 = time.time()
    parity = to_numpy(encode_parity(shards, plan)).astype(np.uint64)
    print(f"parity encode: {time.time() - t0:.2f}s "
          f"(modelled time {CostModel().time(plan.c1, counted_c2(plan.ps_plan), shards.shape[1]) * 1e3:.2f} ms "
          f"under the α-β model's reference constants)")

    sn = to_numpy(shards).astype(np.uint64)
    recovered = {}
    for n_lost in (1, 4, 8):
        lost = list(rng.choice(K, size=n_lost, replace=False))
        t0 = time.time()
        rec = recover_lost(
            plan, lost,
            {k: sn[k] for k in range(K) if k not in lost},
            {k: parity[k] for k in range(K) if k not in lost},
        )
        ok = all(np.array_equal(rec[k], sn[k]) for k in lost)
        assert ok, f"lost {sorted(lost)}: recovery is not bit-exact"
        recovered[n_lost] = ok
        print(f"lost {n_lost:2d} replicas {sorted(lost)}: recovered bit-exact={ok} in {time.time() - t0:.2f}s")

    back = unshard_state_limbs(to_tensor(sn, dev), meta)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(back), tree.leaves(state)))
    print("full state reassembly: bit-exact")
    return {"K": K, "shards": tuple(shards.shape), "recovered": recovered}


if __name__ == "__main__":
    main()
