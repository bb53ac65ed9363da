#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors: four ranks on ``cuda:0``.

    python3 tools/gloo_cuda_probe.py [--device cuda] [--backend gloo|port]

For each collective that DTensor issues (``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_to_all_single``,
``broadcast``) one world of four spawned ranks joins a group with backend
``cpu:gloo,cuda:gloo`` and runs it once on a tensor on the card, through
``torch.distributed`` and through the functional collectives DTensor calls
(``torch.distributed._functional_collectives``); each world runs alone, so
one that aborts does not take the others with it (the worlds run side by side). Then one world runs a
small DTensor program on a (data=2, model=2) mesh: ``distribute_tensor``, a
sharded product, ``redistribute`` and ``full_tensor``, against the one-rank
result. ``--latency`` instead times, in one world, an all-reduce of a (4,
2048) float32 tensor on the card and on the host and a barrier (medians of
100, µs; the extra of rank 0's line). Prints one JSON line a world: ``ok`` (the values are right),
``wrong``, ``raised`` (with the message) or ``aborted`` (the exit code),
then the card's name and power limit. ``--backend port`` runs the worlds
over the port's staging backend (``repro_torch.dist.staging``) instead, and
prints the bytes rank 0 staged.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing as mp
import os
import queue
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

WORLD = 4
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
               "broadcast", "dtensor")
LATENCY_REPS = 100  # timed all-reduces of one (4, 2048) float32 tensor, after 5 untimed


def _wait(t):
    """A functional collective's result, waited for."""
    import torch.distributed._functional_collectives as fc

    return t.wait() if isinstance(t, fc.AsyncCollectiveTensor) else t


def _collective(name, rank, dev):
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    def base(r):
        return torch.arange(8, dtype=torch.float32, device=dev) + 100 * r

    want_sum = sum(base(r) for r in range(WORLD))
    if name == "all_reduce":
        t = base(rank)
        dist.all_reduce(t)
        return [(t, want_sum), (_wait(fc.all_reduce(base(rank), "sum", dist.group.WORLD)), want_sum)]
    if name == "all_gather_into_tensor":
        out = torch.empty(8 * WORLD, dtype=torch.float32, device=dev)
        dist.all_gather_into_tensor(out, base(rank))
        want = torch.cat([base(r) for r in range(WORLD)])
        f = _wait(fc.all_gather_tensor(base(rank), 0, dist.group.WORLD))
        return [(out, want), (f, want)]
    if name == "reduce_scatter_tensor":
        out = torch.empty(2, dtype=torch.float32, device=dev)
        dist.reduce_scatter_tensor(out, base(rank))
        want = want_sum[2 * rank:2 * rank + 2]
        f = _wait(fc.reduce_scatter_tensor(base(rank), "sum", 0, dist.group.WORLD))
        return [(out, want), (f, want)]
    if name == "all_to_all_single":
        out = torch.empty(8, dtype=torch.float32, device=dev)
        dist.all_to_all_single(out, base(rank))
        want = torch.cat([base(r)[2 * rank:2 * rank + 2] for r in range(WORLD)])
        f = _wait(fc.all_to_all_single(base(rank), None, None, dist.group.WORLD))
        return [(out, want), (f, want)]
    if name == "broadcast":
        t = base(rank)
        dist.broadcast(t, src=1)
        f = _wait(fc.broadcast(base(rank), 1, dist.group.WORLD))
        return [(t, base(1)), (f, base(1))]
    if name == "latency":
        def median_us(fn):
            for _ in range(5):
                fn()
            ts = []
            for _ in range(LATENCY_REPS):
                t = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t)
            return sorted(ts)[len(ts) // 2] * 1e6

        on_dev, on_host = torch.ones(4, 2048, device=dev), torch.ones(4, 2048)
        us = {"all_reduce_device_us": median_us(lambda: dist.all_reduce(on_dev)),
              "all_reduce_host_us": median_us(lambda: dist.all_reduce(on_host)),
              "barrier_us": median_us(dist.barrier)}
        if dev.type == "cuda":
            us["synchronize_us"] = median_us(torch.cuda.synchronize)
        _collective.latency = us
        return []
    if name == "dtensor":
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        mesh = init_device_mesh(dev.type, (2, 2), mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(0)
        a = torch.randn(8, 16, generator=g).to(dev)
        w = torch.randn(16, 12, generator=g).to(dev)
        da = distribute_tensor(a, mesh, [Shard(0), Replicate()], src_data_rank=None)
        dw = distribute_tensor(w, mesh, [Shard(0), Shard(1)], src_data_rank=None)
        y = torch.nn.functional.silu(da @ dw)
        full = y.redistribute(mesh, [Replicate(), Replicate()]).to_local()
        return [(full, torch.nn.functional.silu(a @ w)), (y.full_tensor(), torch.nn.functional.silu(a @ w))]
    raise KeyError(name)


def _rank(rank, init, name, device, backend, out):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if backend == "port":
            from repro_torch.dist.staging import register

            register()
        dist.init_process_group("port" if backend == "port" else "cpu:gloo,cuda:gloo", init_method=init, rank=rank, world_size=WORLD,
                                timeout=datetime.timedelta(seconds=30))
        pairs = _collective(name, rank, dev)
        ok = all(got.device.type == dev.type and torch.allclose(got.float().cpu(), want.float().cpu(), rtol=1e-5,
                                                                 atol=1e-5) for got, want in pairs)
        extra = dict(getattr(_collective, "latency", {}))
        if backend == "port":
            from repro_torch.dist.staging import staged_bytes

            extra["staged_bytes"] = staged_bytes()
        dist.destroy_process_group()
        out.put((rank, "ok" if ok else "wrong", extra))
    except BaseException:
        out.put((rank, "raised", traceback.format_exc()[-3000:]))


def probe(name: str, device: str, backend: str) -> dict:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        procs = [ctx.Process(target=_rank, args=(r, init, name, device, backend, out)) for r in range(WORLD)]
        for p in procs:
            p.start()
        got = {}
        t_end = time.monotonic() + 90
        while len(got) < WORLD and time.monotonic() < t_end:
            try:
                r, status, info = out.get(timeout=1.0)
                got[r] = (status, info)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) and all(
                        p.exitcode is not None or r in got for r, p in enumerate(procs)):
                    break
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.terminate()
                p.join(5)
        codes = [p.exitcode for p in procs]
    statuses = {got[r][0] for r in got}
    if len(got) < WORLD and any(c not in (0, None) for c in codes):
        result = "aborted"
    elif "raised" in statuses:
        result = "raised"
    elif statuses == {"ok"}:
        result = "ok"
    else:
        result = "wrong" if statuses else "hung"
    rec = {"collective": name, "device": device, "backend": backend, "result": result,
           "exit_codes": codes, "seconds": round(time.monotonic() - t0, 1)}
    msgs = [got[r][1] for r in sorted(got) if got[r][0] == "raised"]
    if msgs:
        rec["message"] = msgs[0].strip().splitlines()[-1][:300]
    extras = [got[r][1] for r in sorted(got) if got[r][0] == "ok" and got[r][1]]
    if extras:
        rec["rank0"] = extras[0]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "port"))
    ap.add_argument("--only", default=",".join(COLLECTIVES))
    ap.add_argument("--latency", action="store_true",
                    help="instead: one world timing an all-reduce of (4, 2048) float32, median of 100")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    names = ["latency"] if args.latency else args.only.split(",")
    with ThreadPoolExecutor(len(names)) as pool:  # the worlds run side by side, each alone
        for rec in pool.map(lambda n: probe(n, args.device, args.backend), names):
            print(json.dumps(rec), flush=True)
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
