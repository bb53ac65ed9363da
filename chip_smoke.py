#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch``'s main path — the all-to-all encode — once on the
card, at a width its users would call real, and checks everything it
computes. It imports ``repro_torch`` only (never JAX, never the JAX package).
Phases, each printing one JSON line; any failure ends the run non-zero:

1. ``env``      torch/CUDA versions, the card's name and power limit.
2. ``build``    builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc.
3. ``kernels``  each kernel against its plain PyTorch version on the card,
                bit for bit (tolerance 0: the arithmetic is exact mod q), over
                ragged, tiny and extreme-valued shapes and at every shape
                that phase 4 hands it, with its time, its plain version's
                time and its bound at each of those.
4. ``universal`` (K=64, M31), ``dft`` (K=64, NTT), ``draw_loose`` (K=48, NTT),
                each with 2^20 payload elements a processor, through
                ``a2a_encode`` and through ``ir_encode(kernels="cuda")``: both
                equal, equal to a plain ``x @ A mod q`` on the card and to the
                host oracle on sampled columns, decodes invert, the kernels'
                launch counters and the executor's permutation counter hold
                the expected numbers. Then each encode's median wall time and,
                under ``torch.profiler``, its device-busy time, idle share and
                busiest device kernels by name.
5. a line ``{"kernels": [...]}`` with every kernel's launches on the main
   path, error, time, bound and plain time; the card's name and power limit;
   and last ``{"ok": true, "device": {...}}``.

The widths, repeat counts and seed are the constants below: the script takes
no arguments. Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.draw_loose import decode_dft, decode_draw_loose  # noqa: E402
from repro_torch.core.encode import a2a_encode, plan_for  # noqa: E402
from repro_torch.core.field import M31, NTT, Field, shoup_precompute, to_numpy, to_tensor  # noqa: E402
from repro_torch.core.ir import LocalOp, ir_permute_count  # noqa: E402
from repro_torch.core.matrices import butterfly_target_matrix, random_matrix  # noqa: E402
from repro_torch.core.prepare_shoot import encode_oracle  # noqa: E402
from repro_torch.core.schedule import draw_loose_target_matrix  # noqa: E402
from repro_torch.dist.collectives import expected_permute_count, ir_encode  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.butterfly.kernel import butterfly_mac_cuda, butterfly_mac_plain  # noqa: E402
from repro_torch.kernels.butterfly.ops import butterfly_mac  # noqa: E402
from repro_torch.kernels.gf_matmul.kernel import gf_matmul_cuda, gf_matmul_plain  # noqa: E402
from repro_torch.kernels.gf_matmul.ops import gf_matmul, gf_matmul_batched  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet): the yardsticks of
# ``bound_ms``. 32-bit integer multiply-adds run outside the tensor cores on
# half as many lanes as float32 (64 against 128 an SM), so their peak is taken
# as half the 67 TFLOP/s float32 rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2

PAYLOAD = 1 << 20  # elements a processor: 4 MiB packets
KERNEL_REPS = 12  # timed runs of each kernel (median)
ENCODE_REPS = 3  # timed runs of each encode (median), and encodes a profile
SAMPLE_COLS = 4096  # payload columns held against the host oracle
SEED = 0

KERNEL_SOURCES = {
    "gf_matmul": {
        "source": "src/repro_torch/csrc/gf_matmul.cu",
        "replaces": "src/repro/kernels/gf_matmul/kernel.py:125",
    },
    "butterfly_mac": {
        "source": "src/repro_torch/csrc/butterfly_mac.cu",
        "replaces": "src/repro/kernels/butterfly/kernel.py:55",
    },
}
# No single PyTorch call computes an exact mod-q matrix product of 31-bit
# residues (integer matmul is not offered on the card, a float one is not
# exact) or a Shoup multiply-accumulate: there is no library yardstick.
LIBRARY_MS = None


def say(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` in ms, synchronised before and after."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rand_residues(shape, q: int, dev, seed: int) -> torch.Tensor:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randint(0, q, shape, dtype=torch.int32, device=dev, generator=g)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    check(r.returncode == 0 and r.stdout.strip(), f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the three configurations of the main path, and the shapes they hand the kernels
# ---------------------------------------------------------------------------


def make_configs() -> list[dict]:
    """Plans, IRs and target matrices of the three full-width encodes
    (host-side work only)."""
    configs = []
    for name, kind, K, q, seed in (
        ("universal", "general", 64, M31, SEED + 100),
        ("dft", "dft", 64, NTT, SEED + 200),
        ("draw_loose", "vandermonde", 48, NTT, SEED + 300),
    ):
        f = Field(q)
        cfg = {"name": name, "kind": kind, "K": K, "q": q, "seed": seed, "A": None}
        if kind == "general":
            cfg["A"] = random_matrix(f, K, seed=seed + 1)
            plan = plan_for("general", K, 1, q)
            cfg.update(plan=plan, ir=plan.to_ir(cfg["A"], q=q), target=np.asarray(cfg["A"]),
                       budget=expected_permute_count(plan))
        elif kind == "dft":
            plan = plan_for("dft", K, 1, q)
            cfg.update(plan=plan, ir=plan.to_ir(), target=butterfly_target_matrix(f, K, 2),
                       budget=plan.H * plan.p)
        else:
            plan = plan_for("vandermonde", K, 1, q, seed=seed + 1)
            ir = plan.to_ir()
            cfg.update(plan=plan, ir=ir, target=draw_loose_target_matrix(plan), budget=ir_permute_count(ir))
        configs.append(cfg)
    return configs


def a2a_kernel_calls(cfg: dict, P: int) -> list[tuple]:
    """The kernel calls ``a2a_encode`` makes for one configuration, in order:
    ``("gf_matmul", (batch, M, K, N))`` or ``("butterfly_mac", (radix, B, P))``."""
    plan, K = cfg["plan"], cfg["K"]
    if cfg["kind"] == "general":  # shoot_init: w[k] = coefT[k] @ buf[k]
        return [("gf_matmul", (K, plan.n, plan.m, P))]
    if cfg["kind"] == "dft":  # one launch a butterfly round
        return [("butterfly_mac", (plan.radix, K, P))] * plan.H
    calls = []
    if plan.draw_plan is not None:  # M processors, (Z, P) as their payload
        d = plan.draw_plan
        calls.append(("gf_matmul", (plan.M, d.n, d.m, plan.Z * P)))
    if plan.loose_plan is not None:  # Z processors, (M, P) as their payload
        lp = plan.loose_plan
        calls += [("butterfly_mac", (lp.radix, plan.Z, plan.M * P))] * lp.H
    return calls


def ir_kernel_calls(ir, P: int) -> list[tuple]:
    """The kernel calls ``ir_encode(kernels="cuda")`` makes for ``ir``: a
    LocalOp with one general row (not uniformly 0 or 1 across processors) is
    one butterfly_mac over its input slots, with several one gf_matmul_batched."""
    calls = []
    for step in ir.steps:
        if not isinstance(step, LocalOp):
            continue
        c = np.asarray(step.coeffs)  # (K, n_out, n_in)
        general = sum(
            1
            for i in range(c.shape[1])
            if not (np.all(c[:, i] == 0, axis=0) | np.all(c[:, i] == 1, axis=0)).all()
        )
        if general == 1:
            calls.append(("butterfly_mac", (c.shape[2], ir.K, P)))
        elif general > 1:
            calls.append(("gf_matmul", (ir.K, general, c.shape[2], P)))
    return calls


def count_calls(calls: list[tuple]) -> tuple[int, int]:
    """(gf_matmul, butterfly_mac) launches in a list of kernel calls."""
    return (sum(1 for k, _ in calls if k == "gf_matmul"),
            sum(1 for k, _ in calls if k == "butterfly_mac"))


def path_shapes(configs: list[dict], P: int) -> dict[str, list]:
    """kernel name → [(shape, q, [who calls it so])], each shape once, in the
    order the main path meets them (the first is the shape the kernels' line
    reports)."""
    seen: dict[str, dict] = {"gf_matmul": {}, "butterfly_mac": {}}
    for cfg in configs:
        for entry, calls in (("a2a_encode", a2a_kernel_calls(cfg, P)),
                             ("ir_encode", ir_kernel_calls(cfg["ir"], P))):
            for kernel, shape in calls:
                who = seen[kernel].setdefault((shape, cfg["q"]), [])
                if f"{cfg['name']}/{entry}" not in who:
                    who.append(f"{cfg['name']}/{entry}")
    return {k: [(shape, q, who) for (shape, q), who in v.items()] for k, v in seen.items()}


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def bound(nbytes: int, ops: int) -> dict:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def kernel_row(name: str, cases: int, worst: int, at_shapes: list[dict]) -> dict:
    """The kernel's line: its numbers at the first main-path shape, and every
    main-path shape's numbers under ``shapes``."""
    first = at_shapes[0]
    return {
        "name": name,
        "route": "cuda",
        **KERNEL_SOURCES[name],
        "shape": first["shape"],
        "cases": cases + len(at_shapes),
        "max_abs_err": max([worst] + [r["max_abs_err"] for r in at_shapes]),
        **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": LIBRARY_MS,
        "shapes": at_shapes,
    }


def check_gf_matmul(dev, shapes: list) -> dict:
    worst = 0
    cases = 0
    # the reference tests' shape grid: one block, multi-block, ragged, degenerate
    grid = [(8, 8, 128), (128, 512, 128), (256, 1024, 256), (130, 70, 200), (1, 16, 1),
            (13, 21, 130), (40, 100, 257), (16, 24, 8), (3, 5, 1021)]
    for q in (M31, NTT, 65537, 97):
        for i, (M, K, N) in enumerate(grid):
            a = rand_residues((M, K), q, dev, seed=M + K)
            b = rand_residues((K, N), q, dev, seed=N + K + 1)
            got = gf_matmul(a, b, q=q)
            want = gf_matmul_plain(a[None], b[None], q)[0]
            worst = max(worst, max_abs_err(got, want))
            check(same(got, want), f"gf_matmul != plain at {(M, K, N)}, q={q}")
            if i < 3 or q in (M31, NTT):
                host = Field(q).matmul(to_numpy(a), to_numpy(b)).astype(np.uint32)
                check(np.array_equal(to_numpy(got), host), f"gf_matmul != host oracle at {(M, K, N)}, q={q}")
            cases += 1
    for q in (M31, NTT):  # operands of all q-1: the accumulator's worst case
        a = torch.full((64, 512), q - 1, dtype=torch.int32, device=dev)
        b = torch.full((512, 128), q - 1, dtype=torch.int32, device=dev)
        got = gf_matmul(a, b, q=q)
        want = gf_matmul_plain(a[None], b[None], q)[0]
        worst = max(worst, max_abs_err(got, want))
        check(same(got, want), f"gf_matmul != plain on all q-1, q={q}")
        host = Field(q).matmul(to_numpy(a), to_numpy(b)).astype(np.uint32)
        check(np.array_equal(to_numpy(got), host), f"gf_matmul != host oracle on all q-1, q={q}")
        cases += 1
    # batched, ragged
    a = rand_residues((6, 9, 17), M31, dev, seed=3)
    b = rand_residues((6, 17, 5), M31, dev, seed=4)
    got = gf_matmul_batched(a, b, q=M31)
    check(same(got, gf_matmul_plain(a, b, M31)), "gf_matmul_batched != plain")
    cases += 1
    # zero-size operands: guarded in ops, no launch
    before = gf_matmul_cuda.launches
    for M, K, N in [(0, 8, 8), (8, 0, 8), (8, 8, 0), (0, 0, 0)]:
        z = gf_matmul(
            torch.zeros((M, K), dtype=torch.int32, device=dev),
            torch.zeros((K, N), dtype=torch.int32, device=dev),
            q=M31,
        )
        check(z.shape == (M, N) and not z.any(), f"zero-size guard at {(M, K, N)}")
    check(gf_matmul_cuda.launches == before, "zero-size operands must not launch")

    # every shape the main path hands the kernel: batch x (M x K) . (K x N)
    at_shapes = []
    for i, ((B, M, K, N), q, who) in enumerate(shapes):
        a = rand_residues((B, M, K), q, dev, seed=11 + 2 * i)
        b = rand_residues((B, K, N), q, dev, seed=12 + 2 * i)
        got = gf_matmul_batched(a, b, q=q)
        want = gf_matmul_plain(a, b, q)
        err = max_abs_err(got, want)
        check(same(got, want), f"gf_matmul_batched != plain at the main-path shape {(B, M, K, N)}, q={q}")
        del got, want
        at_shapes.append({
            "shape": f"batch {B} x ({M}x{K}).({K}x{N})", "q": q, "from": who, "max_abs_err": err,
            "ms": cuda_ms(lambda: gf_matmul_cuda(a, b, q), KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: gf_matmul_plain(a, b, q), max(3, KERNEL_REPS // 4), warmup=1),
            **bound(4 * (a.numel() + b.numel() + B * M * N), 2 * B * M * K * N),
        })
        del a, b
    return kernel_row("gf_matmul", cases, worst, at_shapes)


def check_butterfly_mac(dev, shapes: list) -> dict:
    worst = 0
    cases = 0
    grid = [(2, 8, 16), (2, 256, 512), (3, 9, 100), (4, 64, 1000), (1, 5, 64),
            (2, 1, 1), (2, 7, 100), (3, 8, 128), (2, 9, 513)]
    for q in (M31, NTT):
        for radix, B, Pn in grid:
            parts = rand_residues((radix, B, Pn), q, dev, seed=B + Pn)
            tw_np = np.random.default_rng(radix * 1000 + B + Pn).integers(
                0, q, size=(B, radix), dtype=np.uint32
            )
            tw_np[0, 0] = q - 1  # a dual near 2^32
            tw, tw_sh = to_tensor(tw_np, dev), to_tensor(shoup_precompute(tw_np, q), dev)
            got = butterfly_mac(parts, tw, tw_sh, q=q)
            want = butterfly_mac_plain(parts, tw, tw_sh, q)
            worst = max(worst, max_abs_err(got, want))
            check(same(got, want), f"butterfly_mac != plain at {(radix, B, Pn)}, q={q}")
            f = Field(q)
            host = np.zeros((B, Pn), dtype=np.uint64)
            pn = to_numpy(parts)
            for r in range(radix):
                host = f.add(host, f.mul(pn[r], tw_np[:, r : r + 1]))
            check(np.array_equal(to_numpy(got), host.astype(np.uint32)),
                  f"butterfly_mac != host oracle at {(radix, B, Pn)}, q={q}")
            cases += 1
        # all q-1, and payload dims
        parts = torch.full((2, 16, 3, 5, 7), q - 1, dtype=torch.int32, device=dev)
        tw_np = np.full((16, 2), q - 1, dtype=np.uint32)
        tw, tw_sh = to_tensor(tw_np, dev), to_tensor(shoup_precompute(tw_np, q), dev)
        got = butterfly_mac(parts, tw, tw_sh, q=q)
        check(got.shape == (16, 3, 5, 7), "butterfly_mac payload dims")
        want = butterfly_mac_plain(parts.reshape(2, 16, -1), tw, tw_sh, q).reshape(16, 3, 5, 7)
        check(same(got, want), f"butterfly_mac != plain on all q-1, q={q}")
        cases += 1
    before = butterfly_mac_cuda.launches
    z = butterfly_mac(
        torch.zeros((2, 4, 0), dtype=torch.int32, device=dev),
        torch.zeros((4, 2), dtype=torch.int32, device=dev),
        torch.zeros((4, 2), dtype=torch.int32, device=dev),
        q=M31,
    )
    check(z.shape == (4, 0) and butterfly_mac_cuda.launches == before, "zero-size guard of butterfly_mac")

    # every shape the main path hands the kernel: one round over B processors
    at_shapes = []
    for i, ((radix, B, Pn), q, who) in enumerate(shapes):
        parts = rand_residues((radix, B, Pn), q, dev, seed=21 + 2 * i)
        tw_np = np.random.default_rng(22 + 2 * i).integers(0, q, size=(B, radix), dtype=np.uint32)
        tw, tw_sh = to_tensor(tw_np, dev), to_tensor(shoup_precompute(tw_np, q), dev)
        got = butterfly_mac(parts, tw, tw_sh, q=q)
        want = butterfly_mac_plain(parts, tw, tw_sh, q)
        err = max_abs_err(got, want)
        check(same(got, want), f"butterfly_mac != plain at the main-path shape {(radix, B, Pn)}, q={q}")
        del got, want
        at_shapes.append({
            "shape": f"({radix}, {B}, {Pn})", "q": q, "from": who, "max_abs_err": err,
            "ms": cuda_ms(lambda: butterfly_mac_cuda(parts, tw, tw_sh, q), KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: butterfly_mac_plain(parts, tw, tw_sh, q),
                                max(3, KERNEL_REPS // 4), warmup=1),
            **bound(4 * (parts.numel() + 2 * tw.numel() + B * Pn), 2 * radix * B * Pn),
        })
        del parts
    return kernel_row("butterfly_mac", cases, worst, at_shapes)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def plain_matrix_encode(x: torch.Tensor, G: np.ndarray, q: int) -> torch.Tensor:
    """out[k'] = Σ_k x[k]·G[k, k'] mod q in plain int64 torch on x's device,
    over the whole payload (chunked inside ``gf_matmul_plain``)."""
    K = x.shape[0]
    gt = to_tensor(np.ascontiguousarray(np.asarray(G).T).astype(np.uint32), x.device)
    return gf_matmul_plain(gt[None], x.reshape(1, K, -1), q)[0].reshape(x.shape)


def drive_encode(cfg: dict, dev, P: int):
    """One configuration through both entry points, counted and checked.
    Returns (record, timers) where timers re-run the two encodes for timing."""
    name, kind, K, q, seed = cfg["name"], cfg["kind"], cfg["K"], cfg["q"], cfg["seed"]
    plan, ir, target, budget, A = cfg["plan"], cfg["ir"], cfg["target"], cfg["budget"], cfg["A"]
    x = rand_residues((K, P), q, dev, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    run_a2a = lambda: a2a_encode(x, A, plan=plan, q=q)[0]  # noqa: E731
    fn = ir_encode(ir, q=q, kernels="cuda")

    g0, b0 = gf_matmul_cuda.launches, butterfly_mac_cuda.launches
    out_a2a = run_a2a()
    torch.cuda.synchronize()
    g1, b1 = gf_matmul_cuda.launches, butterfly_mac_cuda.launches
    out_ir = fn(x)
    torch.cuda.synchronize()
    g2, b2 = gf_matmul_cuda.launches, butterfly_mac_cuda.launches
    peak = torch.cuda.max_memory_allocated()

    a2a_expect = count_calls(a2a_kernel_calls(cfg, P))
    check((g1 - g0, b1 - b0) == a2a_expect,
          f"{name}: a2a_encode launched (gf, bf)={(g1 - g0, b1 - b0)}, expected {a2a_expect}")
    ir_expect = count_calls(ir_kernel_calls(ir, P))
    check((g2 - g1, b2 - b1) == ir_expect,
          f"{name}: ir_encode launched (gf, bf)={(g2 - g1, b2 - b1)}, expected {ir_expect}")
    check(fn.permutes_run == fn.permute_count == ir_permute_count(ir),
          f"{name}: executor ran {fn.permutes_run} permutations, IR has {ir_permute_count(ir)}")
    check(fn.permutes_run <= budget, f"{name}: {fn.permutes_run} permutations over budget {budget}")
    if kind == "general":
        check(fn.permutes_run == budget, f"{name}: {fn.permutes_run} permutations, expected {budget}")

    check(out_a2a.shape == (K, P) and out_a2a.dtype == torch.int32, f"{name}: a2a_encode output shape/dtype")
    check(same(out_a2a, out_ir), f"{name}: a2a_encode and ir_encode(kernels='cuda') differ")
    check(bool(((out_a2a >= 0) & (out_a2a < q)).all()), f"{name}: output not canonical")
    want = plain_matrix_encode(x, target, q)
    check(same(out_a2a, want), f"{name}: encode != plain x @ G mod q on the card")
    del want
    cols = np.sort(np.random.default_rng(seed + 2).choice(P, size=min(SAMPLE_COLS, P), replace=False))
    cols_t = torch.as_tensor(cols, device=dev)
    host = encode_oracle(to_numpy(x.index_select(1, cols_t)), target, q).astype(np.uint32)
    check(np.array_equal(to_numpy(out_a2a.index_select(1, cols_t)), host),
          f"{name}: encode != host oracle on {len(cols)} sampled columns")
    if kind == "dft":
        check(same(decode_dft(out_a2a, plan), x), f"{name}: decode_dft(encode_dft(x)) != x")
    elif kind == "vandermonde":
        check(same(decode_draw_loose(out_a2a, plan), x), f"{name}: decode_draw_loose(encode) != x")
    del out_a2a, out_ir
    record = {
        "K": K, "p": 1, "q": q, "payload_elems": P, "algorithm": ir.algorithm,
        "c1": plan.c1, "c2": plan.c2,
        "launches_a2a": {"gf_matmul": g1 - g0, "butterfly_mac": b1 - b0},
        "launches_ir": {"gf_matmul": g2 - g1, "butterfly_mac": b2 - b1},
        "permutes": fn.permutes_run, "permute_budget": budget,
        "peak_bytes": peak, "checked_columns": {"plain_on_card": P, "host_oracle": len(cols)},
    }
    return record, (run_a2a, lambda: fn(x))


def profile_encode(name: str, fn, reps: int, top: int = 6) -> dict:
    """``reps`` encodes under ``torch.profiler``: wall and device-busy ms an
    encode, the idle share, and the busiest device kernels by name. The
    encodes run on one stream, so the device cannot be busy for longer than
    the wall time: a larger sum means rows were counted twice, and fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # an operator's row repeats the time of the kernels it launched
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3 / reps, ev.count / reps))
    check(bool(rows), f"{name}: the profiler saw no device kernel")
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    check(busy <= wall, f"{name}: device busy {busy:.3f} ms exceeds the wall time {wall:.3f} ms")
    return {
        "wall_ms": wall,
        "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall,
        "device_kernels": [{"name": n[:80], "ms": ms, "calls": c} for n, ms, c in rows[:top]],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this run needs one CUDA device",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    P = PAYLOAD
    smi = nvidia_smi_line()
    say("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        total_memory=torch.cuda.get_device_properties(0).total_memory)

    _build.build_all()
    nvcc_version = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                                  timeout=60).stdout.strip().splitlines()[-2:]
    say("build", seconds=_build.build_report["seconds"], nvcc=nvcc_version,
        sources={k: {"compiled": v["compiled"], "library": os.path.relpath(v["library"], ROOT),
                     "ptxas": [ln for ln in v["log"].splitlines() if "registers" in ln or "spill" in ln]}
                 for k, v in _build.build_report["sources"].items()})

    # phase 3: kernels against their plain versions, at every shape phase 4 gives them
    configs = make_configs()
    shapes = path_shapes(configs, P)
    rows = [
        check_gf_matmul(dev, shapes["gf_matmul"]),
        check_butterfly_mac(dev, shapes["butterfly_mac"]),
    ]
    say("kernels", card=smi, kernels=rows)
    torch.cuda.empty_cache()

    # phase 4: the main path, with every count set to 0 just before it
    gf_matmul_cuda.launches = 0
    butterfly_mac_cuda.launches = 0
    records, timers = {}, {}
    for cfg in configs:
        records[cfg["name"]], timers[cfg["name"]] = drive_encode(cfg, dev, P)
        torch.cuda.empty_cache()
    main_path_launches = {
        "gf_matmul": gf_matmul_cuda.launches,
        "butterfly_mac": butterfly_mac_cuda.launches,
    }
    for k, n in main_path_launches.items():
        check(n > 0, f"the main path never launched {k}")

    # times of the encodes (these repeats are not part of the counted run)
    for cfg in configs:
        name = cfg["name"]
        record = records[name]
        entries = dict(zip(("a2a_encode", "ir_encode"), timers[name]))
        for entry, run in entries.items():
            run()
            record[f"{entry}_ms"] = wall_ms(run, ENCODE_REPS)
        record["profile"] = {
            entry: profile_encode(f"{name}/{entry}", run, ENCODE_REPS) for entry, run in entries.items()
        }
        say(name, card=smi, **record)
        del entries
        timers[name] = None
        torch.cuda.empty_cache()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for row in rows:
        row["launches"] = main_path_launches[row["name"]]
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}), flush=True)
    say("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
