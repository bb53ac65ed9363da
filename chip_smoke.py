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
                the expected numbers. Then the topology-aligned encodes at K=64
                and 2^20 elements, each through its own entry point:
                ``hierarchical`` (``hierarchical_encode(A, k_intra=8)``, M31),
                ``multilevel`` (``multilevel_encode(A, (4, 4, 4))``, M31),
                ``pipelined`` (``ps_encode(A, pipeline="pipeline")``, M31, the
                universal A) and ``two_level_dft`` (``ir_encode`` of
                ``plan_two_level_dft(64, 1, NTT, 8)``), with the same checks
                and the permutation count equal to the budget function. Then
                each encode's median wall time and, under ``torch.profiler``,
                its device-busy time, idle share, time by kind of kernel and
                busiest device kernels by name; ``pipelined`` is also timed
                beside the same IR with its overlap LocalOps run in order.
5. ``traced``   ``multilevel`` through ``ir_encode(tracer=Tracer(),
                topo=Hierarchy(levels=(4, 4, 4)))`` twice: bit-equal to the
                untraced encode, one root span and one span a round (levels
                0,0,1,1,2,2), permutations and registry counters as budgeted;
                then the calibration feed into a temporary file, its fitted
                α/β and drift rows (one card's gathers in HBM, not links).
6. a line ``{"kernels": [...]}`` with every kernel's launches on the main
   path, error, time, bound and plain time; the card's name and power limit;
   and last ``{"ok": true, "device": {...}}``.

The widths, repeat counts and seed are the constants below: the script takes
no arguments. Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
from repro_torch.dist.collectives import (  # noqa: E402
    expected_hier_permute_count,
    expected_multilevel_permute_count,
    expected_permute_count,
    hierarchical_encode,
    ir_encode,
    multilevel_encode,
    ps_encode,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.butterfly.kernel import butterfly_mac_cuda, butterfly_mac_plain  # noqa: E402
from repro_torch.kernels.butterfly.ops import butterfly_mac  # noqa: E402
from repro_torch.kernels.gf_matmul.kernel import gf_matmul_cuda, gf_matmul_plain  # noqa: E402
from repro_torch.kernels.gf_matmul.ops import gf_matmul, gf_matmul_batched  # noqa: E402
from repro_torch.obs import Tracer, drift_rows, feed_calibration, get_registry  # noqa: E402
from repro_torch.topo import (  # noqa: E402
    FullyConnected,
    Hierarchy,
    plan_hierarchical,
    plan_multilevel,
    plan_two_level_dft,
    two_level_dft_matrix,
)
from repro_torch.topo.passes import PIPELINES  # noqa: E402

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
    """Plans, IRs and target matrices of the full-width encodes (host-side
    work only). The first three run through ``a2a_encode`` and
    ``ir_encode``; each topology-aligned one runs through its own entry point
    (``entry``), built on the card by ``make`` and run on the IR ``ir``."""
    configs = []
    for name, kind, K, q, seed in (
        ("universal", "general", 64, M31, SEED + 100),
        ("dft", "dft", 64, NTT, SEED + 200),
        ("draw_loose", "vandermonde", 48, NTT, SEED + 300),
    ):
        f = Field(q)
        cfg = {"name": name, "kind": kind, "K": K, "q": q, "seed": seed, "A": None,
               "entries": ("a2a_encode", "ir_encode")}
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

    K, f = 64, Field(M31)
    A_univ = np.asarray(configs[0]["A"])
    A_hier = np.asarray(random_matrix(f, K, seed=SEED + 401))
    A_multi = np.asarray(random_matrix(f, K, seed=SEED + 501))
    hp = plan_hierarchical(K, 1, 8)
    mp = plan_multilevel(K, 1, (4, 4, 4))  # levels innermost first: sizes (4, 4, 4) reversed
    pp = plan_for("general", K, 1, M31)
    # the rewrite the dispatch applies: priced on the flat fabric at 2^16 elements
    pipelined_ir = PIPELINES["pipeline"].apply(pp.to_ir(A_univ, q=M31), FullyConnected(K), 1 << 16)
    tp = plan_two_level_dft(K, 1, NTT, 8)
    tp_ir = tp.to_ir()
    for name, q, seed, plan, ir, target, budget, entry, make in (
        ("hierarchical", M31, SEED + 400, hp, hp.to_ir(A_hier, q=M31), A_hier,
         expected_hier_permute_count(hp), "hierarchical_encode",
         lambda: hierarchical_encode(A_hier, k_intra=8)[0]),
        ("multilevel", M31, SEED + 500, mp, mp.to_ir(A_multi, q=M31), A_multi,
         expected_multilevel_permute_count(mp), "multilevel_encode",
         lambda: multilevel_encode(A_multi, (4, 4, 4))[0]),
        ("pipelined", M31, SEED + 100, pp, pipelined_ir, A_univ,
         expected_permute_count(pp), "ps_encode",
         lambda: ps_encode(A_univ, pipeline="pipeline")[0]),
        ("two_level_dft", NTT, SEED + 600, tp, tp_ir, two_level_dft_matrix(tp),
         ir_permute_count(tp_ir), "ir_encode",
         lambda: ir_encode(tp_ir, q=NTT)),
    ):
        configs.append({"name": name, "kind": "topology", "K": K, "q": q, "seed": seed, "A": None,
                        "plan": plan, "ir": ir, "target": np.asarray(target), "budget": budget,
                        "entries": (entry,), "make": make})
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
        if cfg["kind"] == "topology":
            runs = ((cfg["entries"][0], ir_kernel_calls(cfg["ir"], P)),)
        else:
            runs = (("a2a_encode", a2a_kernel_calls(cfg, P)), ("ir_encode", ir_kernel_calls(cfg["ir"], P)))
        for entry, calls in runs:
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

    check(same(out_a2a, out_ir), f"{name}: a2a_encode and ir_encode(kernels='cuda') differ")
    n_cols = check_output(name, out_a2a, x, target, q, seed)
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
        "peak_bytes": peak, "checked_columns": {"plain_on_card": P, "host_oracle": n_cols},
    }
    return record, (run_a2a, lambda: fn(x))


def check_output(name: str, out: torch.Tensor, x: torch.Tensor, target: np.ndarray, q: int, seed: int) -> int:
    """``out`` is canonical, equals a plain ``x @ target mod q`` on the card
    over the whole payload and the host oracle on sampled columns; returns
    the number of sampled columns."""
    K, P = x.shape
    check(out.shape == (K, P) and out.dtype == torch.int32, f"{name}: output shape/dtype")
    check(bool(((out >= 0) & (out < q)).all()), f"{name}: output not canonical")
    want = plain_matrix_encode(x, target, q)
    check(same(out, want), f"{name}: encode != plain x @ G mod q on the card")
    del want
    cols = np.sort(np.random.default_rng(seed + 2).choice(P, size=min(SAMPLE_COLS, P), replace=False))
    cols_t = torch.as_tensor(cols, device=x.device)
    host = encode_oracle(to_numpy(x.index_select(1, cols_t)), target, q).astype(np.uint32)
    check(np.array_equal(to_numpy(out.index_select(1, cols_t)), host),
          f"{name}: encode != host oracle on {len(cols)} sampled columns")
    return len(cols)


def drive_entry(cfg: dict, dev, P: int):
    """One topology-aligned configuration through its own entry point,
    counted and checked. Returns (record, executor, input)."""
    name, K, q, seed = cfg["name"], cfg["K"], cfg["q"], cfg["seed"]
    x = rand_residues((K, P), q, dev, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    fn = cfg["make"]()
    check(fn.device.type == "cuda" and fn.kernels == "cuda", f"{name}: the entry point did not run on the card")
    calls = ir_kernel_calls(fn.ir, P)
    check(calls == ir_kernel_calls(cfg["ir"], P),
          f"{name}: the entry point runs other kernel shapes than phase 3 held")
    g0, b0 = gf_matmul_cuda.launches, butterfly_mac_cuda.launches
    out = fn(x)
    torch.cuda.synchronize()
    g1, b1 = gf_matmul_cuda.launches, butterfly_mac_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    expect = count_calls(calls)
    check((g1 - g0, b1 - b0) == expect,
          f"{name}: {cfg['entries'][0]} launched (gf, bf)={(g1 - g0, b1 - b0)}, expected {expect}")
    check(fn.permutes_run == fn.permute_count == ir_permute_count(fn.ir) == cfg["budget"],
          f"{name}: executor ran {fn.permutes_run} permutations, the budget is {cfg['budget']}")
    n_cols = check_output(name, out, x, cfg["target"], q, seed)
    del out
    overlap = sum(1 for s in fn.ir.steps if isinstance(s, LocalOp) and s.overlap)
    record = {
        "K": K, "p": 1, "q": q, "payload_elems": P, "entry": cfg["entries"][0], "algorithm": fn.ir.algorithm,
        "c1": cfg["plan"].c1, "c2": cfg["plan"].c2, "overlap_local_ops": overlap,
        "kernel_calls": [f"{k} {s}" for k, s in calls],
        "launches": {"gf_matmul": g1 - g0, "butterfly_mac": b1 - b0},
        "receive_coefficient_transfers": sum(
            1 for r in fn.ir.rounds() for tr in r.transfers if tr.coeffs is not None),
        "permutes": fn.permutes_run, "permute_budget": cfg["budget"],
        "peak_bytes": peak, "checked_columns": {"plain_on_card": P, "host_oracle": n_cols},
    }
    return record, fn, x


def in_order(ir):
    """The same IR with every LocalOp's overlap flag cleared: the executor
    then runs each contraction on the main stream, in order."""
    steps = tuple(dataclasses.replace(s, overlap=False) if isinstance(s, LocalOp) else s for s in ir.steps)
    return dataclasses.replace(ir, steps=steps)


def kernel_kind(key: str) -> str:
    """The kind of a device kernel, by the name the profiler gives it."""
    k = key.lower()
    if "gf_matmul" in k or "butterfly_mac" in k:
        return "hand_kernels"
    if "index" in k or "gather" in k:
        return "gathers"
    if "cat" in k or "copy" in k or "memcpy" in k or "memset" in k:
        return "copies"
    return "elementwise"


def profile_encode(name: str, fn, reps: int, top: int = 6) -> dict:
    """``reps`` encodes under ``torch.profiler``: wall and device-busy ms an
    encode, the idle share, device time by kind of kernel, and the busiest
    device kernels by name. Busy time is the union of the device intervals,
    so kernels that ran at once on two streams count once; it can exceed
    neither the kernels' sum nor the wall time, and the run fails if it
    does (rows counted twice)."""
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
    kernel_sum = sum(r[1] for r in rows)
    # busy time is the union of the device intervals: kernels on two streams
    # (an overlap LocalOp) may run at once, and then the sum exceeds it
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start)
    check(bool(spans), f"{name}: the profiler gave no device intervals")
    union_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            union_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    union_us += cur_e - cur_s
    busy = union_us / 1e3 / reps
    check(busy <= kernel_sum * 1.001, f"{name}: busy {busy:.3f} ms exceeds the kernels' sum {kernel_sum:.3f} ms")
    check(busy <= wall, f"{name}: device busy {busy:.3f} ms exceeds the wall time {wall:.3f} ms")
    by_kind: dict = {}
    for key, ms, _ in rows:
        by_kind[kernel_kind(key)] = by_kind.get(kernel_kind(key), 0.0) + ms
    return {
        "wall_ms": wall,
        "device_busy_ms": busy,
        "device_kernel_sum_ms": kernel_sum,
        "idle_share": 1.0 - busy / wall,
        "ms_by_kind": by_kind,
        "device_kernels": [{"name": n[:80], "ms": ms, "calls": c} for n, ms, c in rows[:top]],
    }


def traced_phase(cfg: dict, dev, P: int) -> dict:
    """``cfg`` (the multilevel configuration) through the traced executor
    twice, on its own hierarchy: outputs bit-equal to the untraced encode, one
    root span and one span a CommRound each call, permutations and registry
    counters as budgeted, then the calibration feed into a temporary file."""
    name, K, q, seed = cfg["name"], cfg["K"], cfg["q"], cfg["seed"]
    x = rand_residues((K, P), q, dev, seed=seed)
    plain = cfg["make"]()
    want = plain(x)
    ir, budget = plain.ir, cfg["budget"]
    topo = Hierarchy(levels=cfg["plan"].levels)
    reg = get_registry()
    reg.reset()
    tracer = Tracer()
    fn = ir_encode(ir, q=q, tracer=tracer, topo=topo)
    calls = 2
    g0, b0 = gf_matmul_cuda.launches, butterfly_mac_cuda.launches
    for i in range(calls):
        out = fn(x)
        check(same(out, want), f"traced: call {i} != the untraced encode")
        check(fn.permutes_run == budget, f"traced: {fn.permutes_run} permutations, the budget is {budget}")
    g1, b1 = gf_matmul_cuda.launches, butterfly_mac_cuda.launches
    expect = count_calls(ir_kernel_calls(ir, P))
    check((g1 - g0, b1 - b0) == (calls * expect[0], calls * expect[1]),
          f"traced: launched (gf, bf)={(g1 - g0, b1 - b0)}, expected {calls} x {expect}")
    del out
    roots = [s for s in tracer.spans if s.name == "ir_encode"]
    comm = [s for s in tracer.spans if "comm_round" in s.attrs]
    check(len(roots) == calls and all(s.parent is None for s in roots), "traced: one root span a call")
    check(len(comm) == calls * ir.c1 == calls * 6, f"traced: {len(comm)} round spans for {calls} x c1={ir.c1}")
    levels = [s.attrs["level"] for s in comm]
    check(levels == [0, 0, 1, 1, 2, 2] * calls, f"traced: round levels {levels}")
    check(all(s.dur_us > 0 for s in comm), "traced: a round span took no time")
    for i in range(calls):
        mine = comm[i * ir.c1:(i + 1) * ir.c1]
        check(all(tracer.spans[s.parent] is roots[i] for s in mine), "traced: round spans nest in their call")
        check(sum(s.attrs["ppermutes"] for s in mine) == budget, "traced: permutations of the spans != budget")
    snap = reg.snapshot()
    check(snap["encode.rounds"]["value"] == calls * ir.c1, f"traced: encode.rounds {snap['encode.rounds']}")
    check(snap["encode.ppermutes"]["value"] == calls * budget, f"traced: encode.ppermutes {snap['encode.ppermutes']}")
    wire = sum(s.attrs["wire_slots"] for s in comm) * P * 4
    check(snap["encode.bytes_on_wire"]["value"] == wire > 0, "traced: encode.bytes_on_wire")
    check(snap["encode.round_us{level=0}"]["count"] == levels.count(0), "traced: encode.round_us{level=0}")
    with tempfile.TemporaryDirectory() as d:
        fitted = feed_calibration(tracer.spans, os.path.join(d, "calibration.json"), n_levels=3)
    return {
        "K": K, "q": q, "payload_elems": P, "topology": f"Hierarchy(levels={topo.levels})",
        "calls": calls, "traced_call_ms": [s.dur_us / 1e3 for s in roots],
        "untraced_ms": wall_ms(lambda: plain(x), ENCODE_REPS),
        "rounds": [{"round": s.attrs["comm_round"], "level": s.attrs["level"], "msgs": s.attrs["msgs"],
                    "elems": s.attrs["elems"], "wire_slots": s.attrs["wire_slots"],
                    "measured_us": s.dur_us, "predicted_us": s.attrs["predicted_us"]} for s in comm],
        "counters": {k: v["value"] for k, v in snap.items() if v["type"] == "counter"},
        "calibration_label": "fitted from one card's gathers in HBM (K processors as a tensor axis), "
                             "not from links between cards",
        "fitted_level_costs": [{"level": j, "alpha_s": c.alpha, "beta_s_per_elem": c.beta}
                               for j, c in enumerate(fitted)],
        "drift_rows": drift_rows(tracer.spans),
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
        if cfg["kind"] == "topology":
            record, fn, x = drive_entry(cfg, dev, P)
            records[cfg["name"]], timers[cfg["name"]] = record, (lambda fn=fn, x=x: fn(x),)
            if cfg["name"] == "pipelined":
                cfg["pipelined"] = (fn, x)
        else:
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
        entries = dict(zip(cfg["entries"], timers[name]))
        if name == "pipelined":  # the same IR with its overlap LocalOps run in order
            fn, x = cfg.pop("pipelined")
            fn_in_order = ir_encode(in_order(fn.ir), q=cfg["q"], kernels="cuda")
            check(same(fn_in_order(x), fn(x)), "pipelined: the in-order run differs")
            entries["in_order"] = lambda f=fn_in_order, x=x: f(x)
            turns = [(k, wall_ms(entries[k], ENCODE_REPS))
                     for k in ("ps_encode", "in_order", "in_order", "ps_encode")]
            record["overlap_vs_in_order_ms"] = [{"run": k, "ms": ms} for k, ms in turns]
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

    # phase 5: the traced path, counted on its own
    gf_matmul_cuda.launches = 0
    butterfly_mac_cuda.launches = 0
    traced = traced_phase(next(c for c in configs if c["name"] == "multilevel"), dev, P)
    check(gf_matmul_cuda.launches > 0, "the traced path never launched gf_matmul")
    say("traced", card=smi, launches={"gf_matmul": gf_matmul_cuda.launches,
                                      "butterfly_mac": butterfly_mac_cuda.launches}, **traced)
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
