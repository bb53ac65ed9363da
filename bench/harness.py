"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the reference that decides ``correct``.

The loop is closed, with one client: a coded stack ships a call's coded rows
before it makes the next. Every call ends in ``torch.cuda.synchronize()``
and is timed on the device's clock by two CUDA events around it, so that
its time holds the host's work inside the call and not the host clock's
half-millisecond error; traced and untraced runs time it alike. The calls
alternate between the payloads made from the seed in set-up; a mix with
``call_columns`` gives each call that many columns of a payload, the next
ones each time. A call that raises counts as failed. Between calls the
harness keeps, for the comparison, the coded columns of a sample of the
calls (which calls and which columns drawn from the seed; the mix sets the
share) and, for each payload, the whole output of one call drawn from the
seed (reservoir sampling), copied into a buffer made in set-up.

After the window the program's objects are freed and the reference, plain
PyTorch on the same device, works out every payload's coded rows from what
the benchmark made: the comparison is exact, so its limit is 0.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import random
import sys
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import plugins, trace as tracing
from .reference import encode as ref_encode
from .reference import generators

ROOT = plugins.BENCH.parent


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose of a run, from the run's seed."""
    words = [int(seed) % (1 << 64)] + [int(t) if isinstance(t, int) else zlib.crc32(t.encode()) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration and mix."""

    name: str
    spec: dict
    config: dict
    traffic: dict
    bench: dict

    def metrics(self, kind: str) -> list[dict]:
        """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) this
        cell reports."""
        return [m for m in self.bench[kind] if "workloads" not in m or self.name in m["workloads"]]


def load_cell(workload: str, *, root: Path = ROOT, bench_dir: Path | None = None,
              overrides: dict | None = None) -> Cell:
    bench_dir = plugins.BENCH if bench_dir is None else Path(bench_dir)
    with open(Path(root) / "BENCHMARK.json") as f:
        bench = json.load(f)
    specs = [w for w in bench["workloads"] if w["name"] == workload]
    if len(specs) != 1:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    spec = specs[0]
    (centry,) = [c for c in bench["configs"] if c["name"] == spec["config"]]
    with open(Path(root) / centry["file"]) as f:
        config = json.load(f)
    traffic = plugins.read_json(bench_dir, "traffic", spec["traffic"])
    over = overrides or {}
    return Cell(workload, spec, merged(config, over.get("config")), merged(traffic, over.get("traffic")), bench)


@dataclass
class Run:
    """What the readers of ``metrics/`` read."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    call_s: list = field(default_factory=list)  # device-clock seconds of each completed call
    peak_added: int | None = None  # the window's allocator peak less what was allocated as it began
    attempted: int = 0
    failed: int = 0
    width: int = 0  # the columns of a row that a call encodes (S, or the mix's call_columns)
    kind: str = "cpu"  # the device's name, as torch.cuda.get_device_name gives it
    counters: dict = field(default_factory=dict)  # what a reader stored before the window
    kernels: list = field(default_factory=list)  # the hand kernels, one spec a file of kernels/
    trace: tracing.Trace | None = None

    @property
    def code(self) -> dict:
        return self.cell.config["code"]

    @property
    def completed(self) -> int:
        return len(self.call_s)

    def least_bytes(self) -> int:
        """The bytes a call's work needs at the least: K source rows read
        and N coded rows written once, 4 B an element."""
        return (self.code["K"] + self.code["N"]) * self.width * 4


def peak_bytes_per_s(kind: str) -> float | None:
    with open(plugins.BENCH / "peaks.json") as f:
        peaks = json.load(f)
    return peaks.get(kind, {}).get("hbm_bytes_per_s")


class Clock:
    """Seconds of one call on the device's clock (two CUDA events, made once
    and recorded around each call, the call ended by
    ``torch.cuda.synchronize()``), or on the host's where there is no card
    (the CPU tests)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def start(self):
        if self.cuda:
            self.events[0].record()
            return None
        return time.perf_counter()

    def stop(self, t0) -> float:
        if self.cuda:
            self.events[1].record()
            torch.cuda.synchronize()
            return self.events[0].elapsed_time(self.events[1]) / 1e3
        return time.perf_counter() - t0


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str | None = None, root: Path = ROOT, bench_dir: Path | None = None,
             overrides: dict | None = None, entry=None, log=None) -> dict:
    """One run; returns the result line's object (``checks`` last).

    ``entry`` (tests and the control) replaces the program's entry: a
    function ``(config, device) -> (to_program, call)``. ``overrides``
    (tests) is merged into the configuration and the mix."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cell = load_cell(workload, root=root, bench_dir=bench_dir, overrides=overrides)
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    bench_dir = plugins.BENCH if bench_dir is None else Path(bench_dir)
    config, traffic = cell.config, cell.traffic
    code = config["code"]
    payload = plugins.load_module(bench_dir, "payloads", config["payload"]["kind"])
    S = payload.width(config)
    w = int(traffic.get("call_columns", S))
    if not 0 < w <= S or S % w:
        raise ValueError(f"a call's {w} columns do not divide a payload's {S}")
    run = Run(cell, width=w, kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
              kernels=plugins.hand_kernels(bench_dir))

    # ---- set-up: payloads from the seed, the entry, a warm-up of every shape
    marks = [("start", time.perf_counter())]
    raws, inputs = [], []
    for i in range(int(traffic["payloads"])):
        g = torch.Generator(device=dev)
        g.manual_seed(sub_seed(seed, "payload", i))
        raw = payload.make(config, dev, g)
        raws.append(raw)
    marks.append(("payloads", time.perf_counter()))
    if entry is None:
        to_program = payload.to_program
        call = plugins.load_module(bench_dir, "entries", traffic["entry"]).build(
            config, traffic.get("entry_options", {}), dev)
    else:
        to_program, call = entry(config, dev)
    marks.append(("entry", time.perf_counter()))
    # (payload, first column, the call's input) in the order of the calls:
    # the payloads alternate, and each goes on to its next columns
    for p, raw in enumerate(raws):
        x = to_program(raw, config, dev)
        for k, lo in enumerate(range(0, S, w)):
            inputs.append((k, p, lo, x if w == S else x[:, lo:lo + w].contiguous()))
        del x
    inputs = [(p, lo, x) for _, p, lo, x in sorted(inputs, key=lambda t: t[:2])]
    marks.append(("program inputs", time.perf_counter()))
    warm = None
    for i in range(int(traffic["warmup_calls"])):
        warm = call(inputs[i % len(inputs)][2])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b) in zip(marks, marks[1:]))
        + f"; {marks[0][1] - t_start:.2f} s before (imports, the card)")
    metric_mods = {m["name"]: plugins.load_module(bench_dir, "metrics", m["name"])
                   for m in cell.metrics("per_layer" if trace else "end_to_end")}
    for mod in metric_mods.values():
        if hasattr(mod, "before_window"):
            mod.before_window(run)

    # ---- what the comparison reads, drawn from the seed: for a share of the
    # calls a sample of their columns, copied to the host, and for each payload
    # the whole output of one call (reservoir sampling), copied into a buffer
    # made here so that keeping it adds nothing to the window's peak
    rng = random.Random(sub_seed(seed, "check"))
    share = float(traffic["sampled_share"])
    n_cols = min(int(traffic["sample_columns"]), run.width)
    pool_g = torch.Generator(device=dev)
    pool_g.manual_seed(sub_seed(seed, "columns"))
    pool = torch.randint(0, run.width, (64, n_cols), generator=pool_g, device=dev)
    pool[:, 0], pool[:, -1] = 0, run.width - 1
    pool_rows = list(pool)
    samples = []  # (payload, first column, pool row, (N, n_cols) coded columns on the host) of the sampled calls
    # the sampled columns are gathered into a ring on the device, made here, and
    # copied to the host a ring at a time: no allocation and no wait a call
    ring = torch.empty((256, code["N"], n_cols), dtype=torch.int32, device=dev)
    in_ring: list = []  # (payload, first column, pool row) of each filled slot

    def flush():
        if in_ring:
            host = ring[:len(in_ring)].cpu()
            samples.extend((p, lo, r, host[k]) for k, (p, lo, r) in enumerate(in_ring))
            in_ring.clear()

    if isinstance(warm, torch.Tensor) and warm.numel() == code["N"] * run.width and warm.dtype == torch.int32:
        warm = warm.reshape(code["N"], run.width)  # the harness's own ops once, so none loads in the window
        torch.index_select(warm, 1, pool_rows[0], out=ring[0])
        ring[:1].cpu()
    del warm
    unfit = 0  # calls that returned no (N, columns) int32 tensor on the device
    kept = [torch.empty((code["N"], run.width), dtype=torch.int32, device=dev) for _ in raws]
    kept_from = [None] * len(raws)  # (call, first column) of each kept output
    seen = [0] * len(raws)

    # ---- the window
    clock = Clock(dev)
    memory_peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        memory_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        window_range = torch.profiler.record_function(tracing.WINDOW)
        window_range.__enter__()
    in_call = (lambda: torch.profiler.record_function(tracing.CALL)) if trace else contextlib.nullcontext
    run.setup_s = time.perf_counter() - t_start
    w0 = time.perf_counter()
    deadline = w0 + seconds
    i = 0
    while i == 0 or time.perf_counter() < deadline:
        p, lo, _ = inputs[i % len(inputs)]
        run.attempted += 1
        try:
            with in_call():
                t0 = clock.start()
                y = call(inputs[i % len(inputs)][2])
                sec = clock.stop(t0)
        except Exception as e:  # a call that raises is a failed call; the window goes on
            run.failed += 1
            log(f"call {i} raised {type(e).__name__}: {e}")
            i += 1
            continue
        run.call_s.append(sec)
        if isinstance(y, torch.Tensor) and y.ndim >= 1 and y.dtype == torch.int32 and y.device == dev \
                and y.numel() == code["N"] * run.width and y.shape[0] == code["N"]:
            y = y.reshape(code["N"], run.width)
            if rng.random() < share:
                r = i % len(pool_rows)
                torch.index_select(y, 1, pool_rows[r], out=ring[len(in_ring)])
                in_ring.append((p, lo, r))
                if len(in_ring) == ring.shape[0]:
                    flush()
            seen[p] += 1
            if rng.random() * seen[p] < 1.0:
                kept[p].copy_(y)
                kept_from[p] = (i, lo)
        else:
            unfit += 1
        del y
        i += 1
    flush()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.window_s = time.perf_counter() - w0
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        run.peak_added = peak - held
        memory_peak = max(memory_peak, peak)
    if run.call_s:
        c = sorted(run.call_s)
        log(f"window: {len(c)} calls in {run.window_s:.3f} s, {sum(c) / run.window_s:.1%} of it inside calls; "
            f"call ms: mean {1e3 * sum(c) / len(c):.3f}, p50 {1e3 * c[len(c) // 2]:.3f}, "
            f"p95 {1e3 * p95(c):.3f}, max {1e3 * c[-1]:.3f}")
    if prof is not None:
        window_range.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        t_read = time.perf_counter()
        run.trace = tracing.summarize(tracing.records(prof), hand=plugins.hand_kernel_names(run.kernels))
        log(f"trace: {run.trace.calls} calls, {len(run.trace.ops)} device ops, read in "
            f"{time.perf_counter() - t_read:.1f} s")

    # ---- the metrics, read before anything else runs on the device
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = metric_mods[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": run.kind,
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s

    # ---- the comparison, once the program's objects are freed
    del call, inputs, to_program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = compare(cell, payload, raws, samples, kept, kept_from, pool, unfit, run)
    log(f"comparison with the reference: {time.perf_counter() - t_check:.1f} s")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.top_gaps()}
    result["checks"] = checks
    return result


def compare(cell: Cell, payload, raws, samples, kept, kept_from, pool, unfit: int, run: Run) -> dict:
    """Each number compared, with its limit."""
    config = cell.config
    code = config["code"]
    A = generators.matrix(code)
    mismatched = 0
    whole = 0
    w = run.width
    for p, raw in enumerate(raws):
        rows = payload.to_reference(raw, config)
        S = payload.width(config)
        if tuple(rows.shape) != (code["K"], S):
            raise RuntimeError(f"the reference's rows are {tuple(rows.shape)}, not {(code['K'], S)}")
        expect = ref_encode.encode(rows, A, code["q"])
        del rows
        if kept_from[p] is not None:
            lo = kept_from[p][1]
            mismatched += int((kept[p] != expect[:, lo:lo + w]).sum())
            whole += 1
        kept[p] = None
        cols: dict = {}  # (first column, pool row) -> the reference's columns on the host
        for q_, lo, r, got in samples:
            if q_ == p:
                if (lo, r) not in cols:
                    cols[lo, r] = expect.index_select(1, pool[r] + lo).cpu()
                mismatched += int((got != cols[lo, r]).sum())
        del expect, cols
    return {
        "mismatched_elements": {"value": mismatched, "limit": 0},
        "calls_failed": {"value": run.failed, "limit": 0},
        "calls_unfit": {"value": unfit, "limit": 0},
        "payloads_not_compared_whole": {"value": len(raws) - whole, "limit": 0},
    }


def p95(values) -> float:
    """The 95th percentile by nearest rank: a value that was measured."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]
