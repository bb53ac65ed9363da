"""What a ``torch.profiler`` trace of the measured window says.

The harness runs the window inside one ``record_function`` range
(:data:`WINDOW`) and each call inside another (:data:`CALL`), so host ranges
and device intervals are read from one clock. From the trace:

* busy time: the union of the device intervals inside the window, so kernels
  that ran at once on two streams count once; it exceeds neither the
  kernels' sum nor the window;
* each device operation with its duration and whether it started inside a
  call (the breakdown names its kind: hand kernels, by the names the files
  of ``kernels/`` give, gathers, copies, element-wise);
* the idle gaps between busy intervals, each named by the innermost host
  range open at its middle, and by whether that lies in a call or between
  calls.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

WINDOW = "bench.window"
CALL = "bench.call"
OWN = (WINDOW, CALL)


def kernel_kind(name: str, hand: tuple[str, ...] = ()) -> str:
    """The kind of a device operation, by the name the profiler gives it;
    ``hand`` holds the substrings that name the hand kernels
    (``plugins.hand_kernel_names``)."""
    k = name.lower()
    if any(h.lower() in k for h in hand):
        return "hand_kernels"
    if "index" in k or "gather" in k:
        return "gathers"
    if "cat" in k or "copy" in k or "memcpy" in k or "memset" in k:
        return "copies"
    return "elementwise"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: int
    #: (name, seconds, started inside a call) of every device operation
    ops: list = field(default_factory=list)
    #: (name of the host range open at its middle, seconds) of every idle gap
    gaps: list = field(default_factory=list)
    #: the substrings that name the hand kernels
    hand: tuple = ()

    def op_seconds(self, *, in_call: bool | None = None, names: tuple[str, ...] | None = None) -> float:
        total = 0.0
        for name, sec, inside in self.ops:
            if in_call is not None and inside != in_call:
                continue
            if names is not None and not any(n in name for n in names):
                continue
            total += sec
        return total

    def top_ops(self, n: int = 10) -> list:
        """The device operations that took most time, each named with its
        kind first (``copies: void at::native::...``)."""
        by: dict = {}
        for name, sec, _ in self.ops:
            key = f"{kernel_kind(name, self.hand)}: {name}"
            by[key] = by.get(key, 0.0) + sec
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> list:
        by: dict = {}
        for name, sec in self.gaps:
            by[name] = by.get(name, 0.0) + sec
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _union(spans: list) -> tuple[float, list]:
    """Total length of the union of ``(start, end)`` spans and the merged
    intervals, in order."""
    merged: list = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def records(prof) -> list:
    """``(name, on the device, start µs, end µs)`` of every host range and
    device operation a finished ``torch.profiler.profile`` holds, read from
    its kineto results (building the profiler's own event tree would take
    minutes for a window of 10^5 kernels)."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        dt = ev.device_type()
        if dt in (DeviceType.CPU, DeviceType.CUDA):
            s = ev.start_ns() / 1e3
            out.append((ev.name(), dt == DeviceType.CUDA, s, s + ev.duration_ns() / 1e3))
    return out


def summarize(recs: list, hand: tuple[str, ...] = ()) -> Trace:
    """A :class:`Trace` from :func:`records`; ``hand`` names the hand
    kernels."""
    cpu = [(name, s, e) for name, dev, s, e in recs if not dev]
    windows = [(s, e) for name, s, e in cpu if name == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the profiler recorded {len(windows)} windows, not one")
    w0, w1 = windows[0]
    calls = sorted((s, e) for name, s, e in cpu if name == CALL)
    call_starts = np.array([s for s, _ in calls], dtype=np.float64)
    call_ends = np.array([e for _, e in calls], dtype=np.float64)

    ops, spans = [], []
    for name, dev, s, e in recs:
        if not dev or name in OWN:
            continue
        if e <= s or e <= w0 or s >= w1:
            continue
        s, e = max(s, w0), min(e, w1)
        i = int(np.searchsorted(call_starts, s, side="right")) - 1
        inside = i >= 0 and s <= call_ends[i]
        ops.append((name, (e - s) / 1e6, bool(inside)))
        spans.append((s, e))
    if not spans:
        raise RuntimeError("the profiler saw no device operation in the window")
    busy_us, merged = _union(spans)
    kernel_sum = sum(sec for _, sec, _ in ops) * 1e6
    if busy_us > kernel_sum * 1.001 or busy_us > (w1 - w0):
        raise RuntimeError(f"device busy {busy_us:.1f} us exceeds the kernels' sum or the window")

    # idle gaps: before the first interval, between intervals, after the last
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    host = sorted((s, e, name) for name, s, e in cpu if name != WINDOW and e > s)
    named = _name_gaps(gaps, host)
    for k, (s, e) in enumerate(gaps):
        mid = 0.5 * (s + e)
        i = int(np.searchsorted(call_starts, mid, side="right")) - 1
        name, sec = named[k]
        if i >= 0 and mid <= call_ends[i]:
            named[k] = ("in a call: " + ("between the program's ops" if name == CALL else name), sec)
        else:
            named[k] = ("between calls: " + name, sec)
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6, calls=len(calls), ops=ops, gaps=named,
                 hand=tuple(hand))


def _name_gaps(gaps: list, host: list) -> list:
    """``(name, seconds)`` of each gap, in the order given: the host range
    open at its middle that began last (the innermost, where ranges nest), by
    a sweep over the ranges in order of start."""
    by_start: list = []  # (-start, end, name) of the ranges begun so far, the latest start first
    h = 0
    out = [None] * len(gaps)
    for g in sorted(range(len(gaps)), key=lambda g: gaps[g][0] + gaps[g][1]):
        s, e = gaps[g]
        mid = 0.5 * (s + e)
        while h < len(host) and host[h][0] <= mid:
            hs, he, name = host[h]
            heapq.heappush(by_start, (-hs, he, name))
            h += 1
        while by_start and by_start[0][1] < mid:  # ended before this middle, so before every later one
            heapq.heappop(by_start)
        out[g] = (by_start[0][2] if by_start else "host outside any range", (e - s) / 1e6)
    return out


