"""The profiler's trace of a short steady sub-window and what the
per-layer metrics read from it.

:func:`capture` runs a function under ``torch.profiler`` (host and device
activity) inside a ``bench.trace_window`` span, with the device
synchronised at both ends, writes the Chrome trace to the temporary
directory, reads it back and deletes it. The window is that span's host
interval. Device events are the complete events of category ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; times are in microseconds.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bench.trace_window"


@dataclass
class Trace:
    window: tuple[float, float]
    device: list[dict[str, Any]] = field(default_factory=list)
    host: list[dict[str, Any]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def parse(events: list[dict[str, Any]]) -> Trace:
    """A :class:`Trace` of Chrome-trace events: the ``bench.trace_window``
    host span, the device events and the host spans inside it."""
    win = next(e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation")
    lo, hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])

    def inside(e: dict[str, Any]) -> bool:
        return e.get("ph") == "X" and float(e["ts"]) < hi and float(e["ts"]) + float(e.get("dur", 0)) > lo

    device = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("name") != WINDOW and inside(e)]
    return Trace((lo, hi), device, host)


def capture(fn: Callable[[], Any], sync: Callable[[], None], on_card: bool = True) -> Trace:
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        sync()
        with record_function(WINDOW):
            fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events)


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Overlapping intervals merged, in order."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(trace: Trace) -> list[tuple[float, float]]:
    """The union of the device events, clipped to the window."""
    lo, hi = trace.window
    spans = [(max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e["dur"]))) for e in trace.device]
    return union([(a, b) for a, b in spans if b > a])


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in busy(trace)) / 1e6


def gaps(trace: Trace) -> list[tuple[float, float]]:
    """The intervals of the window in which no device event runs."""
    out, at = [], trace.window[0]
    for a, b in busy(trace):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if trace.window[1] > at:
        out.append((at, trace.window[1]))
    return out


def idle_pct(trace: Trace) -> float:
    return 100.0 * (1.0 - busy_s(trace) / trace.window_s)


def idle_gaps(trace: Trace, top: int = 10) -> list[list[Any]]:
    """[host span, seconds] of the device's idle time by what the host was
    doing at each gap's middle (the innermost host span covering it: the
    shortest), the largest first. One sweep over the spans sorted by start."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e["name"])) for e in trace.host)
    by: dict[str, float] = defaultdict(float)
    active: list[tuple[float, float, str]] = []  # (end, length, name), a heap by end
    at = 0
    for a, b in gaps(trace):
        mid = (a + b) / 2.0
        while at < len(spans) and spans[at][0] <= mid:
            start, end, name = spans[at]
            heapq.heappush(active, (end, end - start, name))
            at += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = min(active, key=lambda span: span[1])[2] if active else "(no host span)"
        by[name] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(trace: Trace, top: int = 10, width: int = 160) -> list[list[Any]]:
    """[device event name, seconds] summed by name, the largest first."""
    by: dict[str, float] = defaultdict(float)
    for e in trace.device:
        by[str(e["name"])[:width]] += float(e["dur"]) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def launches(trace: Trace, test: Callable[[str], bool]) -> list[dict[str, Any]]:
    """The kernel events whose name passes *test*."""
    return [e for e in trace.device if e.get("cat") == "kernel" and test(str(e["name"]))]

