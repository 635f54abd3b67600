"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over the
first seconds of the window, read back from its Chrome trace.

What it gives: the device's busy seconds (the union of every kernel,
copy and set on the card), the traced window's length, device time and
launch counts by kernel name, and the longest idle gaps, each named by
the host operation running at its midpoint (the innermost annotation or
operator; "host python" where the host ran no torch operator). The
trace file goes to a temporary directory and is deleted once read.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TRACE_S = 3.0  # the traced part of a window, s
MIN_GAP_US = 20.0  # idle shorter than this is launch spacing, not a gap


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    kernels: Dict[str, Tuple[int, float]]  # name -> (launches, seconds)
    launches: int
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, substring: str) -> Tuple[int, float]:
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if substring in name:
                n, s = n + c, s + t
        return n, s

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name, t] for name, (_, t) in ops],
                "idle_gaps": [[name, t] for name, t in gaps]}


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: List[dict], window_s: float) -> TraceSummary:
    """A ``TraceSummary`` from Chrome-trace ``events`` (µs) of a window of
    ``window_s`` host seconds."""
    dev, host = [], []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    launches = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, d = float(e["ts"]), float(e.get("dur", 0.0))
            dev.append((a, a + d))
            k = kernels[e.get("name", "?")]
            k[0] += 1
            k[1] += d * 1e-6
            if cat == "kernel":
                launches += 1
        elif cat in HOST_CATS:
            a, d = float(e["ts"]), float(e.get("dur", 0.0))
            host.append((a, a + d, d, e.get("name", "?")))
    merged = _merge(dev)
    busy = sum(b - a for a, b in merged) * 1e-6
    # idle gaps between device work, named by the innermost host op
    # (shortest span) covering the gap's midpoint
    host.sort()
    idle: Dict[str, float] = defaultdict(float)
    active: list = []  # host ops begun before the current midpoint
    j = 0
    for (_, a1), (b0, _) in zip(merged, merged[1:]):
        gap = b0 - a1
        if gap < MIN_GAP_US:
            continue
        mid = (a1 + b0) / 2
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        best = min(active, key=lambda h: h[2], default=None)
        idle[best[3] if best else "host python"] += gap * 1e-6
    return TraceSummary(busy_s=busy, window_s=window_s,
                        kernels={k: (int(v[0]), v[1])
                                 for k, v in kernels.items()},
                        launches=launches, idle_by_host=dict(idle))


class Profiled:
    """``torch.profiler`` over part of a window: ``start()``, ``stop()``
    (which synchronises the card first, so the device work of the traced
    part is in the trace) and, once the window is over, ``summary()``,
    which exports the trace, reads it and deletes it."""

    def __init__(self, device):
        self.device = device
        self.window_s = 0.0

    def start(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()

    def summary(self) -> TraceSummary:
        with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            del self._prof
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        return summarize(events, self.window_s)


def idle_pct(summary: Optional[TraceSummary]) -> Optional[float]:
    """The share of the traced window with nothing running on the card,
    in %; None without a trace."""
    if summary is None or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
