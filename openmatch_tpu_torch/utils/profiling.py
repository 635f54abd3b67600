"""Tracing, step timing, and metrics logging.

Twin of ``openmatch_tpu/utils/profiling.py``:

- ``trace(logdir)``: context manager around ``torch.profiler`` (CPU
  activity, and CUDA activity when a card is present) that writes a Chrome
  trace (``trace.json``) into ``logdir``. It yields the profiler, so a
  caller can also read ``key_averages()``.
- ``StepTimer``: wall-clock step timing with EMA + examples/sec (call
  ``tick`` after forcing the result you log: CUDA work is asynchronous).
- ``MetricsLogger``: append-only jsonl metrics stream (step, name, value,
  wall time); plus an optional TensorBoard writer when tensorboardX is
  importable.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    import torch

    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class StepTimer:
    def __init__(self, ema: float = 0.98):
        self.ema = ema
        self.avg_s: Optional[float] = None
        self._last = time.perf_counter()

    def tick(self, n_examples: int = 0) -> Dict[str, float]:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.avg_s = dt if self.avg_s is None else self.ema * self.avg_s + (1 - self.ema) * dt
        out = {"step_time_s": dt, "step_time_ema_s": self.avg_s}
        if n_examples:
            out["examples_per_s"] = n_examples / dt
        return out


class MetricsLogger:
    def __init__(self, output_dir: str, filename: str = "metrics.jsonl",
                 tensorboard: bool = False):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self._f = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter  # optional

                self._tb = SummaryWriter(output_dir)
            except ImportError:
                pass

    def log(self, step: int, **metrics: float):
        record = {"step": step, "time": time.time(), **metrics}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        if self._tb is not None:
            for name, value in metrics.items():
                self._tb.add_scalar(name, value, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
