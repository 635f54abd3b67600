"""Tracing: the port's span recorder and the operator's Chrome trace.

- ``span(name, **attrs)``: a context manager around one piece of host
  work (a dispatch, a batch, a step and their phases). Tracing is on
  exactly while a ``torch.profiler`` records, in any thread; off, a span
  reads one flag and returns a shared no-op object. On, it enters
  ``torch.profiler.record_function(name)``, so a profiler that records the
  thread carries it on its own clock, and on exit appends a ``Record`` to
  an in-memory buffer of the last ``BUFFER_SPANS``. A span is kept if
  tracing was on when it began, and is ``whole`` if tracing was still on
  when it ended.
- ``Span(name, **attrs)``: the same span, timed whether tracing is on or
  not, for a caller that reads its duration either way (the serving
  queue's ``timeline``): ``t0`` / ``t1`` on ``time.monotonic`` and
  ``seconds``. It records only as ``span`` does.
- ``recorded()`` / ``clear()``: the buffer, oldest first, and emptying it.
- ``trace(logdir)``: context manager around ``torch.profiler`` (CPU
  activity on every thread, and CUDA activity when a card is present)
  that writes a Chrome trace (``trace.json``) into ``logdir``. It yields
  the profiler, so a caller can also read ``key_averages()``.

A ``Record``'s ``start`` and ``end`` are microseconds since the Unix
epoch: the clock of the Chrome trace's ``ts`` plus its
``baseTimeNanoseconds``. ``start`` is read from that clock, ``end`` is
``start`` plus the span's ``time.monotonic`` duration, so a step of the
wall clock inside a span does not stretch it.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

TRACE_FILE = "trace.json"
BUFFER_SPANS = 1 << 16


class Record(NamedTuple):
    name: str
    start: float  # µs since the Unix epoch
    end: float
    parent: Optional[str]  # the innermost span open in the thread
    thread: int  # native thread id, the Chrome trace's ``tid``
    attrs: dict
    whole: bool  # tracing was still on at its end, so every span begun
    #              inside it was kept


class _Open(threading.local):
    def __init__(self):
        self.stack = []  # the thread's open kept spans, outermost first


_buffer: "collections.deque[Record]" = collections.deque(maxlen=BUFFER_SPANS)
_open = _Open()


class Span:
    """A span that is always timed (``t0``, ``t1`` and ``seconds`` on
    ``time.monotonic``; ``start`` and ``end`` on the recorder's clock) and
    recorded while tracing is on when it begins."""

    __slots__ = ("name", "attrs", "start", "end", "t0", "t1", "_function",
                 "_parent")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs
        self.start = self.end = self.t0 = self.t1 = None
        self._function = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __enter__(self):
        self.start = time.time_ns() / 1e3
        self.t0 = time.monotonic()
        if _profiler._is_profiler_enabled:
            stack = _open.stack
            self._parent = stack[-1].name if stack else None
            stack.append(self)
            self._function = _profiler.record_function(self.name)
            self._function.__enter__()
        return self

    def __exit__(self, *exc):
        function, self._function = self._function, None
        if function is not None:
            function.__exit__(*exc)
        self.t1 = time.monotonic()
        self.end = self.start + (self.t1 - self.t0) * 1e6
        if function is not None:
            _open.stack.pop()
            _buffer.append(Record(self.name, self.start, self.end,
                                  self._parent, threading.get_native_id(),
                                  self.attrs, _profiler._is_profiler_enabled))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A ``Span`` while tracing is on, else the shared no-op object."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, **attrs)


def recorded() -> List[Record]:
    """The kept spans, oldest end first (at most ``BUFFER_SPANS``)."""
    return list(_buffer)


def clear() -> None:
    _buffer.clear()


@contextlib.contextmanager
def trace(logdir: str):
    from torch._C._profiler import _ExperimentalConfig

    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
