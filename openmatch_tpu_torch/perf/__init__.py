"""Twins of the JAX package's perf scripts, run as modules:

    python -m openmatch_tpu_torch.perf.score_path_phases PHASE [N] [Q] [K] [ARG5] [--device cpu]
    python -m openmatch_tpu_torch.perf.micro MODE [Q] [N] [K] [--device cpu]

Each runs one phase or mode, prints one line, and returns its numbers from
``main(argv)``. They run on the card unless ``--device cpu`` is given, and
raise without one. This module holds what both share: the device argument,
seeded inputs, and the timer (CUDA events on the card, ``time.perf_counter``
on the CPU; the median of a few runs after a warm-up), which stands in for
the TPU scripts' ``fori_loop`` amortisation.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable

import torch

from ..device import resolve_device

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
REPS = 5


def add_device_arg(ap: argparse.ArgumentParser):
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")


def device_of(args) -> torch.device:
    return resolve_device(args.device)


def normal(shape, seed: int, device: torch.device,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Seeded N(0, 1) values made on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=dtype)


def randint(high: int, shape, seed: int, device: torch.device,
            dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Seeded integers in [0, high) made on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, high, shape, generator=g, device=device,
                         dtype=dtype)


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_call_s(fn: Callable, device: torch.device) -> float:
    """Host seconds of one call of ``fn``, its device work included."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def time_ms(fn: Callable, device: torch.device, warmup: int = 1,
            reps: int = REPS, queue: str = "") -> float:
    """Median milliseconds of one call of ``fn``: device time between two
    CUDA events on the card (``event_ms``; ``queue`` as there, "" for
    none), host time on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            times.append(event_ms(fn, queue))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1000)
    return statistics.median(times)


_spin_cycles = 1 << 21
MAX_SPIN_CYCLES = 1 << 30


def event_ms(fn: Callable, queue: str = "") -> float:
    """Device milliseconds of one call of ``fn`` between two CUDA events.

    ``queue`` says what runs on the card just before the timed call:
    "" nothing added (the previous call, if any); "call" an untimed call
    of ``fn``, so the timed one finds the caches as a repeated call does,
    and where the host takes longer to enqueue the timed call than the
    card takes to run the untimed one, that host time counts (calls made
    back to back pay it); "spin" an untimed call and then a device spin
    (``torch.cuda._sleep``) that outlasts the host's enqueue of the timed
    call, so the events bracket the card's work alone. The spin is
    checked on every call: if the card has reached the first event by the
    time ``fn`` returns, it doubles and the call is timed again (up to
    ``MAX_SPIN_CYCLES``; ``fn`` must not wait for the card)."""
    global _spin_cycles
    if queue not in ("", "call", "spin"):
        raise ValueError(f"queue={queue!r}: '', 'call' or 'spin'")
    if queue:
        fn()
    while True:
        if queue == "spin":
            torch.cuda._sleep(_spin_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        reached = queue == "spin" and a.query()
        b.record()
        b.synchronize()
        if not reached:
            return a.elapsed_time(b)
        if _spin_cycles >= MAX_SPIN_CYCLES:
            raise RuntimeError(f"event_ms: the card outran a spin of "
                               f"{_spin_cycles} cycles; does fn wait for it?")
        _spin_cycles *= 2


def spin_ms() -> tuple:
    """(cycles, device ms) of ``event_ms``'s current spin, measured."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(_spin_cycles)
    b.record()
    b.synchronize()
    return _spin_cycles, a.elapsed_time(b)
