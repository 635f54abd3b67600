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
            reps: int = REPS) -> float:
    """Median milliseconds of one call of ``fn``: device time between two
    CUDA events on the card, host time on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1000)
    return statistics.median(times)
