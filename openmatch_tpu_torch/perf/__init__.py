"""Twins of the JAX package's perf scripts, run as modules:

    python -m openmatch_tpu_torch.perf.score_path_phases PHASE [N] [Q] [K] [ARG5] [--device cpu]
    python -m openmatch_tpu_torch.perf.micro MODE [Q] [N] [K] [--device cpu]
    python -m openmatch_tpu_torch.perf.corpus_scale [N] [Q] [K] [--device cpu]
    python -m openmatch_tpu_torch.perf.qbatch_sweep N_DOCS Q [Q ...] [--segs K]
    python -m openmatch_tpu_torch.perf.rescore_compare [N] [Q] [K] [--paths ...]
    python -m openmatch_tpu_torch.perf.selection_micro topk|gather|idfix W [Q K F]
    python -m openmatch_tpu_torch.perf.train_bench [BATCH] [N_PASSAGES] [--grad-cache] [--t5] [--rr] [--tiny]
    python -m openmatch_tpu_torch.perf.rerank_bench bert|monot5 [BATCH] [SEQ_LEN] [--tiny]
    python -m openmatch_tpu_torch.perf.pipeline_e2e [--n-docs N] [--n-queries Q] [--depth D] [--tiny]

(and ``ance_cycle``, ``mesh_parity``, ``sharded_merge`` and
``serve_load``, each described in its own module). Each
runs one phase, mode or configuration, prints its line, and returns its
numbers from ``main(argv)``. They run on the card unless ``--device cpu``
is given, and raise without one. This module holds what they share: the
device argument, seeded inputs, the timer (CUDA events on the card,
``time.perf_counter`` on the CPU; the median of a few runs after a
warm-up), which stands in for the TPU scripts' ``fori_loop`` amortisation,
and the tie-band comparison of two exact top-k answers.
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


TIE_REL = 1e-4  # agree_above_band: score tolerance and tie band, x max|score|


def agree_above_band(name: str, s_a: torch.Tensor, i_a: torch.Tensor,
                     s_b: torch.Tensor, i_b: torch.Tensor,
                     rel: float = TIE_REL) -> float:
    """Two exact top-k answers [Q, k] agree: each row's scores within
    ``rel`` x its max|score|, and each answer holds every doc the other
    scores above the row's k-th score plus that band (two paths that sum a
    doc's score in another order may put it on either side of the band's
    edge, so those docs are looked up in the whole other answer). Raises
    naming the row; returns the largest score difference."""
    s_a, i_a, s_b, i_b = (t.cpu() for t in (s_a, i_a, s_b, i_b))
    if s_a.shape != s_b.shape:
        raise AssertionError(f"{name}: shapes {tuple(s_a.shape)} and "
                             f"{tuple(s_b.shape)}")
    worst = 0.0
    for r in range(s_b.shape[0]):
        tol = rel * s_b[r].abs().max().item()
        err = (s_a[r] - s_b[r]).abs().max().item()
        band = s_b[r, -1].item() + tol
        if err > tol \
                or not set(i_a[r][s_a[r] > band].tolist()) <= set(
                    i_b[r].tolist()) \
                or not set(i_b[r][s_b[r] > band].tolist()) <= set(
                    i_a[r].tolist()):
            raise AssertionError(f"{name}: row {r} differs above the tie "
                                 f"band (score err {err}, tolerance {tol})")
        worst = max(worst, err)
    return worst
