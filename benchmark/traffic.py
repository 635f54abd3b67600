"""The one generator every traffic mix is read by.

A mix is a data file of parameters (``benchmark/traffic/<mix>.json``):
length distributions, word-id ranges, arrival rates, batch sizes. The
work a run does must not depend on its seed, only the numbers in it: so
lengths are drawn once from a fixed stream and each seed takes them in its
own order (the same set of sizes in another order), arrivals are one fixed
draw for every seed, and the ids in the texts are drawn from the seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .common import TAG_ORDER, rng

BASE_SEED = 20_241_018  # the fixed stream the sizes and gaps come from


def _base(tag: int) -> np.random.Generator:
    return np.random.default_rng([BASE_SEED, tag])


def lengths(dist: dict, n: int, seed: int, tag: int = 0) -> np.ndarray:
    """``n`` whole lengths from ``dist`` ({"dist": "lognormal", "mu",
    "sigma", "min", "max"}: the rounded exp of a normal, clipped), the
    same multiset for every seed, ordered by ``seed``."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    base = _base(100 + tag).lognormal(dist["mu"], dist["sigma"], n)
    out = np.clip(np.rint(base), dist["min"], dist["max"]).astype(np.int64)
    return rng(seed, TAG_ORDER * 1000 + tag).permutation(out)


def arrival_offsets(rate_per_s: float, n: int) -> np.ndarray:
    """Due times (s from the window's start) of ``n`` Poisson arrivals at
    ``rate_per_s``: one fixed draw of exponential gaps, replayed in the
    same order for every seed. A tail latency depends on the order of the
    gaps (where the bursts fall), so the seed changes only what is asked."""
    return np.cumsum(_base(200).exponential(1.0, n) / rate_per_s)


def word_ids(r: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    """``n`` ids in [lo, hi) with P(rank r) ~ 1 / r^zipf over a seeded
    shuffle of the range (a Zipf law over the vocabulary)."""
    lo, hi, s = spec["lo"], spec["hi"], spec.get("zipf", 1.0)
    ranks = np.arange(1, hi - lo + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -s)
    picks = np.searchsorted(cdf / cdf[-1], r.random(n))
    perm = _base(300).permutation(hi - lo)
    return (lo + perm[np.minimum(picks, hi - lo - 1)]).astype(np.int64)


def ragged(r: np.random.Generator, lens: np.ndarray, spec: dict,
           prefix=(), suffix=()) -> Tuple[np.ndarray, np.ndarray]:
    """Sequences of the given total ``lens`` (``prefix`` and ``suffix`` ids
    included) as one flat int32 array and their start offsets [n + 1]."""
    pre, suf = np.asarray(prefix, np.int64), np.asarray(suffix, np.int64)
    inner = np.maximum(lens - len(pre) - len(suf), 0)
    body = word_ids(r, int(inner.sum()), spec)
    total = inner + len(pre) + len(suf)
    starts = np.concatenate([[0], np.cumsum(total)])
    flat = np.empty(int(total.sum()), np.int32)
    at = 0
    for i, m in enumerate(inner):
        s = starts[i]
        flat[s:s + len(pre)] = pre
        flat[s + len(pre):s + len(pre) + m] = body[at:at + m]
        flat[s + len(pre) + m:starts[i + 1]] = suf
        at += m
    return flat, starts


def pad_rows(rows, width: int, pad_id: int) -> dict:
    """Id rows cut to ``width`` and padded with ``pad_id`` ->
    ``{"input_ids", "attention_mask"}`` int64 arrays [n, width]."""
    ids = np.full((len(rows), width), pad_id, np.int64)
    mask = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        r = r[:width]
        ids[i, :len(r)], mask[i, :len(r)] = r, 1
    return {"input_ids": ids, "attention_mask": mask}
