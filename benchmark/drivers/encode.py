"""``encode``: corpus encoding through the program's
``retriever.encoder.encode_dataset``, the path of ``build_index``, the
ANCE refresh and BEIR.

Set-up draws the encoder's weights from the seed on the card, builds the
``DRModel`` and a pool of passages (lengths from the mix's fixed set in
the seed's order, ids from the seed), and encodes a few batches to warm
the one shape. The window is one ``encode_dataset`` call over a stream
that stops yielding when the window's time is up; the call returns every
rep it was given a passage for, on the host, and the rate is those
passages over the call's whole time. Afterwards a seeded sample of them,
the longest passage in it, is checked against the plain reference."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import tracing, traffic
from ..common import (TAG_SAMPLE, TAG_TEXT, TAG_WEIGHTS, Cell, Outcome,
                      derived_seed, judge, rng)
from ..program import dr_model
from ..reference.quant import exact_fp32
from ..weights import hf_state


def passages(tr: dict, seed: int):
    """The pool: (flat ids, starts) of ``pool_passages`` passages, each its
    words then the end id."""
    n = tr["pool_passages"]
    lens = traffic.lengths(tr["passage_tokens"], n, seed)
    return traffic.ragged(rng(seed, TAG_TEXT), lens, tr["word_ids"],
                          suffix=tr.get("suffix_ids", ()))


class Stream:
    """The window's dataset: passages ``start``, ``start + 1``, ... of the
    pool (cycled) as ``{"id": i, "input_ids": ...}`` until ``deadline``
    (perf_counter)."""

    def __init__(self, flat, starts, deadline: float, start: int = 0):
        self.flat, self.starts = flat, starts
        self.deadline, self.start = deadline, start

    def __iter__(self):
        n = len(self.starts) - 1
        i = self.start
        while time.perf_counter() < self.deadline:
            j = i % n
            yield {"id": i,
                   "input_ids": self.flat[self.starts[j]:self.starts[j + 1]]}
            i += 1


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda") -> Outcome:
    from openmatch_tpu_torch.retriever.encoder import encode_dataset

    device = torch.device(device)
    tr, cfg = cell.traffic, cell.config
    weights = hf_state(cfg, derived_seed(seed, TAG_WEIGHTS), device)
    model = dr_model(cfg, weights, device).eval()
    flat, starts = passages(tr, seed)
    bs, p_len = tr["batch_size"], cfg["dr"]["p_max_len"]
    pad = cfg.get("pad_token_id", 0)

    def encode(stream):
        return encode_dataset(model, stream, batch_size=bs, max_len=p_len,
                              pad_token_id=pad, device=device)

    warm = [{"id": i, "input_ids": flat[starts[i]:starts[i + 1]]}
            for i in range(bs * tr["warm_batches"])]
    encode(warm)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start

    # the window: one call, or with ``trace`` a traced call over its
    # first seconds and a second call over the rest
    prof = tracing.Profiled(device) if trace else None
    if prof is not None:  # started before the window: starting takes time
        prof.start()
    t0 = time.perf_counter()
    parts = []
    if prof is not None:
        parts.append(encode(Stream(flat, starts,
                                   t0 + min(tracing.TRACE_S, seconds))))
        prof.stop()
    done = sum(len(p[1]) for p in parts)
    t_rest = time.perf_counter()
    parts.append(encode(Stream(flat, starts, t0 + seconds, done)))
    elapsed = time.perf_counter() - t0
    reps = np.concatenate([p[0] for p in parts])
    ids = [i for p in parts for i in p[1]]
    # the part after the traced one, for the per-layer rates: the
    # profiler slows the host
    rest_n, rest_s = len(parts[-1][1]), time.perf_counter() - t_rest
    summary = prof.summary() if prof is not None else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n = len(ids)
    print(f"encode: {n} passages in {elapsed:.3f} s of window "
          f"({n / elapsed:.1f}/s) in batches of {bs}", file=sys.stderr)
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(cfg, tr, weights, flat, starts, reps, ids, seed, device)
    checks = {name: (value, cell.limits.get(name))
              for name, value in numbers.items()}
    return Outcome(
        correct=judge(checks), attempted=n, failed=0,
        metrics={"encode_passages_per_s": n / elapsed, "setup_s": setup_s},
        memory_peak_bytes=peak, chips=1, checks=checks,
        layer={"trace": summary, "passages": rest_n, "window_s": rest_s,
               "p_len": p_len, "config": cfg},
        busy_s=summary.busy_s if summary else None,
        window_s=summary.window_s if summary else None,
        breakdown=summary.breakdown() if summary else None)


def pick(ids, lengths, n_check: int, seed: int) -> np.ndarray:
    """Positions to check: the first longest passage and a seeded draw."""
    longest = int(np.argmax(lengths))
    rest = np.delete(np.arange(len(ids)), longest)
    rest = rng(seed, TAG_SAMPLE).permutation(rest)[:n_check - 1]
    return np.concatenate([[longest], rest]).astype(np.int64)


def reference_reps(cfg, weights, flat, starts, which, p_len, device,
                   precision=None) -> torch.Tensor:
    from ..reference import t5 as ref_t5

    n_pool = len(starts) - 1
    rows = [flat[starts[j % n_pool]:starts[j % n_pool + 1]][:p_len]
            for j in which]
    width = max(len(r) for r in rows)
    ids = np.zeros((len(rows), width), np.int64)
    mask = np.zeros_like(ids)
    for i, r in enumerate(rows):
        ids[i, :len(r)], mask[i, :len(r)] = r, 1
    out = []
    with exact_fp32(), torch.no_grad():
        for lo in range(0, len(rows), 64):
            out.append(ref_t5.reps(
                weights, cfg, torch.from_numpy(ids[lo:lo + 64]).to(device),
                torch.from_numpy(mask[lo:lo + 64]).to(device), precision))
    return torch.cat(out)


def rep_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative L2 gap of a rep from the reference's."""
    return float((torch.linalg.vector_norm(got - want, dim=1)
                  / torch.linalg.vector_norm(want, dim=1)).max())


def check(cfg, tr, weights, flat, starts, reps, ids, seed, device) -> dict:
    """``rep_err`` over the sample, and ``order``: 1 when the reps do not
    come back one per passage in the order given, else 0."""
    n = len(ids)
    if n == 0 or list(ids) != list(range(n)) or reps.shape[0] != n:
        return {"rep_err": 1.0, "order": 1.0}
    n_pool = len(starts) - 1
    lengths = np.diff(starts)[np.arange(n) % n_pool]
    which = pick(ids, lengths, tr["check_sample"], seed)
    want = reference_reps(cfg, weights, flat, starts, which,
                          cfg["dr"]["p_max_len"], device)
    got = torch.from_numpy(np.asarray(reps[which], np.float32)).to(device)
    return {"rep_err": rep_err(got, want), "order": 0.0}
