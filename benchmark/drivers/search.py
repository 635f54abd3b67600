"""``search``: ``/search`` requests into the program's in-process
``RetrievalService`` (the serving path with the HTTP front left out) over
an exact-search index on the card, offered above the rate the service
sustains.

Set-up draws the index (unit rows in bf16) and the encoder's weights from
the seed on the card, builds ``DRModel``, ``Searcher`` and
``RetrievalService``, and warms them with a short load at the cell's rate.
The window sends requests of ``queries_per_request`` queries each (as
``POST /search`` takes a list) at Poisson due times from a few sender
threads, each waiting for its answer before it sends the next; at a rate
above what the service sustains the senders run behind their due times
and the queue always holds work. A sender sends nothing once the window
has closed; the rate is the queries answered within the window over its
seconds. Afterwards a sample of the answered queries drawn from the seed,
the longest in it, is checked against the plain reference: the float32
encoder and an exact float32 top-k over the same index rows.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import tracing, traffic
from ..common import (TAG_INDEX, TAG_SAMPLE, TAG_TEXT, TAG_WEIGHTS, Cell,
                      Outcome, derived_seed, judge, rng)
from ..program import dr_model
from ..reference import bert as ref_bert
from ..reference.quant import exact_fp32
from ..reference.search import scores_of, topk
from ..tokenizer import WordTokenizer
from ..weights import hf_state

INDEX_CHUNK_ROWS = 1 << 20
WAIT_AFTER_S = 60.0  # how long past the window a request may still come


class PositionIds:
    """Doc ids of the index: a row's id is its position. A mapping and not
    a list of 8.8M ids: the collector walks such a list at every full
    collection (a quarter of a second a time on the card's host), which
    the benchmark's input would add to the program's tail."""

    def __getitem__(self, i):
        return int(i)


def make_index(n_rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """``n_rows`` x ``dim`` bf16 unit rows drawn on ``device`` from one
    seeded generator, a chunk at a time (one float32 chunk transient)."""
    index = torch.empty((n_rows, dim), dtype=torch.bfloat16, device=device)
    g = torch.Generator(device=device).manual_seed(
        derived_seed(seed, TAG_INDEX))
    for lo in range(0, n_rows, INDEX_CHUNK_ROWS):
        hi = min(lo + INDEX_CHUNK_ROWS, n_rows)
        rows = torch.empty((hi - lo, dim), device=device).normal_(
            generator=g)
        index[lo:hi] = rows / torch.linalg.vector_norm(rows, dim=1,
                                                       keepdim=True)
        del rows
    return index


def query_texts(tr: dict, n: int, seed: int, tag: int = 0) -> List[str]:
    """``n`` query texts of ``w<id>`` words: word counts from the mix's
    fixed set in the seed's order, ids from the seed."""
    words = traffic.lengths(tr["query_words"], n, seed, tag)
    r = rng(seed, TAG_TEXT * 1000 + tag)
    ids = traffic.word_ids(r, int(words.sum()), tr["word_ids"])
    out, at = [], 0
    for m in words:
        out.append(WordTokenizer.text(ids[at:at + m]))
        at += m
    return out


@dataclass
class State:
    cell: Cell
    device: torch.device
    index: torch.Tensor
    weights: dict
    model: object
    searcher: object
    service: object
    tokenizer: WordTokenizer


def setup(cell: Cell, seed: int, device) -> State:
    from openmatch_tpu_torch.drivers.serve import RetrievalService
    from openmatch_tpu_torch.ops.mips import Searcher

    tr, cfg = cell.traffic, cell.config
    index = make_index(tr["index_rows"], cfg["hidden_size"], seed, device)
    weights = hf_state(cfg, derived_seed(seed, TAG_WEIGHTS), device)
    model = dr_model(cfg, weights, device).eval()
    searcher = Searcher(index, k=tr["depth"])
    tok = WordTokenizer(cfg["vocab_size"])
    service = RetrievalService(model, tok, searcher, PositionIds(),
                               q_max_len=cfg["dr"]["q_max_len"],
                               max_batch=tr["max_batch"])
    service.coalesce_window_s = tr["coalesce_window_s"]
    service.warmup()
    return State(cell, device, index, weights, model, searcher, service, tok)


@dataclass
class Window:
    """What came back, a query at a time."""

    texts: List[str]
    sent: np.ndarray       # s from the window's start; nan: never sent
    done: np.ndarray       # nan: sent and never answered
    ok: np.ndarray
    results: list
    timeline: list
    seconds: float
    trace: Optional[tracing.TraceSummary] = None
    untraced_from: float = 0.0  # time.monotonic() where the trace ended
    gc_pauses: list = None  # seconds of each full collection in the window

    def answered_in_window(self) -> int:
        return int((self.ok & (self.done <= self.seconds)).sum())


def drive(state: State, rate: float, seconds: float, seed: int,
          tag: int = 0, trace: bool = False) -> Window:
    """Offer ``rate`` queries a second, in requests of the mix's
    ``queries_per_request``, at Poisson due times for ``seconds`` from the
    senders (none sent after that), wait for those sent (up to
    ``WAIT_AFTER_S`` past the window), and return what came back."""
    tr = state.cell.traffic
    m = tr["queries_per_request"]
    n = max(int(round(rate * seconds / m)), 1)  # requests
    texts = query_texts(tr, n * m, seed, tag)
    gaps = np.diff(traffic.arrival_offsets(rate / m, n + 1))
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    due *= seconds / (due[-1] + gaps[-1])  # exactly n in ``seconds``
    sent, done = np.full(n * m, np.nan), np.full(n * m, np.nan)
    ok = np.zeros(n * m, bool)
    results: list = [None] * (n * m)
    k = tr["k"]
    service = state.service
    lock = threading.Lock()
    cursor = [0]

    def sender():
        while True:
            with lock:
                i = cursor[0]
                cursor[0] += 1
            if i >= n:
                return
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            now = time.perf_counter() - t0
            if now >= seconds:
                return
            rows = slice(i * m, (i + 1) * m)
            sent[rows] = now
            try:
                answers = service.search(texts[rows], k=k)
                # kept as two small arrays a query: holding every answer's
                # dicts would grow the heap the collector walks all window
                for j, hits in enumerate(answers):
                    results[i * m + j] = (
                        np.fromiter((h["id"] for h in hits), np.int64,
                                    len(hits)),
                        np.fromiter((h["score"] for h in hits), np.float64,
                                    len(hits)))
                ok[rows] = len(answers) == m
            except Exception:  # refused or failed: counted in ``failed``
                ok[rows] = False
            done[rows] = time.perf_counter() - t0

    threads = [threading.Thread(target=sender, daemon=True)
               for _ in range(tr["senders"])]
    pauses = []  # full collections in the window: (start, seconds)

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                pauses.append([time.perf_counter(), 0.0])
            elif pauses:
                pauses[-1][1] = time.perf_counter() - pauses[-1][0]

    gc.callbacks.append(on_gc)
    prof = tracing.Profiled(state.device) if trace else None
    if prof is not None:  # started before the window: starting takes time
        prof.start()
    service.timeline = []
    t0 = time.perf_counter() + 0.05
    for t in threads:
        t.start()
    untraced_from = 0.0
    if prof is not None:
        time.sleep(max(t0 + min(tracing.TRACE_S, seconds)
                       - time.perf_counter(), 0.0))
        prof.stop()
        untraced_from = time.monotonic()
    end = t0 + seconds + WAIT_AFTER_S
    for t in threads:
        t.join(max(end - time.perf_counter(), 0.0))
    gc.callbacks.remove(on_gc)
    timeline = service.timeline
    service.timeline = None
    w = Window(texts, sent, done, ok, results, timeline, seconds,
               untraced_from=untraced_from, gc_pauses=[p for _, p in pauses])
    if prof is not None:
        w.trace = prof.summary()
    return w


def sample(w: Window, tr: dict, seed: int) -> np.ndarray:
    """Indices of finished requests to check: the longest query and a
    seeded draw of the rest, ``check_sample`` in all."""
    done = np.flatnonzero(w.ok)
    if done.size == 0:
        return done
    lengths = np.array([len(w.texts[i].split()) for i in done])
    longest = done[int(np.argmax(lengths))]
    rest = rng(seed, TAG_SAMPLE).permutation(done[done != longest])
    return np.concatenate([[longest], rest[:tr["check_sample"] - 1]])


def reference_answers(state: State, texts: List[str], k: int,
                      precision=None):
    """(reps, scores [n, k], ids [n, k]) of the plain reference, or of
    the control with ``precision="fp8"``."""
    cfg = state.cell.config
    enc = [state.tokenizer.encode(t, cfg["dr"]["q_max_len"]) for t in texts]
    width = max(len(e) for e in enc)
    ids = np.zeros((len(enc), width), np.int64)
    mask = np.zeros_like(ids)
    for i, e in enumerate(enc):
        ids[i, :len(e)], mask[i, :len(e)] = e, 1
    dev = state.device
    with exact_fp32(), torch.no_grad():
        q = ref_bert.reps(state.weights, cfg, torch.from_numpy(ids).to(dev),
                          torch.from_numpy(mask).to(dev), precision)
        s, i = topk(q, state.index, k, precision=precision)
    return q, s, i


def answer_numbers(state: State, q_ref: torch.Tensor, s_ref: torch.Tensor,
                   ids: torch.Tensor, scores: torch.Tensor,
                   complete: torch.Tensor) -> dict:
    """The two compared numbers of answers (``ids``, ``scores`` [n, k])
    against the reference's (``q_ref``, its top-k scores ``s_ref``), in
    units of each query's reference norm: ``rank_gap``, the most a served
    document's reference score lies below the reference's k-th best, and
    ``score_err``, the largest gap between a served score and the
    reference's score of that document. An answer short of k documents, or
    with one twice, reads 1."""
    with exact_fp32(), torch.no_grad():
        ref_of_served = scores_of(q_ref, state.index, ids)
    norm = torch.linalg.vector_norm(q_ref, dim=1, keepdim=True)
    kth = s_ref[:, -1:]
    gap = ((kth - ref_of_served) / norm).clamp_min(0).amax(dim=1)
    err = ((scores - ref_of_served).abs() / norm).amax(dim=1)
    dup = torch.tensor([len(set(r.tolist())) < r.numel() for r in ids],
                       device=ids.device)
    bad = dup | ~complete
    gap = torch.where(bad, torch.ones_like(gap), gap)
    err = torch.where(bad, torch.ones_like(err), err)
    return {"rank_gap": float(gap.max()), "score_err": float(err.max())}


def served(w: Window, picks: np.ndarray, k: int, device):
    """(ids, scores, complete) [n, k] of the picked requests' answers."""
    ids = torch.zeros((len(picks), k), dtype=torch.long)
    scores = torch.zeros((len(picks), k), dtype=torch.float64)
    complete = torch.ones(len(picks), dtype=torch.bool)
    for r, i in enumerate(picks):
        got_ids, got_scores = w.results[i]
        n = min(len(got_ids), k)
        complete[r] = len(got_ids) >= k
        ids[r, :n] = torch.from_numpy(got_ids[:n])
        scores[r, :n] = torch.from_numpy(got_scores[:n])
    return ids.to(device), scores.float().to(device), complete.to(device)


def check(state: State, w: Window, seed: int) -> dict:
    tr = state.cell.traffic
    picks = sample(w, tr, seed)
    if picks.size == 0:
        return {"rank_gap": 1.0, "score_err": 1.0}
    q_ref, s_ref, _ = reference_answers(state, [w.texts[i] for i in picks],
                                        tr["k"])
    ids, scores, complete = served(w, picks, tr["k"], state.device)
    return answer_numbers(state, q_ref, s_ref, ids, scores, complete)


def control_numbers(state: State, texts: List[str]) -> dict:
    """The control (the reference in fp8) judged as the program is."""
    k = state.cell.traffic["k"]
    q_ref, s_ref, _ = reference_answers(state, texts, k)
    _, s_c, i_c = reference_answers(state, texts, k, precision="fp8")
    complete = torch.ones(len(texts), dtype=torch.bool, device=state.device)
    return answer_numbers(state, q_ref, s_ref, i_c, s_c, complete)


def release_program(state: State) -> None:
    """Stop the service and drop the program's objects (the index and the
    weights are the benchmark's inputs and stay for the reference)."""
    state.service.close()
    state.service = state.searcher = state.model = None
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


def layer_inputs(state: State, w: Window) -> dict:
    tr, cfg = state.cell.traffic, state.cell.config
    # the dispatches after the traced part: the profiler slows the host
    untraced = [d for d in w.timeline if d["t"] >= w.untraced_from]
    return {"timeline": untraced, "trace": w.trace,
            "q_max_len": cfg["dr"]["q_max_len"], "config": cfg,
            "n_docs": tr["index_rows"], "max_batch": tr["max_batch"],
            "dim": cfg["hidden_size"]}


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda") -> Outcome:
    device = torch.device(device)
    tr = cell.traffic
    state = setup(cell, seed, device)
    drive(state, tr["rate_per_s"], tr["warm_load_s"], seed, tag=1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start
    w = drive(state, tr["rate_per_s"], seconds, seed, trace=trace)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    answered = w.answered_in_window()
    sent = np.isfinite(w.sent)
    rows = [d["rows"] for d in w.timeline]
    print(f"search: {int(sent.sum())} queries sent in {seconds} s at "
          f"{tr['rate_per_s']}/s offered, {answered} answered within it "
          f"({answered / seconds:.1f}/s); {len(rows)} dispatches of "
          f"{np.mean(rows) if rows else 0:.2f} rows; {len(w.gc_pauses)} "
          f"full collections, longest "
          f"{1e3 * max(w.gc_pauses, default=0):.1f} ms", file=sys.stderr)
    release_program(state)
    numbers = check(state, w, seed)
    numbers["lost"] = float((sent & np.isnan(w.done)).sum())
    checks = {name: (value, cell.limits.get(name))
              for name, value in numbers.items()}
    return Outcome(correct=judge(checks), attempted=int(sent.sum()),
                   failed=int((sent & ~w.ok).sum()),
                   metrics={"search_queries_per_s": answered / seconds,
                            "setup_s": setup_s},
                   memory_peak_bytes=peak, chips=1, checks=checks,
                   layer=layer_inputs(state, w),
                   busy_s=w.trace.busy_s if w.trace else None,
                   window_s=w.trace.window_s if w.trace else None,
                   breakdown=w.trace.breakdown() if w.trace else None)
