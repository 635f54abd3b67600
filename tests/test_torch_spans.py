"""The port's span recorder (``utils.profiling``) and the spans of the
serving queue, the prefetch loader, ``encode_dataset`` and ``DRTrainer``,
on the CPU: tracing is on exactly while a ``torch.profiler`` records, a
span never enters ``record_function`` while off, spans of other threads
are kept with their parents, and their times are on the Chrome trace's
clock."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from openmatch_tpu_torch.config import TrainingArguments
from openmatch_tpu_torch.data.loader import prefetch
from openmatch_tpu_torch.drivers.serve import RetrievalService
from openmatch_tpu_torch.models.bert import BertConfig
from openmatch_tpu_torch.models.dr_model import DRModel
from openmatch_tpu_torch.ops.mips import Searcher
from openmatch_tpu_torch.retriever.encoder import encode_dataset
from openmatch_tpu_torch.train.dr_trainer import DRTrainer
from openmatch_tpu_torch.utils import profiling

TINY_BERT = dict(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                 num_attention_heads=2, intermediate_size=32,
                 max_position_embeddings=32)


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def names(records):
    return [r.name for r in records]


class WordIds:
    """``encode_plus`` for texts of ``w<id>`` words (any other word is
    id 1): [CLS] ids [SEP]."""

    pad_token_id = 0

    def encode_plus(self, text, max_length=None, **_):
        ids = [4 + int(w[1:]) % 60 if w[:1] == "w" and w[1:].isdigit()
               else 1 for w in text.split()]
        if max_length is not None:
            ids = ids[:max_length - 2]
        return {"input_ids": [2] + ids + [3]}


def tiny_model(seed=0):
    torch.manual_seed(seed)
    return DRModel(BertConfig(**TINY_BERT), normalize=True)


def service(max_batch=4):
    index = torch.nn.functional.normalize(
        torch.randn(512, TINY_BERT["hidden_size"],
                    generator=torch.Generator().manual_seed(1)), dim=1)
    return RetrievalService(tiny_model().eval(), WordIds(),
                            Searcher(index, k=8), list(range(512)),
                            q_max_len=8, max_batch=max_batch)


# ---- the recorder ----------------------------------------------------------


def test_off_records_nothing_and_never_enters_record_function(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(profiling._profiler, "record_function", refused)
    off = profiling.span("a", x=1)
    assert off is profiling.span("b")  # the shared no-op object
    with off:
        with profiling.span("c"):
            pass
    with profiling.Span("timed") as sp:
        pass
    assert sp.end >= sp.start and sp.seconds >= 0
    prefetch_out = list(prefetch(iter(range(5))))
    assert prefetch_out == list(range(5))
    assert profiling.recorded() == []


def test_span_in_a_worker_thread_is_kept_with_its_parent():
    """The profiler started in the main thread, the spans opened in
    another: kept, nested, with the worker's thread id and attributes."""
    ids = {}

    def worker():
        ids["thread"] = threading.get_native_id()
        with profiling.span("outer", rows=3):
            with profiling.span("inner"):
                pass

    with profiler():
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    inner, outer = profiling.recorded()
    assert inner.whole and outer.whole
    assert (inner.name, inner.parent) == ("inner", "outer")
    assert (outer.name, outer.parent, outer.attrs) == ("outer", None,
                                                       {"rows": 3})
    assert inner.thread == outer.thread == ids["thread"]
    assert outer.start <= inner.start <= inner.end <= outer.end


def test_a_span_begun_while_tracing_is_kept_after_it_stops():
    prof = profiler()
    prof.start()
    kept = profiling.span("kept")
    kept.__enter__()
    prof.stop()
    with profiling.span("late"):
        pass
    kept.__exit__(None, None, None)
    (rec,) = profiling.recorded()
    assert rec.name == "kept" and not rec.whole


def test_span_times_are_on_the_chrome_trace_clock(tmp_path):
    """``trace`` records every thread; each span's start and end lie
    within 1 ms of its annotation's ``ts`` (+ ``dur``) plus
    ``baseTimeNanoseconds``. A thread's first ``record_function`` pays a
    one-time set-up before its timestamp, so each thread opens one span
    first."""

    def spans(tag):
        for name in ("warm", "a", "b"):
            with profiling.span(f"{tag}.{name}"):
                torch.ones(64).sum()

    with profiling.trace(str(tmp_path)):
        spans("main")
        t = threading.Thread(target=spans, args=("worker",))
        t.start()
        t.join(timeout=30)
    trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    checked = 0
    for r in profiling.recorded():
        if r.name.endswith(".warm"):
            continue
        e = events[r.name]
        assert abs(r.start - (e["ts"] + base_us)) < 1e3, r
        assert abs(r.end - (e["ts"] + e["dur"] + base_us)) < 1e3, r
        assert e["tid"] == r.thread
        checked += 1
    assert checked == 4


# ---- the serving queue -----------------------------------------------------


def search(svc, n_requests=6):
    qs = [[f"w{i} w{i + 1}", f"w{i + 2}"] for i in range(n_requests)]
    threads = [threading.Thread(target=svc.search, args=(q,), kwargs={"k": 3})
               for q in qs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def test_retrieval_service_records_a_dispatch_and_its_children():
    svc = service()
    try:
        svc.warmup()
        svc.timeline = []
        with profiler():
            search(svc)
        timeline, svc.timeline = svc.timeline, None
    finally:
        svc.close()
    spans = profiling.recorded()
    dispatches = [r for r in spans if r.name == "serve.dispatch"]
    assert len(dispatches) == len(timeline) >= 1
    assert sum(e["reqs"] for e in timeline) == 6
    children = {"serve.tokenize", "serve.launch", "serve.readback",
                "serve.results"}
    for d, entry in zip(dispatches, timeline):
        kids = [r for r in spans if r.parent == "serve.dispatch"
                and d.start <= r.start and r.end <= d.end]
        assert set(names(kids)) == children
        # a Record's times are float Unix µs, whose step is 0.25 µs
        assert entry["exec_s"] == pytest.approx((d.end - d.start) * 1e-6,
                                                rel=0, abs=1e-6)
        device = sum(r.end - r.start for r in kids
                     if r.name in ("serve.launch", "serve.readback"))
        assert entry["device_s"] == pytest.approx(device * 1e-6, rel=0,
                                                  abs=1e-6)
        tokenize = sum(r.end - r.start for r in kids
                       if r.name == "serve.tokenize") * 1e-6
        assert entry["device_s"] + tokenize <= entry["exec_s"]
        assert entry["rows"] == 2 * entry["reqs"] and entry["wait_s"] >= 0


def test_timeline_records_while_tracing_is_off():
    svc = service()
    try:
        svc.timeline = []
        search(svc, 3)
        timeline, svc.timeline = svc.timeline, None
    finally:
        svc.close()
    assert profiling.recorded() == []
    assert sum(e["reqs"] for e in timeline) == 3
    for e in timeline:
        assert 0 < e["device_s"] < e["exec_s"] and e["wait_s"] >= 0
        assert not e["error"]


def test_a_wall_clock_step_moves_no_duration_and_no_timeline_time(
        monkeypatch):
    """The wall clock steps back an hour at every read: span durations,
    ``timeline``'s ``t``, ``wait_s`` and ``exec_s`` stay on
    ``time.monotonic``."""
    svc = service()
    wall = time.time_ns
    reads = iter(range(1, 1 << 30))
    try:
        svc.warmup()
        svc.timeline = []
        t_before = time.monotonic()
        monkeypatch.setattr(time, "time_ns",
                            lambda: wall() - next(reads) * 3_600 * 10**9)
        with profiler():
            search(svc, 3)
        monkeypatch.setattr(time, "time_ns", wall)
        t_after = time.monotonic()
        timeline, svc.timeline = svc.timeline, None
    finally:
        svc.close()
    assert sum(e["reqs"] for e in timeline) == 3
    for e in timeline:
        assert t_before <= e["t"] <= t_after
        assert 0 <= e["wait_s"] < t_after - t_before
        assert 0 < e["device_s"] < e["exec_s"] < t_after - t_before
    spans = profiling.recorded()
    assert spans and all(0 <= r.end - r.start < (t_after - t_before) * 1e6
                         for r in spans)


# ---- the loader, encoding and training ------------------------------------


def test_prefetch_records_produce_and_wait():
    with profiler():
        got = list(prefetch(iter(range(4)), depth=2))
    assert got == list(range(4))
    spans = profiling.recorded()
    assert names(spans).count("loader.produce") == 5  # 4 items, then the end
    assert names(spans).count("loader.wait") == 5
    produce = {r.thread for r in spans if r.name == "loader.produce"}
    assert produce != {threading.get_native_id()}


def test_encode_dataset_records_launch_and_readback_a_batch():
    model = tiny_model().eval()
    rng = np.random.default_rng(3)
    data = [{"id": str(i), "input_ids": rng.integers(4, 60, 5).tolist()}
            for i in range(10)]
    with profiler():
        reps, ids = encode_dataset(model, data, batch_size=4, max_len=8,
                                   pad_token_id=0, device="cpu")
    assert reps.shape[0] == 10 and ids == [str(i) for i in range(10)]
    spans = names(profiling.recorded())
    assert spans.count("encode.launch") == spans.count("encode.readback") == 3
    assert spans.count("loader.wait") == 4  # 3 batches, then the end


def train_batch(seed=5, n_q=2, n_p=4):
    rng = np.random.default_rng(seed)

    def part(n, s):
        return {"input_ids": rng.integers(4, 60, (n, s)),
                "attention_mask": np.ones((n, s), np.int64)}

    return {"query": part(n_q, 6), "passage": part(n_p, 8)}


@pytest.mark.parametrize("grad_cache", [False, True])
def test_dr_trainer_step_records_its_phases(grad_cache):
    args = TrainingArguments(per_device_train_batch_size=2,
                             grad_cache=grad_cache, gc_q_chunk_size=1,
                             gc_p_chunk_size=2)
    trainer = DRTrainer(tiny_model(), args, total_steps=4, device="cpu")
    with profiler():
        loss = trainer.train_step(train_batch())
    assert torch.isfinite(loss)
    # GradCache: the upload's forward, then its passes' forward and backward
    forward = ["train.forward"] * (2 if grad_cache else 1)
    assert names(profiling.recorded()) == forward + ["train.backward",
                                                     "train.optimizer"]
