"""Retrieval and rerank serving: hold the models and the index on the
device, answer HTTP.

Port of ``openmatch_tpu/drivers/serve.py``:

    python -m openmatch_tpu_torch.drivers.serve \
        [--model_name_or_path ckpt_dr --encoded_save_path embeddings/] \
        [--rr_model_name_or_path ckpt_rr] \
        --port 8080 [--retrieve_depth 100] [--max_batch 64] [--device cuda] \
        [--search_n_segs 6]

    GET  /health
    POST /search   {"queries": ["...", ...], "k": 10}
      -> {"results": [[{"id": ..., "score": ...}, ...], ...]}
    POST /rerank   {"query": "...", "docs": [{"id": "d1", "text": "..."}, ...]}
      -> {"results": [{"id": ..., "score": ...}, ...]}   # descending

Either endpoint runs alone: ``--encoded_save_path`` enables /search,
``--rr_model_name_or_path`` enables /rerank; a disabled one answers 404.

Over N ranks (JAX's mesh ``Searcher`` on a host of several chips)::

    torchrun --nproc_per_node=N -m openmatch_tpu_torch.drivers.serve \
        --model_name_or_path ckpt_dr --encoded_save_path embeddings/ \
        --port 8080 [--search_partition docs|queries] [--search_n_segs 2]

every rank builds the mesh ``Searcher`` (``make_mesh(dp=N, tp=1)``) from
the host index, copying only its shard ("docs") or its replica's segments
("queries") to its card. Rank 0 alone encodes queries, runs the
coalescing queue and the HTTP front on ``--port`` (and /rerank, which
takes no mesh, as in JAX); before each search it sends the query reps to
the other ranks over ``parallel.mesh.ControlChannel``, and they run the
same search in a loop until "stop". An idle rank 0 sends a keep-alive
every ``KEEPALIVE_S``, well inside the groups' collective timeout.
SIGTERM or SIGINT to rank 0 stops the server and the followers (exit 0).
A rank that fails fails the search in flight (HTTP 500) and every later
one, and the server exits non-zero: rank 0 never searches alone.
/rerank scores as ``Reranker`` does (``RRModel.score`` then
``relevance_logprob``). ``--search_n_segs`` > 1 holds the index as that
many separate device allocations (the kernel path only: ``--search_method
auto`` on a CPU device refuses it, as the JAX driver does).

One worker thread per service owns the device: concurrent HTTP handlers
enqueue and wait, and the worker coalesces what arrived into batches of at
most ``max_batch`` queries or pairs. ``torch.inference_mode`` is
thread-local, so the worker enters it itself. ``close()`` stops the worker,
which releases what the service holds on the device.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..config import (ArgumentParser, DataArguments, InferenceArguments,
                      ModelArguments)
from ..data.collators import pad_ids
from ..models.dr_model import DRModel
from ..models.rr_model import RRModel
from ..ops.mips import Searcher
from ..parallel import mesh as mesh_mod
from ..parallel.mesh import (OP_KEEPALIVE, OP_SEARCH, OP_STOP,
                             ControlChannel, make_mesh, world_size)
from ..retriever.reranker import (_model_max_positions, bucket_lens,
                                  collate_pairs, device_pair_len, encode_pair,
                                  score_batch)
from ..utils.profiling import Span
from .common import (load_tokenizer, maybe_init_distributed, setup_logging,
                     split_device_flag)

logger = logging.getLogger(__name__)


class OverloadedError(RuntimeError):
    """Bounded request queue is full: callers get HTTP 503."""


class _QueueService:
    """Single-consumer work queue with cross-request coalescing (copied
    from the JAX package's host layer). Concurrent handlers enqueue; the
    worker gathers whatever arrived, waiting up to ``coalesce_window_s``
    for stragglers while under ``max_batch`` rows, into one dispatch. The
    queue holds at most ``max_queue`` pending requests; beyond it
    submitters fail fast with OverloadedError.

    Subclasses define ``_rows(args)`` (rows a request contributes) and
    ``_run_many(requests)`` (batch-execute, one result per request), and
    may define ``_idle()`` (run when nothing arrived for ``idle_s``) and
    ``_on_close()``. Once ``failed`` is set, every request fails at once.

    Each dispatch is a ``serve.dispatch`` span (``utils.profiling``
    ``Span``: timed whether tracing is on or not) over the subclass's own
    spans. Assigning a list to ``timeline`` records one dict a dispatch,
    read from that span: ``t`` (its start on ``time.monotonic``),
    ``wait_s`` (the oldest request's wait for it), ``exec_s`` (the span),
    ``device_s`` (what ``_run_many`` adds to ``_exec_device_s``; the
    retrieval service's ``serve.launch`` and ``serve.readback`` spans),
    ``rows``, ``reqs`` and ``error``."""

    max_queue = 256
    coalesce_window_s = 0.002
    idle_s: Optional[float] = None  # None: wait for work without end
    failed: Optional[BaseException] = None

    def _start_worker(self):
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self.stats = {"dispatch_groups": 0, "requests": 0, "max_coalesced": 0}
        self.timeline = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        with torch.inference_mode():
            while self._serve_one_group():
                pass

    def close(self):
        """Stop the worker thread (after the requests queued before this
        call); the service then holds nothing on the device."""
        self._queue.put(None)
        self._thread.join()

    def _idle(self):
        pass

    def _on_close(self):
        pass

    def _serve_one_group(self) -> bool:
        """Serve one coalesced group; False once ``close`` was called."""
        try:
            first = self._queue.get(timeout=self.idle_s)
        except queue.Empty:
            self._idle()
            return True
        if first is None:
            self._on_close()
            return False
        items = [first]
        deadline = time.monotonic() + self.coalesce_window_s
        while sum(self._rows(args) for args, _, _ in items) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:  # close(): serve what was taken, then stop
                self._queue.put(None)
                break
            items.append(item)
        self.stats["dispatch_groups"] += 1
        self.stats["requests"] += len(items)
        self.stats["max_coalesced"] = max(self.stats["max_coalesced"],
                                          len(items))
        timeline = self.timeline  # a reader may swap it at any time
        self._exec_device_s = 0.0  # _run_many accumulates
        with Span("serve.dispatch") as dispatch:
            try:
                if self.failed is not None:
                    raise RuntimeError(f"the service failed: {self.failed}")
                results = self._run_many([args for args, _, _ in items])
                for (_, reply, _), res in zip(items, results):
                    reply.put(("ok", res))
                err = False
            except Exception as e:  # the worker must outlive a failed batch
                for _, reply, _ in items:
                    reply.put(("error", f"{type(e).__name__}: {e}"))
                err = True
        if timeline is not None:
            timeline.append({
                "t": dispatch.t0,
                "wait_s": dispatch.t0 - min(enq for _, _, enq in items),
                "exec_s": dispatch.seconds,
                "device_s": self._exec_device_s,
                "rows": sum(self._rows(args) for args, _, _ in items),
                "reqs": len(items), "error": err,
            })
        return True

    def _submit(self, *args):
        reply: "queue.Queue" = queue.Queue()
        try:
            self._queue.put((args, reply, time.monotonic()), block=False)
        except queue.Full:
            raise OverloadedError(
                f"request queue full ({self.max_queue} pending)") from None
        status, payload = reply.get()
        if status == "error":
            raise RuntimeError(payload)
        return payload


class RetrievalService(_QueueService):
    """Query encoding plus exact search behind a single-consumer queue.

    With a ``channel`` (rank 0 of a mesh ``Searcher``'s ranks) every
    search's reps go to the other ranks first, a keep-alive goes every
    ``parallel.mesh.KEEPALIVE_S`` while idle, and ``close`` sends "stop".
    A failure on the channel or in a search over the ranks sets
    ``failed`` (the ranks are out of step) and calls ``on_failure``."""

    on_failure = None  # called with the error once ``failed`` is set

    def __init__(self, model, tokenizer, searcher: Searcher, doc_ids,
                 q_max_len: int, max_batch: int,
                 channel: Optional[ControlChannel] = None):
        """The model runs on the searcher's device, where the index is."""
        self.model = model
        self.tokenizer = tokenizer
        self.doc_ids = doc_ids
        self.searcher = searcher
        self.q_max_len = q_max_len
        self.max_batch = max_batch
        self.device = searcher.device
        self.channel = channel
        if channel is not None:
            self.idle_s = mesh_mod.KEEPALIVE_S
        self._start_worker()

    def _fail(self, err: BaseException):
        if self.failed is None:
            self.failed = err
            logger.error("serving over ranks failed: %s: %s",
                         type(err).__name__, err)
            if self.on_failure is not None:
                self.on_failure(err)

    def _over_ranks(self, op: int, reps=None):
        """Send ``op`` to the other ranks, then run a search's share on
        this rank; a failure fails the service and is raised."""
        try:
            self.channel.send(op, reps)
            return self.searcher.search(reps) if op == OP_SEARCH else None
        except Exception as e:
            self._fail(e)
            raise

    def _idle(self):
        if self.channel is not None and self.failed is None:
            try:
                self._over_ranks(OP_KEEPALIVE)
            except Exception:
                pass  # recorded in ``failed``

    def _on_close(self):
        if self.channel is not None and self.failed is None:
            self._over_ranks(OP_STOP)

    def warmup(self):
        self.search(["warmup"], k=1)

    @staticmethod
    def _rows(args):
        return len(args[0])

    def encode_queries(self, queries) -> torch.Tensor:
        """At most ``max_batch`` query strings -> reps [n, D] on the device.
        The batch is padded to ``max_batch`` rows, so a query's
        representation does not depend on what it was batched with."""
        return self._encode(self._tokenize(queries), len(queries))

    def _tokenize(self, queries) -> dict:
        """Query strings -> padded host arrays of ``max_batch`` rows."""
        enc = [
            self.tokenizer.encode_plus(
                q, truncation="only_first", max_length=self.q_max_len,
                padding=False, return_attention_mask=False,
                return_token_type_ids=False,
            )["input_ids"]
            for q in queries
        ]
        enc = enc + [enc[-1]] * (self.max_batch - len(enc))
        return pad_ids(enc, self.q_max_len, self.tokenizer.pad_token_id or 0)

    def _encode(self, batch: dict, n: int) -> torch.Tensor:
        """``_tokenize``'s arrays -> the first ``n`` reps on the device."""
        ids = torch.from_numpy(batch["input_ids"]).to(self.device)
        mask = torch.from_numpy(batch["attention_mask"]).to(self.device)
        return self.model.encode_query(ids, mask)[:n]

    def _search_rows(self, queries):
        """One device dispatch per max_batch chunk of the merged queries;
        returns (scores [n, K], indices [n, K]) at the searcher's depth."""
        s_out, i_out = [], []
        for start in range(0, len(queries), self.max_batch):
            chunk = queries[start:start + self.max_batch]
            with Span("serve.tokenize"):
                batch = self._tokenize(chunk)
            with Span("serve.launch") as launch:
                reps = self._encode(batch, len(chunk))
                if self.channel is None:
                    scores, indices = self.searcher.search(reps)
                else:
                    scores, indices = self._over_ranks(
                        OP_SEARCH, reps.to(self.searcher.dtype).contiguous())
            with Span("serve.readback") as readback:
                s_out.append(scores.float().cpu().numpy())
                i_out.append(indices.cpu().numpy())
            self._exec_device_s += launch.seconds + readback.seconds
        return np.concatenate(s_out), np.concatenate(i_out)

    def _run_many(self, requests):
        """requests: [(queries, k)], coalesced into shared device batches."""
        merged = [q for queries, _ in requests for q in queries]
        scores, indices = self._search_rows(merged)
        results, row = [], 0
        with Span("serve.results"):
            for queries, k in requests:
                results.append([
                    [
                        {"id": self.doc_ids[int(d)], "score": float(s)}
                        for d, s in zip(indices[row + r, :k],
                                        scores[row + r, :k])
                        if np.isfinite(s)
                    ]
                    for r in range(len(queries))
                ])
                row += len(queries)
        return results

    def search(self, queries, k: int = 10):
        if not queries:
            return []
        return self._submit(queries, k)


class RerankService(_QueueService):
    """Cross-encoder pair scoring behind a single-consumer queue: the pairs
    of the coalesced requests are flattened and scored in chunks of
    ``max_batch``, each padded to ``max_batch`` rows and to the smallest of
    ``Reranker``'s bucket pad lengths that holds its longest pair."""

    def __init__(self, model, tokenizer, q_max_len: int, p_max_len: int,
                 max_batch: int):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer
        self.max_len = q_max_len + p_max_len + 2
        self.bucket_lens = bucket_lens(device_pair_len(
            self.max_len, _model_max_positions(model)))
        self.max_batch = max_batch
        self._start_worker()

    def warmup(self):
        """Score one full batch at every pad length a chunk can take, then
        one request through the tokenizer path."""
        with torch.inference_mode():
            for pad_len in self.bucket_lens:
                zeros = np.zeros((self.max_batch, pad_len), np.int64)
                score_batch(self.model, {
                    "input_ids": zeros, "attention_mask": zeros + 1,
                    "token_type_ids": zeros}, self.device).cpu()
        self.rerank("warmup", [{"id": "w", "text": "warmup"}])

    @staticmethod
    def _rows(args):
        return len(args[1])

    def _score_pairs(self, flat_pairs) -> np.ndarray:
        """[(query, doc text)] merged across requests -> scores [n]; one
        device dispatch per ``max_batch`` chunk."""
        pad_id = self.tokenizer.pad_token_id or 0
        scores = np.empty(len(flat_pairs), np.float32)
        for start in range(0, len(flat_pairs), self.max_batch):
            chunk = flat_pairs[start:start + self.max_batch]
            pairs = [encode_pair(self.tokenizer, q, t, self.max_len)
                     for q, t in chunk]
            pairs = pairs + [pairs[-1]] * (self.max_batch - len(chunk))
            longest = max(len(ids) for ids, _ in pairs)
            pad_len = next(b for b in self.bucket_lens if b >= longest)
            batch = collate_pairs(pairs, pad_len, self.max_len, pad_id)
            t_dev = time.monotonic()  # device span: upload, score, readback
            out = score_batch(self.model, batch, self.device)
            scores[start:start + len(chunk)] = out[:len(chunk)].cpu().numpy()
            self._exec_device_s += time.monotonic() - t_dev
        return scores

    def _run_many(self, requests):
        """requests: [(query, docs)]; each answer is its docs by descending
        score."""
        flat = [(q, d["text"]) for q, docs in requests for d in docs]
        scores = self._score_pairs(flat)
        results, row = [], 0
        for _, docs in requests:
            s = scores[row:row + len(docs)]
            order = np.argsort(-s, kind="stable")
            results.append([{"id": docs[int(i)]["id"],
                             "score": float(s[int(i)])} for i in order])
            row += len(docs)
        return results

    def rerank(self, query: str, docs):
        if not docs:
            return []
        return self._submit(query, docs)


def make_handler(service, default_k: int, rerank_service=None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                payload = {"status": "ok", "endpoints": (
                    (["/search"] if service else [])
                    + (["/rerank"] if rerank_service else []))}
                if service:
                    payload["num_docs"] = service.searcher.n_docs
                self._send(200, payload)
            else:
                self._send(404, {"error": "unknown path"})

        def _handle_search(self, req):
            if service is None:
                self._send(404, {"error": "/search not enabled (no "
                                          "--encoded_save_path)"})
                return
            queries = req.get("queries")
            if not isinstance(queries, list) or not all(
                    isinstance(q, str) for q in queries):
                self._send(400, {"error": "'queries' must be a list of "
                                          "strings"})
                return
            try:
                k = int(req.get("k", default_k))
            except (TypeError, ValueError):
                self._send(400, {"error": "'k' must be an integer"})
                return
            max_k = service.searcher.k
            if k < 1 or k > max_k:
                self._send(400, {"error": f"'k' must be in [1, {max_k}] "
                                          "(the index was built with "
                                          f"retrieve_depth={max_k})"})
                return
            self._send(200, {"results": service.search(queries, k=k)})

        def _handle_rerank(self, req):
            if rerank_service is None:
                self._send(404, {"error": "/rerank not enabled (no "
                                          "--rr_model_name_or_path)"})
                return
            query, docs = req.get("query"), req.get("docs")
            if not isinstance(query, str):
                self._send(400, {"error": "'query' must be a string"})
                return
            if (not isinstance(docs, list) or not docs
                    or not all(isinstance(d, dict) and "id" in d
                               and isinstance(d.get("text"), str)
                               for d in docs)):
                self._send(400, {"error": "'docs' must be a non-empty list "
                                          "of {'id': ..., 'text': str} "
                                          "objects"})
                return
            self._send(200, {"results": rerank_service.rerank(query, docs)})

        def do_POST(self):
            routes = {"/search": self._handle_search,
                      "/rerank": self._handle_rerank}
            handler = routes.get(self.path)
            if handler is None:
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                handler(req)
            except json.JSONDecodeError:
                self._send(400, {"error": "invalid JSON body"})
            except OverloadedError as e:
                self._send(503, {"error": str(e)})
            except Exception as e:  # the server thread must keep answering
                self._send(500, {"error": str(e)})

    return Handler


def load_searcher(data_args, infer_args, device, mesh=None):
    """(Searcher, doc ids) over ``--encoded_save_path``: on ``device``, or
    over ``mesh``'s ranks from the bf16 index cast on the host (JAX
    ``build_service``), so each rank copies only its part to its card and
    the whole index is never staged on one."""
    from ..retriever.retriever import Retriever, build_searcher

    retriever = Retriever.from_embeddings(None, data_args, infer_args, 0,
                                          device, mesh)
    index = retriever.index_tensor(device="cpu" if mesh is not None
                                   else None)
    retriever.doc_embeddings = None  # the Searcher holds the copy we keep
    searcher = build_searcher(index, infer_args, infer_args.retrieve_depth,
                              mesh)
    return searcher, retriever.doc_ids


def build_service(model_args, data_args, infer_args, max_batch: int,
                  device, tokenizer=None, mesh=None) -> RetrievalService:
    """The service over ``--encoded_save_path``; ``tokenizer`` defaults to
    ``load_tokenizer(model_args)``. With a ``mesh`` this is rank 0's
    service: its searches go over the ranks through a ``ControlChannel``
    (the other ranks run ``follow``)."""
    if tokenizer is None:
        tokenizer = load_tokenizer(model_args)
    model = DRModel.build(model_args, device=device)
    searcher, doc_ids = load_searcher(data_args, infer_args, device, mesh)
    channel = (None if mesh is None else
               ControlChannel(mesh, searcher.dim, searcher.dtype))
    return RetrievalService(model, tokenizer, searcher, doc_ids,
                            q_max_len=data_args.q_max_len,
                            max_batch=max_batch, channel=channel)


def follow(searcher: Searcher, channel: ControlChannel) -> int:
    """The loop of a rank other than 0: each "search" from rank 0 runs
    ``searcher.search`` on the reps sent, a keep-alive does nothing, and
    "stop" returns; returns the searches run."""
    n = 0
    with torch.inference_mode():
        while True:
            op, reps = channel.receive()
            if op == OP_STOP:
                return n
            if op == OP_SEARCH:
                searcher.search(reps)
                n += 1


def build_rerank_service(rr_path: str, data_args, max_batch: int, device,
                         tokenizer=None) -> RerankService:
    """The /rerank service over the cross-encoder at ``rr_path``;
    ``tokenizer`` defaults to ``load_tokenizer`` of that path."""
    rr_args = ModelArguments(model_name_or_path=rr_path)
    if tokenizer is None:
        tokenizer = load_tokenizer(rr_args)
    model = RRModel.build(rr_args, tokenizer=tokenizer, device=device)
    return RerankService(model, tokenizer, q_max_len=data_args.q_max_len,
                         p_max_len=data_args.p_max_len, max_batch=max_batch)


class ServingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a production listen backlog: the default
    of 5 drops SYNs from concurrent one-connection-per-request clients,
    and each dropped SYN costs a 1 s retransmit."""

    request_queue_size = 1024


def _set_handlers(handlers: dict) -> dict:
    """Install ``{signal: handler}``; returns the handlers they replace
    (none off the main thread, where the caller stops the server)."""
    previous = {}
    for sig, handler in handlers.items():
        try:
            previous[sig] = signal.signal(sig, handler)
        except ValueError:
            pass
    return previous


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def _follower_main(data_args, infer_args, device, mesh) -> None:
    """A rank other than 0: the mesh Searcher, then ``follow`` until rank
    0 sends "stop". Signals are left to rank 0, which sends "stop"."""
    if not infer_args.encoded_save_path:
        logger.info("rank %d: nothing to serve over ranks (/rerank runs on "
                    "rank 0)", mesh.rank)
        return
    previous = _set_handlers({signal.SIGTERM: signal.SIG_IGN,
                              signal.SIGINT: signal.SIG_IGN})
    try:
        searcher, _ = load_searcher(data_args, infer_args, device, mesh)
        n = follow(searcher, ControlChannel(mesh, searcher.dim,
                                            searcher.dtype))
    finally:
        _set_handlers(previous)
    logger.info("rank %d: stopped after %d searches", mesh.rank, n)


def main(argv=None, tokenizer=None, rr_tokenizer=None):
    """``tokenizer`` / ``rr_tokenizer``: the retrieval and the rerank
    model's tokenizers, by default ``load_tokenizer`` of each path. Under
    a launcher of several ranks, rank 0 serves and the others follow (the
    module docstring); ``main`` returns on every rank once rank 0 was
    stopped, and raises on rank 0 when a rank failed."""
    setup_logging()
    device, rest = split_device_flag(argv)
    extra = argparse.ArgumentParser(allow_abbrev=False)
    extra.add_argument("--port", type=int, default=8080)
    extra.add_argument("--max_batch", type=int, default=64)
    extra.add_argument("--rr_model_name_or_path", default=None,
                       help="cross-encoder checkpoint enabling POST /rerank")
    extra_args, rest = extra.parse_known_args(rest)
    model_args, data_args, infer_args = ArgumentParser(
        (ModelArguments, DataArguments, InferenceArguments)).parse(rest)
    maybe_init_distributed(device)
    mesh = None
    if world_size() > 1:
        mesh = make_mesh(world_size(), 1, device)
        if mesh.rank != 0:
            return _follower_main(data_args, infer_args, device, mesh)
    service = rerank_service = None
    if infer_args.encoded_save_path:
        service = build_service(model_args, data_args, infer_args,
                                extra_args.max_batch, device, tokenizer,
                                mesh)
        service.warmup()
    if extra_args.rr_model_name_or_path:
        rerank_service = build_rerank_service(
            extra_args.rr_model_name_or_path, data_args, extra_args.max_batch,
            device, rr_tokenizer)
        rerank_service.warmup()
    if service is None and rerank_service is None:
        raise ValueError("nothing to serve: pass --encoded_save_path "
                         "(retrieval) and/or --rr_model_name_or_path "
                         "(rerank)")
    server = ServingHTTPServer(
        ("0.0.0.0", extra_args.port),
        make_handler(service, infer_args.retrieve_depth, rerank_service))
    endpoints = ((["/search"] if service else [])
                 + (["/rerank"] if rerank_service else []))
    print(f"serving {'+'.join(endpoints)} on :{extra_args.port}"
          + (f" over {mesh.size('world')} ranks" if mesh else ""))
    if mesh is None:
        server.serve_forever()
        return
    # over ranks: answer what is in flight, then stop the followers
    server.daemon_threads = False  # server_close() joins the handlers
    if service is not None:
        service.on_failure = lambda err: threading.Thread(
            target=server.shutdown, daemon=True).start()
    # SIGTERM (a launcher's stop) ends serve_forever as SIGINT does
    previous = _set_handlers({signal.SIGTERM: _interrupt})
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        _set_handlers(previous)
        server.server_close()
        for s in (service, rerank_service):
            if s is not None:
                s.close()
    if service is not None and service.failed is not None:
        raise RuntimeError("serving over ranks failed: a rank is out of "
                           "step") from service.failed


if __name__ == "__main__":
    main()
