"""Serving under load: /search and /rerank through the live HTTP surface.

Twin of ``scripts/perf/serve_load.py``:

    python -m openmatch_tpu_torch.perf.serve_load --mode search
        [--n-docs 1000000] [--concurrency 32] [--duration 30]
        [--coalesce-ms 2] [--max-batch 64] [--depth 100]
        [--docs-per-req 16] [--port 18321] [--shallow-backlog]
        [--device cpu]

It serves the one-card services of ``drivers/serve.py`` (the coalescing
queue and the HTTP front, as the TPU script serves the JAX package's) and
drives them with ``concurrency`` closed-loop clients for ``duration``
seconds after a short warm pass: p50 / p95 / p99 latency, QPS and the
coalescing stats as one JSON line, then the dispatch timeline's exec,
host and queue-wait percentiles and the stalls (exec > 400 ms). The model
is a seeded random-weight BERT-base (bf16; serving cost depends on shapes,
not values; a 1-layer 16-wide one on the CPU, as the TPU script's
``--cpu``) and the corpus seeded unit rows in bf16, made on the device.
The tokenizer maps the script's ``term<i>`` words to ids of a 205-word
vocabulary, as its BERT tokenizer does. ``--port 0`` takes a free port.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from ..models.bert import BertConfig
from . import add_device_arg, device_of, normal

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
    f"term{i}" for i in range(200)]


class TermTokenizer:
    """The script's BERT tokenizer on its own vocabulary: one id per word
    ([UNK] otherwise), [CLS] a [SEP] (pairs [CLS] a [SEP] b [SEP],
    truncated longest first, segments 0 then 1), pad id 0."""

    pad_token_id, cls_token_id, sep_token_id = 0, 2, 3

    def __init__(self):
        self.ids = {w: i for i, w in enumerate(VOCAB)}

    def _words(self, text: str) -> list:
        return [self.ids.get(w, 1) for w in text.split()]

    def encode(self, text, add_special_tokens: bool = True) -> list:
        ids = self._words(text)
        return (self.build_inputs_with_special_tokens(ids)
                if add_special_tokens else ids)

    def encode_plus(self, text, max_length=None, return_token_type_ids=False,
                    **_):
        if isinstance(text, tuple):
            a, b = (self._words(t) for t in text)
            while max_length is not None and len(a) + len(b) > max_length - 3:
                (a if len(a) >= len(b) else b).pop()
            out = {"input_ids": self.build_inputs_with_special_tokens(a, b)}
            if return_token_type_ids:
                out["token_type_ids"] = \
                    self.create_token_type_ids_from_sequences(a, b)
            return out
        ids = self._words(text)
        if max_length is not None:
            ids = ids[:max_length - 2]
        return {"input_ids": self.build_inputs_with_special_tokens(ids)}

    def num_special_tokens_to_add(self, pair: bool = False) -> int:
        return 3 if pair else 2

    def build_inputs_with_special_tokens(self, a, b=None):
        out = [self.cls_token_id] + list(a) + [self.sep_token_id]
        return out if b is None else out + list(b) + [self.sep_token_id]

    def create_token_type_ids_from_sequences(self, a, b):
        return [0] * (len(a) + 2) + [1] * (len(b) + 1)


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(
        prog="python -m openmatch_tpu_torch.perf.serve_load",
        description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["search", "rerank"], default="search")
    ap.add_argument("--n-docs", type=int, default=1_000_000)
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--coalesce-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--depth", type=int, default=100, help="searcher k")
    ap.add_argument("--docs-per-req", type=int, default=16, help="rerank")
    ap.add_argument("--port", type=int, default=18321)
    ap.add_argument("--warm-s", type=float, default=2.0)
    ap.add_argument("--shallow-backlog", action="store_true",
                    help="the stock 5-deep listen backlog, for A/B")
    add_device_arg(ap)
    return ap.parse_args(argv)


def percentiles(lat_ms) -> tuple:
    lat = np.sort(np.asarray(lat_ms))
    return tuple(float(lat[min(len(lat) - 1, int(p * len(lat)))])
                 for p in (0.50, 0.95, 0.99))


def run_clients(port: int, endpoint: str, payloads, concurrency: int,
                duration_s: float) -> tuple:
    """Closed-loop clients: each thread sends one request, waits, repeats.
    Returns (latencies_ms, errors, wall_s)."""
    lats, errors = [], [0]
    lock = threading.Lock()
    stop = time.monotonic() + duration_s

    def client(i):
        k = 0
        while time.monotonic() < stop:
            body = json.dumps(payloads[(i + k) % len(payloads)]).encode()
            k += 1
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{endpoint}", data=body,
                headers={"Content-Type": "application/json"})
            t0 = time.monotonic()
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    r.read()
                with lock:
                    lats.append((time.monotonic() - t0) * 1e3)
            except Exception:
                with lock:
                    errors[0] += 1

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return lats, errors[0], time.monotonic() - t0


def build(args, dev: torch.device):
    """(service, payloads, endpoint) of ``args.mode``."""
    from ..drivers.serve import RerankService, RetrievalService
    from ..models.dr_model import DRModel
    from ..models.rr_model import RRModel
    from ..ops.mips import Searcher

    cfg = (BertConfig(vocab_size=256) if dev.type == "cuda" else
           BertConfig(vocab_size=256, hidden_size=16, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=32))
    tok = TermTokenizer()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if args.mode == "search":
            model = DRModel(cfg, normalize=True, dtype=torch.bfloat16)
        else:
            model = RRModel(cfg, head_in_dim=cfg.hidden_size,
                            dtype=torch.bfloat16)
    model = model.to(dev).eval()
    if args.mode == "search":
        reps = normal((args.n_docs, cfg.hidden_size), 0, dev, torch.float32)
        reps /= torch.linalg.vector_norm(reps, dim=1, keepdim=True)
        searcher = Searcher(reps.to(torch.bfloat16), k=args.depth)
        del reps
        service = RetrievalService(model, tok, searcher,
                                   [f"d{i}" for i in range(args.n_docs)],
                                   q_max_len=32, max_batch=args.max_batch)
        payloads = [{"queries": [f"term{i % 200} term{(7 * i) % 200}"],
                     "k": 10} for i in range(512)]
        return service, payloads, "/search"
    service = RerankService(model, tok, q_max_len=32, p_max_len=128,
                            max_batch=args.max_batch)
    payloads = [{"query": f"term{i % 200}",
                 "docs": [{"id": f"d{j}",
                           "text": f"term{(i + j) % 200} " * 20}
                          for j in range(args.docs_per_req)]}
                for i in range(64)]
    return service, payloads, "/rerank"


def main(argv: Optional[List[str]] = None) -> dict:
    from ..drivers.serve import (ServingHTTPServer, _QueueService,
                                 make_handler)

    args = parse(argv)
    dev = device_of(args)
    _QueueService.coalesce_window_s = args.coalesce_ms / 1e3
    service, payloads, endpoint = build(args, dev)
    t0 = time.time()
    service.warmup()
    print(f"warmup: {time.time() - t0:.1f}s", flush=True)
    search = service if endpoint == "/search" else None
    handler = make_handler(search, default_k=10, rerank_service=(
        None if search is not None else service))
    server_cls = (ThreadingHTTPServer if args.shallow_backlog
                  else ServingHTTPServer)
    httpd = server_cls(("127.0.0.1", args.port), handler)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        # a short warm pass so caches settle before the measurement
        run_clients(port, endpoint, payloads, min(4, args.concurrency),
                    args.warm_s)
        for k in service.stats:
            service.stats[k] = 0
        service.timeline = []  # per-dispatch wait / exec / device record
        lats, errors, wall = run_clients(port, endpoint, payloads,
                                         args.concurrency, args.duration)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    if not lats:
        raise SystemExit(f"no successful requests ({errors} errors)")
    p50, p95, p99 = percentiles(lats)
    st = service.stats
    out = {"mode": args.mode, "n_docs": args.n_docs, "device": dev.type,
           "concurrency": args.concurrency, "coalesce_ms": args.coalesce_ms,
           "max_batch": args.max_batch, "requests": len(lats),
           "errors": errors, "qps": len(lats) / wall, "p50_ms": p50,
           "p95_ms": p95, "p99_ms": p99,
           "avg_coalesced_per_dispatch": st["requests"]
           / max(st["dispatch_groups"], 1),
           "max_coalesced": st["max_coalesced"]}
    print(json.dumps(out), flush=True)
    tl = service.timeline or []
    if tl:
        execs = np.array([d["exec_s"] for d in tl]) * 1e3
        devs = np.array([d["device_s"] for d in tl]) * 1e3
        waits = np.array([d["wait_s"] for d in tl]) * 1e3
        out["dispatches"] = len(tl)
        out["exec_ms_p50_p95_max"] = [float(np.percentile(execs, 50)),
                                      float(np.percentile(execs, 95)),
                                      float(execs.max())]
        out["host_ms_p50"] = float(np.percentile(execs - devs, 50))
        out["wait_ms_p50_p95_max"] = [float(np.percentile(waits, 50)),
                                      float(np.percentile(waits, 95)),
                                      float(waits.max())]
        stalls = [d for d in tl if d["exec_s"] > 0.4]
        out["stalls"] = len(stalls)
        print(f"dispatches={len(tl)}  exec p50/p95/max = "
              f"{out['exec_ms_p50_p95_max'][0]:.1f}/"
              f"{out['exec_ms_p50_p95_max'][1]:.1f}/"
              f"{out['exec_ms_p50_p95_max'][2]:.1f} ms  host(exec-device) "
              f"p50 = {out['host_ms_p50']:.1f} ms  queue-wait p50/p95/max "
              f"= {out['wait_ms_p50_p95_max'][0]:.1f}/"
              f"{out['wait_ms_p50_p95_max'][1]:.1f}/"
              f"{out['wait_ms_p50_p95_max'][2]:.1f} ms", flush=True)
        print(f"stalls (exec > 400 ms): {len(stalls)}", flush=True)
        for d in stalls[:20]:
            print(f"  t={d['t'] - tl[0]['t']:7.2f}s exec="
                  f"{d['exec_s'] * 1e3:6.0f} ms device="
                  f"{d['device_s'] * 1e3:6.0f} ms rows={d['rows']:3d}",
                  flush=True)
    return out


if __name__ == "__main__":
    main()
