"""Cross-encoder reranking of TREC runs (port of
``openmatch_tpu/retriever/reranker.py``).

For each (qid, did) of a run, the query and document texts (through the
data templates) are tokenized as one pair, scored by ``RRModel.score`` and
``relevance_logprob``, and merged into a new run. Pairs are sorted into
length buckets: each goes to the smallest bucket pad length that holds it,
a bucket is scored when it holds ``per_device_eval_batch_size`` pairs, and
the remainders are padded to a full batch with copies of their last pair.
Pad positions are masked, so a pair's score does not depend on its bucket.

The buckets are the multiples of 128 up to the pair length rounded up to
128 (``device_pair_len``), capped by an absolute position table (BERT); the
JAX package chose the 128 alignment for the TPU. The port keeps the same
buckets; their cost on the card is measured by ``chip_smoke.py``'s
``rerank`` phase (PERF.md).

The reranker runs on the model's device. With a ``mesh`` (one process
per rank, each running the same rerank: the JAX package's data-parallel
scoring) a batch holds ``per_device_eval_batch_size x dp`` pairs, each rank
scores its contiguous rows, and the scores are all-gathered, so every rank
returns what one process would.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..data.collators import pad_ids
from ..data.loader import prefetch
from ..data.tokenization import encode_pair_with_segments
from ..parallel.mesh import DATA_AXIS, all_gather, shard_batch
from ..templates import fill_template, find_all_markers

RankResult = Dict[str, Dict[str, float]]


def device_pair_len(max_len: int, max_positions: Optional[int] = None) -> int:
    """The pad length of pairs: ``max_len`` rounded up to a multiple of
    128, or ``max_len`` itself when that would pass ``max_positions`` (an
    absolute position table; T5's relative positions have no cap).
    Tokenization still truncates at ``max_len``."""
    n = -(-max_len // 128) * 128
    if max_positions is not None and n > max_positions:
        return max_len
    return n


def _model_max_positions(model) -> Optional[int]:
    """The absolute-position capacity of an RRModel's encoder, or None (T5)."""
    return getattr(model.encoder_config, "max_position_embeddings", None)


def bucket_lens(device_len: int) -> list:
    """The ascending pad lengths pairs are sorted into."""
    if device_len % 128 == 0 and device_len > 128:
        return list(range(128, device_len + 1, 128))
    return [device_len]


def encode_pair(tokenizer, qry, doc, max_len: int):
    """(input_ids, token_type_ids) of a (query, doc) pair."""
    return encode_pair_with_segments(tokenizer, qry, doc, max_len)


def collate_pairs(pairs, pad_len: int, max_len: int, pad_id: int) -> dict:
    """[(input_ids, token_type_ids)] -> numpy ``input_ids``,
    ``attention_mask`` and ``token_type_ids`` [n, pad_len]; segments are cut
    at ``max_len`` and zero-padded."""
    batch = pad_ids([ids for ids, _ in pairs], pad_len, pad_id)
    segs = np.zeros_like(batch["input_ids"])
    for i, (_, s) in enumerate(pairs):
        s = s[:max_len]
        segs[i, :len(s)] = s
    batch["token_type_ids"] = segs
    return batch


def score_batch(model, batch: dict, device) -> torch.Tensor:
    """log P(relevant) (or the raw score) of a numpy pair batch, as fp32
    on ``device``."""
    with torch.inference_mode():
        t = {k: torch.from_numpy(v).to(device, non_blocking=True)
             for k, v in batch.items()}
        scores = model.score(t["input_ids"], t["attention_mask"],
                             t["token_type_ids"])
        return model.relevance_logprob(scores).float()


class Reranker:
    def __init__(self, model, tokenizer, data_args, inference_args,
                 mesh=None):
        """``mesh``: this rank's ``parallel.mesh.Mesh`` for data-parallel
        scoring over its "data" axis."""
        self.model = model.eval()
        self.mesh = mesh
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer
        self.data_args = data_args
        self.args = inference_args
        self.batch_size = inference_args.per_device_eval_batch_size * (
            mesh.shape[DATA_AXIS] if mesh is not None else 1)
        self.max_len = data_args.q_max_len + data_args.p_max_len + 2
        self.device_len = device_pair_len(self.max_len,
                                          _model_max_positions(model))
        self.bucket_lens = bucket_lens(self.device_len)

    def _pair_stream(self, queries: Dict[str, dict], corpus: Dict[str, dict],
                     run: RankResult) -> Iterator[dict]:
        """(qid, did, tokenized pair) for each pair of the run whose query
        and document are in the data; the rest are skipped."""
        q_template = self.data_args.query_template
        d_template = self.data_args.doc_template
        q_markers = find_all_markers(q_template) if q_template else None
        d_markers = find_all_markers(d_template) if d_template else None
        for qid, docs in run.items():
            if qid not in queries:
                continue
            query_text = (
                fill_template(q_template, queries[qid], q_markers,
                              allow_not_found=True)
                if q_template else queries[qid].get("text", ""))
            for did in docs:
                if did not in corpus:
                    continue
                doc_text = (
                    fill_template(d_template, corpus[did], d_markers,
                                  allow_not_found=True)
                    if d_template else corpus[did].get("text", ""))
                ids, segs = encode_pair(self.tokenizer, query_text, doc_text,
                                        self.max_len)
                yield {"qid": qid, "did": did, "input_ids": ids,
                       "token_type_ids": segs}

    def _batches(self, pairs: Iterator[dict]):
        """(keys, numpy batch, n_valid) per full bucket, then the padded
        remainders."""
        pad_id = self.tokenizer.pad_token_id or 0

        def collate(features, pad_len):
            keys = [(f["qid"], f["did"]) for f in features]
            return keys, collate_pairs(
                [(f["input_ids"], f["token_type_ids"]) for f in features],
                pad_len, self.max_len, pad_id)

        buf: Dict[int, list] = {b: [] for b in self.bucket_lens}
        for f in pairs:
            b = next(x for x in self.bucket_lens if x >= len(f["input_ids"]))
            buf[b].append(f)
            if len(buf[b]) == self.batch_size:
                yield (*collate(buf[b], b), self.batch_size)
                buf[b] = []
        for b in self.bucket_lens:
            if buf[b]:
                n_valid = len(buf[b])
                fs = buf[b] + [buf[b][-1]] * (self.batch_size - n_valid)
                yield (*collate(fs, b), n_valid)

    def rerank(self, queries: Dict[str, dict], corpus: Dict[str, dict],
               run: RankResult, depth: Optional[int] = None) -> RankResult:
        """Re-score the top ``depth`` docs (by the run's score) of each
        query in ``run``."""
        if depth is not None:
            run = {qid: dict(sorted(docs.items(), key=lambda kv: kv[1],
                                    reverse=True)[:depth])
                   for qid, docs in run.items()}
        result: RankResult = {}
        stream = self._batches(self._pair_stream(queries, corpus, run))
        for keys, batch, n_valid in prefetch(stream, depth=4):
            if self.mesh is None:
                scores = score_batch(self.model, batch, self.device)
            else:
                scores = all_gather(score_batch(
                    self.model, shard_batch(batch, self.mesh), self.device),
                    self.mesh, DATA_AXIS)
            scores = scores[:n_valid].cpu().numpy()
            for (qid, did), s in zip(keys[:n_valid], scores):
                result.setdefault(qid, {})[did] = float(s)
        return result
