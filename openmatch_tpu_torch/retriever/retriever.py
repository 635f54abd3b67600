"""Dense retrieval runtime: encode corpus and queries, exact top-k, results.

Port of ``Retriever`` and ``SuccessiveRetriever`` from
``openmatch_tpu/retriever/retriever.py``. ``Retriever``'s index is the
corpus embedding matrix held on the device by a ``Searcher``
(``ops/mips.py``): the kernel path on a CUDA device, the plain path on the
CPU. With a ``mesh`` (one process per rank, each running the same
retrieval) the Searcher is the mesh's, partitioned by ``search_partition``:
"docs" gives each rank its row shard (only the shard is copied to its
device), "queries" the whole index. ``SuccessiveRetriever`` holds one
embedding shard at a time.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.mips import Searcher, exact_search
from ..utils.trec import merge_retrieval_results_by_score
from .encoder import (encode_dataset, list_shards, load_embeddings,
                      save_embeddings, shard_path)

logger = logging.getLogger(__name__)

RankResult = Dict[str, Dict[str, float]]

# InferenceArguments.search_method values -> the port's Searcher methods
SEARCH_METHODS = {
    "auto": "auto", "kernel": "kernel", "plain": "plain",
    "pallas": "kernel",  # the fused-kernel path of the JAX package
    "pyramid": "plain", "hier2": "plain", "hier": "plain", "topk": "plain",
    "approx": "plain",
}


def searcher_method(inference_args) -> str:
    """The ``Searcher`` method for ``inference_args.search_method``. Every
    JAX name is taken; "approx" runs the plain path's full scores with an
    exact top-k, which meets the 0.99 recall of JAX's ``approx_max_k``."""
    name = getattr(inference_args, "search_method", "auto")
    if name not in SEARCH_METHODS:
        raise ValueError(f"search_method {name!r} is not available in the "
                         f"PyTorch port (one of {sorted(SEARCH_METHODS)})")
    return SEARCH_METHODS[name]


def build_searcher(index: torch.Tensor, inference_args, k: int,
                   mesh=None) -> Searcher:
    """The ``Searcher`` the inference arguments ask for over ``index``:
    ``search_method`` and ``search_n_segs``, and with a ``mesh``
    ``search_partition``."""
    return Searcher(index, k=k, method=searcher_method(inference_args),
                    n_segs=getattr(inference_args, "search_n_segs", 1),
                    mesh=mesh,
                    partition=getattr(inference_args, "search_partition",
                                      "docs"))


def _to_result(scores: np.ndarray, indices: np.ndarray, qids: List[str],
               doc_ids) -> RankResult:
    out: RankResult = {}
    for r, qid in enumerate(qids):
        row = {}
        for s, i in zip(scores[r], indices[r]):
            if np.isfinite(s):
                row[doc_ids[int(i)]] = float(s)
        out[qid] = row
    return out


class Retriever:
    def __init__(self, model, data_args, inference_args, pad_token_id: int,
                 device: Optional[torch.device] = None, mesh=None):
        """``device`` holds the index and runs the encoder; by default the
        device of the model's parameters. ``mesh``: this rank's
        ``parallel.mesh.Mesh``, for a Searcher over the ranks."""
        self.model = model
        self.data_args = data_args
        self.args = inference_args
        self.pad_token_id = pad_token_id
        self.mesh = mesh
        self.device = torch.device(device) if device is not None \
            else next(model.parameters()).device
        self.doc_embeddings: Optional[np.ndarray] = None
        self.doc_ids: List[str] = []
        self._corpus_gen = 0  # bumped on corpus (re)assignment
        self._searcher = None
        self._searcher_key = None

    # ---- corpus side ----------------------------------------------------

    def _encode(self, dataset, max_len: int, is_query: bool):
        return encode_dataset(
            self.model, dataset,
            batch_size=self.args.per_device_eval_batch_size,
            max_len=max_len, pad_token_id=self.pad_token_id,
            is_query=is_query, device=self.device)

    def _save(self, emb, ids, save_dir, kind, shard_index):
        if save_dir:
            save_embeddings(emb, ids, shard_path(save_dir, kind, shard_index),
                            num_shards=getattr(self.data_args,
                                               "encode_num_shard", None))

    def encode_corpus(self, corpus_dataset: Iterable[dict],
                      save_dir: Optional[str] = None,
                      shard_index: int = 0) -> Tuple[np.ndarray, List[str]]:
        emb, ids = self._encode(corpus_dataset, self.data_args.p_max_len,
                                is_query=False)
        self._save(emb, ids, save_dir, "corpus", shard_index)
        self.doc_embeddings, self.doc_ids = emb, ids
        self._corpus_gen += 1  # invalidate the cached Searcher
        return emb, ids

    def load_corpus_shards(self, save_dir: str):
        embs, ids = [], []
        for path in list_shards(save_dir, "corpus"):
            e, i = load_embeddings(path)
            embs.append(e)
            ids.extend(i)
        self.doc_embeddings = np.concatenate(embs, axis=0)
        self.doc_ids = ids
        self._corpus_gen += 1  # invalidate the cached Searcher
        return self.doc_embeddings, self.doc_ids

    # ---- query side -----------------------------------------------------

    def encode_queries(self, query_dataset: Iterable[dict],
                       save_dir: Optional[str] = None,
                       shard_index: int = 0) -> Tuple[np.ndarray, List[str]]:
        emb, ids = self._encode(query_dataset, self.data_args.q_max_len,
                                is_query=True)
        self._save(emb, ids, save_dir, "query", shard_index)
        return emb, ids

    # ---- search ---------------------------------------------------------

    def index_tensor(self, search_dtype=torch.bfloat16,
                     device=None) -> torch.Tensor:
        """The corpus embeddings on ``device`` (by default the retriever's)
        in ``search_dtype``. The cast runs on the host before the upload:
        uploading the stored fp32 array first would put a second, twice as
        large copy of the index on the device beside the one kept."""
        emb = torch.from_numpy(np.ascontiguousarray(self.doc_embeddings))
        return emb.to(search_dtype).to(device or self.device)

    def search(self, q_embeddings: np.ndarray, qids: List[str],
               topk: int = 100, search_dtype=torch.bfloat16) -> RankResult:
        if self.doc_embeddings is None:
            raise ValueError("encode or load the corpus first")
        # the Searcher IS the index: keep it until the corpus or the
        # requested depth changes, and drop the old one before building a
        # new one so two indexes are never resident together
        key = (self._corpus_gen, topk, search_dtype)
        if self._searcher_key != key:
            self._searcher = None
            self._searcher_key = None
            # over a mesh the Searcher copies each rank's part itself
            index = self.index_tensor(
                search_dtype, "cpu" if self.mesh is not None else None)
            self._searcher = build_searcher(index, self.args, topk,
                                            self.mesh)
            del index
            self._searcher_key = key
        q = torch.from_numpy(np.ascontiguousarray(q_embeddings))
        with torch.inference_mode():
            scores, indices = self._searcher.search(
                q.to(self.device).to(search_dtype))
        return _to_result(scores.cpu().numpy(), indices.cpu().numpy(), qids,
                          self.doc_ids)

    def retrieve(self, query_dataset: Iterable[dict],
                 topk: int = 100) -> RankResult:
        q_emb, qids = self.encode_queries(query_dataset)
        return self.search(q_emb, qids, topk)

    # ---- constructors mirroring the reference API -------------------------

    @classmethod
    def build_all(cls, model, corpus_dataset, data_args, inference_args,
                  pad_token_id, device=None, mesh=None) -> "Retriever":
        r = cls(model, data_args, inference_args, pad_token_id, device, mesh)
        r.encode_corpus(corpus_dataset,
                        save_dir=inference_args.encoded_save_path)
        return r

    @classmethod
    def build_embeddings(cls, model, corpus_dataset, data_args,
                         inference_args, pad_token_id, shard_index: int = 0,
                         device=None, mesh=None) -> "Retriever":
        r = cls(model, data_args, inference_args, pad_token_id, device, mesh)
        r.encode_corpus(corpus_dataset,
                        save_dir=inference_args.encoded_save_path,
                        shard_index=shard_index)
        return r

    @classmethod
    def from_embeddings(cls, model, data_args, inference_args, pad_token_id,
                        device=None, mesh=None) -> "Retriever":
        r = cls(model, data_args, inference_args, pad_token_id, device, mesh)
        r.load_corpus_shards(inference_args.encoded_save_path)
        return r


class SuccessiveRetriever(Retriever):
    """Shard-at-a-time search for indexes larger than device memory (JAX
    ``SuccessiveRetriever``): load one embedding shard onto the retriever's
    device, take its exact top-k, merge the shards' answers by score, free
    the shard, repeat."""

    @classmethod
    def from_embeddings(cls, model, data_args, inference_args, pad_token_id,
                        device=None, mesh=None) -> "SuccessiveRetriever":
        # no shard is loaded up front: that is the point
        return cls(model, data_args, inference_args, pad_token_id, device,
                   mesh)

    def retrieve(self, query_dataset: Iterable[dict],
                 topk: int = 100) -> RankResult:
        q_emb, qids = self.encode_queries(query_dataset)
        return self.search_partitions(q_emb, qids, topk)

    def search_partitions(self, q_embeddings: np.ndarray, qids: List[str],
                          topk: int = 100,
                          search_dtype=torch.bfloat16) -> RankResult:
        partial = []
        q = torch.from_numpy(np.ascontiguousarray(q_embeddings))
        q = q.to(search_dtype).to(self.device)
        for path in list_shards(self.args.encoded_save_path, "corpus"):
            emb, ids = load_embeddings(path)
            shard = torch.from_numpy(np.ascontiguousarray(emb))
            shard = shard.to(search_dtype).to(self.device)
            del emb
            with torch.inference_mode():
                scores, indices = exact_search(q, shard, k=min(topk, len(ids)))
            del shard
            partial.append(_to_result(scores.cpu().numpy(),
                                      indices.cpu().numpy(), qids, ids))
        return merge_retrieval_results_by_score(partial, topk)
