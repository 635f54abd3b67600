"""v1-style datasets: jsonl/tsv pair files or id-spec dicts with TREC runs.

The port's own copy of ``openmatch_tpu/v1/dataset.py``. Inputs:

- a str path: jsonl lines with {query, doc_pos, doc_neg} (ranking train),
  {query, doc, label} (classification train; dev with query_id, doc_id,
  retrieval_score), or their tsv equivalents;
- a dict spec {"queries", "docs", "qrels", "trec"}: examples come from the
  trec file, with texts looked up by id.

Collation targets the word models (query_idx/query_mask/doc_idx/doc_mask)
or a BERT cross-encoder (input_ids/input_mask/segment_ids from the
tokenizer's pair encoding); both produce fixed shapes, as numpy arrays.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Union

import numpy as np


def _read_kv_file(path: str, key: str, value: str) -> Dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            if path.endswith((".json", ".jsonl")):
                d = json.loads(line)
                out[str(d[key])] = d[value]
            else:
                k, v = line.rstrip("\n").split("\t")
                out[k] = v
    return out


class V1Dataset:
    def __init__(
        self,
        dataset: Union[str, Dict],
        mode: str,
        task: str = "ranking",
        max_input: int = 1_280_000,
    ):
        self._mode = mode
        self._task = task
        self._examples: List[dict] = []
        self.queries: Dict[str, str] = {}
        self.docs: Dict[str, str] = {}

        if isinstance(dataset, str):
            self._by_id = False
            with open(dataset) as f:
                for i, line in enumerate(f):
                    if i >= max_input:
                        break
                    if mode != "train" or dataset.endswith((".json", ".jsonl")):
                        self._examples.append(json.loads(line))
                    else:
                        parts = line.rstrip("\n").split("\t")
                        if task == "ranking":
                            self._examples.append(
                                {"query": parts[0], "doc_pos": parts[1], "doc_neg": parts[2]}
                            )
                        elif task == "classification":
                            self._examples.append(
                                {"query": parts[0], "doc": parts[1], "label": int(parts[2])}
                            )
                        else:
                            raise ValueError("Task must be `ranking` or `classification`.")
        elif isinstance(dataset, dict):
            self._by_id = True
            self.queries = _read_kv_file(dataset["queries"], "query_id", "query")
            self.docs = _read_kv_file(dataset["docs"], "doc_id", "doc")
            qrels: Dict[str, Dict[str, int]] = {}
            if mode == "dev" and "qrels" in dataset:
                with open(dataset["qrels"]) as f:
                    for line in f:
                        parts = line.split()
                        qrels.setdefault(parts[0], {})[parts[2]] = int(parts[3])
            with open(dataset["trec"]) as f:
                for i, line in enumerate(f):
                    if i >= max_input:
                        break
                    parts = line.split()
                    if mode == "train":
                        if task == "ranking":
                            self._examples.append(
                                {"query_id": parts[0], "doc_pos_id": parts[1], "doc_neg_id": parts[2]}
                            )
                        else:
                            self._examples.append(
                                {"query_id": parts[0], "doc_id": parts[1], "label": int(parts[2])}
                            )
                    elif mode == "dev":
                        label = qrels.get(parts[0], {}).get(parts[2], 0)
                        self._examples.append(
                            {"label": label, "query_id": parts[0], "doc_id": parts[2],
                             "retrieval_score": float(parts[4])}
                        )
                    elif mode == "test":
                        self._examples.append(
                            {"query_id": parts[0], "doc_id": parts[2],
                             "retrieval_score": float(parts[4])}
                        )
                    else:
                        raise ValueError("Mode must be `train`, `dev` or `test`.")
        else:
            raise ValueError("Dataset must be `str` or `dict`.")

    def __len__(self):
        return len(self._examples)

    def __getitem__(self, i) -> dict:
        ex = dict(self._examples[i])
        if self._by_id:
            if "query_id" in ex:
                ex.setdefault("query", self.queries[ex["query_id"]])
            for src, dst in (("doc_id", "doc"), ("doc_pos_id", "doc_pos"), ("doc_neg_id", "doc_neg")):
                if src in ex:
                    ex.setdefault(dst, self.docs[ex[src]])
        return ex

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class WordCollator:
    """Word-model batches (reference collate in v1 Dataset.collate)."""

    def __init__(self, tokenizer, query_max_len: int = 10, doc_max_len: int = 256,
                 mode: str = "train", task: str = "ranking"):
        self.tokenizer = tokenizer
        self.q_len = query_max_len
        self.d_len = doc_max_len
        self.mode = mode
        self.task = task

    def __call__(self, batch: List[dict]) -> Dict[str, np.ndarray]:
        def proc(texts, max_len):
            ids, masks = zip(*[self.tokenizer.process(t, max_len) for t in texts])
            return np.asarray(ids, np.int32), np.asarray(masks, np.float32)

        out: Dict[str, np.ndarray] = {}
        q_idx, q_mask = proc([e["query"] for e in batch], self.q_len)
        out["query_idx"], out["query_mask"] = q_idx, q_mask
        if self.mode == "train" and self.task == "ranking":
            out["doc_pos_idx"], out["doc_pos_mask"] = proc([e["doc_pos"] for e in batch], self.d_len)
            out["doc_neg_idx"], out["doc_neg_mask"] = proc([e["doc_neg"] for e in batch], self.d_len)
        else:
            out["doc_idx"], out["doc_mask"] = proc([e["doc"] for e in batch], self.d_len)
            if "label" in batch[0]:
                out["label"] = np.asarray([e["label"] for e in batch], np.int32)
        if "query_id" in batch[0]:
            out["query_id"] = [e["query_id"] for e in batch]
            out["doc_id"] = [e.get("doc_id") for e in batch]
        if "retrieval_score" in batch[0]:
            out["retrieval_score"] = np.asarray(
                [e["retrieval_score"] for e in batch], np.float32
            )
        return out


class BertPairCollator:
    """Cross-encoder batches: [CLS] q [SEP] d [SEP] with segment ids."""

    def __init__(self, tokenizer, query_max_len: int = 32, doc_max_len: int = 221,
                 mode: str = "train", task: str = "ranking"):
        self.tokenizer = tokenizer
        self.q_len = query_max_len
        self.d_len = doc_max_len
        self.max_len = query_max_len + doc_max_len + 3
        self.mode = mode
        self.task = task

    def _encode(self, queries, docs):
        enc = self.tokenizer(
            list(queries), list(docs),
            truncation="longest_first", max_length=self.max_len,
            padding="max_length", return_tensors="np",
        )
        out = {
            "input_ids": enc["input_ids"].astype(np.int32),
            "input_mask": enc["attention_mask"].astype(np.int32),
        }
        out["segment_ids"] = enc.get(
            "token_type_ids", np.zeros_like(enc["input_ids"])
        ).astype(np.int32)
        return out

    def __call__(self, batch: List[dict]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        queries = [e["query"] for e in batch]
        if self.mode == "train" and self.task == "ranking":
            pos = self._encode(queries, [e["doc_pos"] for e in batch])
            neg = self._encode(queries, [e["doc_neg"] for e in batch])
            out.update({f"pos_{k}": v for k, v in pos.items()})
            out.update({f"neg_{k}": v for k, v in neg.items()})
        else:
            out.update(self._encode(queries, [e["doc"] for e in batch]))
            if "label" in batch[0]:
                out["label"] = np.asarray([e["label"] for e in batch], np.int32)
        if "query_id" in batch[0]:
            out["query_id"] = [e["query_id"] for e in batch]
            out["doc_id"] = [e.get("doc_id") for e in batch]
        if "retrieval_score" in batch[0]:
            out["retrieval_score"] = np.asarray(
                [e["retrieval_score"] for e in batch], np.float32
            )
        return out
