"""Offline train-data preprocessing: qrels + negatives + collection → jsonl.

The port's own copy of ``openmatch_tpu/data/preprocessor.py`` (held to it
by ``tests/test_torch_data_tools.py``). Output format is the tokenized
train jsonl consumed by DRTrainDataset:
``{"query": [ids], "positives": [[ids]...], "negatives": [[ids]...]}``.
The collection loads into a plain dict and templates come from
templates.py.
"""

from __future__ import annotations

import csv
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..templates import fill_template


def read_queries(path: str) -> Dict[str, str]:
    qmap = {}
    with open(path) as f:
        for line in f:
            qid, text = line.rstrip("\n").split("\t")
            qmap[qid] = text
    return qmap


def read_qrel(path: str) -> Dict[str, List[str]]:
    """MS MARCO-style binary qrels."""
    qrel: Dict[str, List[str]] = {}
    with open(path, encoding="utf8") as f:
        for row in csv.reader(f, delimiter="\t"):
            topicid, _, docid, rel = row
            assert rel == "1"
            qrel.setdefault(topicid, []).append(docid)
    return qrel


def read_collection_tsv(path: str, columns: Tuple[str, ...] = ("text_id", "title", "text")) -> Dict[str, dict]:
    out = {}
    with open(path) as f:
        for row in csv.reader(f, delimiter="\t"):
            entry = dict(zip(columns, row))
            # pad missing trailing columns (e.g. no title)
            for c in columns[len(row):]:
                entry[c] = ""
            out[entry["text_id"]] = entry
    return out


@dataclass
class TrainPreProcessor:
    queries: Dict[str, str]
    collection: Dict[str, dict]
    tokenizer: object
    doc_max_len: int = 128
    query_max_len: int = 32
    doc_template: Optional[str] = None
    query_template: Optional[str] = None
    title_field: str = "title"
    text_field: str = "text"
    query_field: str = "text"
    allow_not_found: bool = False

    def get_query(self, qid: str) -> List[int]:
        if self.query_template is None:
            query = self.queries[qid]
        else:
            query = fill_template(
                self.query_template,
                {self.query_field: self.queries[qid]},
                allow_not_found=self.allow_not_found,
            )
        return self.tokenizer.encode(
            query, add_special_tokens=False, max_length=self.query_max_len, truncation=True
        )

    def get_passage(self, pid: str) -> List[int]:
        entry = self.collection[pid]
        title = entry.get(self.title_field) or ""
        body = entry.get(self.text_field) or ""
        if self.doc_template is None:
            # `or " "`: T5 tokenizers HAVE the attribute but it is None
            # (CollectionPreProcessor.process_line guards the same way)
            content = title + (getattr(self.tokenizer, "sep_token", " ") or " ") + body
        else:
            content = fill_template(self.doc_template, entry, allow_not_found=self.allow_not_found)
        return self.tokenizer.encode(
            content, add_special_tokens=False, max_length=self.doc_max_len, truncation=True
        )

    def process_one(self, item: Tuple[str, List[str], List[str]]) -> str:
        qid, positives, negatives = item
        return json.dumps({
            "query": self.get_query(qid),
            "positives": [self.get_passage(p) for p in positives],
            "negatives": [self.get_passage(n) for n in negatives],
        })


@dataclass
class CollectionPreProcessor:
    """tsv line → {"text_id", "text": [ids]}."""

    tokenizer: object
    separator: str = "\t"
    max_length: int = 128

    def process_line(self, line: str) -> str:
        parts = line.rstrip("\n").split(self.separator)
        text_id, texts = parts[0], parts[1:]
        sep = getattr(self.tokenizer, "sep_token", " ") or " "
        encoded = self.tokenizer.encode(
            sep.join(texts), add_special_tokens=False,
            max_length=self.max_length, truncation=True,
        )
        return json.dumps({"text_id": text_id, "text": encoded})


def load_ranking_negatives(rank_file: str, relevance: Dict[str, List[str]],
                           n_sample: int, depth: int, seed: Optional[int] = None):
    """Stream hard negatives from a TREC run grouped by query: drop
    positives, cap at ``depth``, shuffle, sample ``n_sample``. Queries
    absent from ``relevance`` are SKIPPED (no positives -> no training
    example); the reference raises KeyError there, killing the run partway
    through a mined file when the run's query set exceeds the qrels."""
    import random as _random

    rng = _random.Random(seed)
    curr_q, negatives = None, []

    def emit(q, negs):
        if q not in relevance:
            return None
        negs = negs[:depth]
        rng.shuffle(negs)
        return q, relevance[q], negs[:n_sample]

    with open(rank_file) as f:
        for line in f:
            q, _, p, _, _, _ = line.split()
            if curr_q is None:
                curr_q = q
            if q != curr_q:
                row = emit(curr_q, negatives)
                if row is not None:
                    yield row
                curr_q, negatives = q, []
            if p not in relevance.get(q, ()):
                negatives.append(p)
    if curr_q is not None:
        row = emit(curr_q, negatives)
        if row is not None:
            yield row


class ShardedJsonlWriter:
    """Write lines into split{NN}.jsonl shards of ``shard_size`` lines."""

    def __init__(self, save_dir: str, shard_size: int = 45000, suffix: str = ""):
        import os

        os.makedirs(save_dir, exist_ok=True)
        self.save_dir = save_dir
        self.shard_size = shard_size
        self.suffix = suffix
        self.counter = 0
        self.shard_id = 0
        self._f = None

    def write(self, line: str):
        import os

        if self._f is None:
            name = f"split{self.shard_id:02d}{self.suffix}.jsonl"
            self._f = open(os.path.join(self.save_dir, name), "w")
        self._f.write(line + "\n")
        self.counter += 1
        if self.counter == self.shard_size:
            self._f.close()
            self._f = None
            self.shard_id += 1
            self.counter = 0

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
