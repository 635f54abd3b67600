"""BEIR benchmark layout loader.

The port's own copy of ``openmatch_tpu/data/beir.py`` (held to it by
``tests/test_torch_beir.py``): reads ``corpus.jsonl``, ``queries.jsonl`` and
``qrels/{split}.tsv`` (with its header row); queries are filtered to the
qrels' query ids, and an empty title becomes '-' for the fixed
"Title: .. Text: .." template.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Iterator, List

from ..utils.metrics import Qrels


class BEIRDataset:
    def __init__(self, data_dir: str, split: str = "test"):
        self.data_dir = data_dir
        self.split = split
        self.corpus_path = os.path.join(data_dir, "corpus.jsonl")
        self.queries_path = os.path.join(data_dir, "queries.jsonl")
        self.qrels_path = os.path.join(data_dir, "qrels", f"{split}.tsv")
        self.qrels = self._load_qrels()

    def _load_qrels(self) -> Qrels:
        qrels: Qrels = {}
        with open(self.qrels_path) as f:
            reader = csv.reader(f, delimiter="\t")
            header = next(reader)  # query-id, corpus-id, score
            for row in reader:
                qid, did, rel = row[0], row[1], int(row[2])
                qrels.setdefault(qid, {})[did] = rel
        return qrels

    def iter_queries(self) -> Iterator[dict]:
        with open(self.queries_path) as f:
            for line in f:
                d = json.loads(line)
                qid = str(d.get("_id", d.get("id")))
                if qid in self.qrels:
                    yield {"id": qid, "text": d.get("text", "")}

    def iter_corpus(self) -> Iterator[dict]:
        with open(self.corpus_path) as f:
            for line in f:
                d = json.loads(line)
                title = d.get("title") or "-"
                yield {
                    "id": str(d.get("_id", d.get("id"))),
                    "title": title,
                    "text": d.get("text", ""),
                }
