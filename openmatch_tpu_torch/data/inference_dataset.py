"""Inference datasets: corpus/query streams for encoding.

The port's own copy of ``openmatch_tpu/data/inference_dataset.py``.
Dispatch on extension (jsonl vs tsv), template fill from columns, and two
access modes: streaming (encode jobs) and a random-access dict keyed by id.
A shard is a deterministic stride slice by line number
(``i % num_shards == shard_index``).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Iterator, List, Optional

from ..config import DataArguments
from ..templates import fill_template, find_all_markers


class InferenceDataset:
    def __init__(
        self,
        tokenizer,
        data_files: List[str],
        max_len: int = 128,
        template: Optional[str] = None,
        column_names: Optional[List[str]] = None,
        all_markers: Optional[List[str]] = None,
        id_key: str = "id",
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.tokenizer = tokenizer
        self.data_files = data_files
        self.max_len = max_len
        self.template = template
        self.column_names = column_names
        self.all_markers = (
            find_all_markers(template) if (template and all_markers is None) else all_markers
        )
        self.id_key = id_key
        self.shard_index = shard_index
        self.num_shards = num_shards
        ext = os.path.splitext(data_files[0])[1].lower()
        if ext in (".jsonl", ".json"):
            self._reader = self._read_jsonl
        elif ext in (".tsv", ".txt"):
            self._reader = self._read_tsv
        else:
            raise ValueError(f"Unsupported dataset extension: {ext}")

    # -- loading -------------------------------------------------------

    @classmethod
    def load(
        cls,
        tokenizer,
        data_args: DataArguments,
        data_files=None,
        is_query: bool = False,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> "InferenceDataset":
        """Mirror of the reference's InferenceDataset.load."""
        if data_files is None:
            data_files = [data_args.query_path if is_query else data_args.corpus_path]
        if isinstance(data_files, str):
            data_files = [data_files]
        template = data_args.query_template if is_query else data_args.doc_template
        columns = data_args.query_column_names if is_query else data_args.doc_column_names
        return cls(
            tokenizer=tokenizer,
            data_files=data_files,
            max_len=data_args.q_max_len if is_query else data_args.p_max_len,
            template=template,
            column_names=columns.split(",") if columns else None,
            shard_index=shard_index,
            num_shards=num_shards,
        )

    def _read_jsonl(self, path: str) -> Iterator[dict]:
        with open(path) as f:
            for line in f:
                yield json.loads(line)

    def _read_tsv(self, path: str) -> Iterator[dict]:
        if not self.column_names:
            raise ValueError("a tsv dataset needs column_names")
        with open(path) as f:
            for row in csv.reader(f, delimiter="\t"):
                yield dict(zip(self.column_names, row))

    # -- processing ----------------------------------------------------

    def _text_of(self, example: dict) -> str:
        if self.template is None:
            return example.get("text", "")
        return fill_template(self.template, example, self.all_markers, allow_not_found=True)

    def process_one(self, example: dict) -> Dict:
        example = dict(example)
        example.setdefault("id", example.get(self.id_key, example.get("text_id", example.get("_id"))))
        if example["id"] is None:
            # str(None) would silently assign every row the id "None" and
            # search would "work" while returning meaningless doc ids
            raise ValueError(
                f"no id field found in example (tried '{self.id_key}', "
                f"'text_id', '_id'); keys present: {sorted(example)[:8]} — "
                "pass id_key=<your field>")
        from .tokenization import encode_one

        if "text" in example and isinstance(example["text"], list):
            # pre-tokenized corpus line
            ids = encode_one(self.tokenizer, example["text"], self.max_len)
        else:
            ids = encode_one(self.tokenizer, self._text_of(example), self.max_len)
        return {"id": str(example["id"]), "input_ids": ids}

    # -- access modes --------------------------------------------------

    def __iter__(self) -> Iterator[Dict]:
        i = 0
        for path in self.data_files:
            for example in self._reader(path):
                if i % self.num_shards == self.shard_index:
                    yield self.process_one(example)
                i += 1

    def iter_raw(self) -> Iterator[dict]:
        i = 0
        for path in self.data_files:
            for example in self._reader(path):
                if i % self.num_shards == self.shard_index:
                    yield example
                i += 1

    def to_dict(self) -> Dict[str, dict]:
        """Random-access mode keyed by id (the reranker path)."""
        out = {}
        for example in self.iter_raw():
            key = str(example.get(self.id_key, example.get("id", example.get("text_id", example.get("_id")))))
            out[key] = example
        return out
