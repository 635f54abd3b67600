"""Streaming train datasets with the reference's exact sampling semantics.

The port's own copy of ``openmatch_tpu/data/train_dataset.py`` (jax-free),
held to it by ``tests/test_torch_train.py``: the same examples in the same
order for the same seed and epoch.

Reference: OpenMatch's src/openmatch/dataset/train_dataset.py. The rules
that must match bit-for-bit to reproduce MRR (SURVEY.md §7 "exact loss
semantics"):

- positive: first, or ``(hashed_seed + epoch) % len(positives)`` (:80-84)
- negatives, when fewer than needed: ``random.choices`` (:86-93) — the
  reference draws from the advancing process-global RNG (per-example
  variation, irreproducible); we keep the variation but seed it
  deterministically per (seed, epoch, example-fingerprint). Unseeded:
  doubled-then-truncated, matched exactly.
- negatives, when enough: epoch-offset window over a seed-shuffled,
  doubled list (:96-104)
- tokenization: ``encode_plus(ids_or_text, truncation='only_first',
  max_length=q/p_max_len)`` (:59-68)
- RR pairs: DELIBERATE DEVIATION — the reference concatenates query+
  passage ids into ONE sequence ([CLS] q p [SEP], no segment ids,
  :146-155); we build a proper BERT pair ([CLS] q [SEP] p [SEP] with
  token_type_ids, longest-first budget) because cross-encoders are
  trained on segment-aware pairs. Training and inference
  (retriever/reranker.encode_pair) use the SAME encoding, so
  in-framework results are self-consistent; a reference-trained RR
  checkpoint migrated here sees a shifted pair layout (see
  docs/migration.md).

Redesign vs reference: iteration is a plain Python generator with an
explicit shuffle buffer (no HF datasets dependency in the hot loop), a
deterministic per-host shard (``shard_index``/``num_shards`` slicing by
line number — no multi-worker duplication bug, cf. the known issue at
docs/dr-msmarco-passage.md:229-231), and epoch/seed passed explicitly
instead of reaching into a live Trainer.
"""

from __future__ import annotations

import glob
import json
import os
import random
import zlib
from typing import Dict, Iterator, List, Optional

from ..config import DataArguments


def _jsonl_files(data_args: DataArguments) -> List[str]:
    if data_args.train_dir is not None:
        return sorted(glob.glob(os.path.join(data_args.train_dir, "*.jsonl")))
    return [data_args.train_path]


def _iter_jsonl(files: List[str], shard_index: int = 0, num_shards: int = 1) -> Iterator[dict]:
    i = 0
    for path in files:
        with open(path) as f:
            for line in f:
                if i % num_shards == shard_index:
                    yield json.loads(line)
                i += 1


def _shuffled(iterator: Iterator, buffer_size: int, seed: Optional[int], epoch: int) -> Iterator:
    """Reservoir-style shuffle buffer (same contract as HF streaming shuffle)."""
    if seed is None or buffer_size <= 1:
        yield from iterator
        return
    rng = random.Random(seed + epoch)
    buf = []
    for item in iterator:
        if len(buf) < buffer_size:
            buf.append(item)
        else:
            j = rng.randrange(buffer_size)
            yield buf[j]
            buf[j] = item
    rng.shuffle(buf)
    yield from buf


def count_lines(files: List[str]) -> int:
    n = 0
    for path in files:
        last = b"\n"
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                n += chunk.count(b"\n")
                last = chunk[-1:]
        if last != b"\n":  # unterminated final line still counts
            n += 1
    return n


class TrainDataset:
    def __init__(
        self,
        tokenizer,
        data_args: DataArguments,
        shuffle_seed: Optional[int] = None,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.tokenizer = tokenizer
        self.data_args = data_args
        self.shuffle_seed = shuffle_seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.data_files = _jsonl_files(data_args)

    def __len__(self) -> int:
        return count_lines(self.data_files)

    def _encode(self, content, max_length: int) -> List[int]:
        from .tokenization import encode_one

        return encode_one(self.tokenizer, content, max_length)


class DRTrainDataset(TrainDataset):
    """Yields {"query": [ids], "passages": [[ids] * train_n_passages]}."""

    def process_one(self, example: dict, epoch: int, hashed_seed: Optional[int]) -> Dict:
        data_args = self.data_args
        qry = example["query"]
        encoded_query = self._encode(qry, data_args.q_max_len)

        group_positives = example["positives"]
        group_negatives = example["negatives"]

        if data_args.positive_passage_no_shuffle or hashed_seed is None:
            pos_psg = group_positives[0]
        else:
            pos_psg = group_positives[(hashed_seed + epoch) % len(group_positives)]
        encoded_passages = [self._encode(pos_psg, data_args.p_max_len)]

        negative_size = data_args.train_n_passages - 1
        if len(group_negatives) < negative_size:
            if hashed_seed is not None:
                # the reference draws from the ADVANCING process-global RNG
                # (random.choices, :89) — per-example variation but not
                # reproducible across runs. Seeding with only (seed, epoch)
                # would hand every short example in an epoch the identical
                # index pattern (silent negative-diversity collapse);
                # mixing in a stable per-example fingerprint keeps the
                # reference's variation AND run-to-run determinism.
                fp = zlib.crc32(repr(qry).encode())
                negs = random.Random(hashed_seed + epoch * 2654435761 + fp) \
                    .choices(group_negatives, k=negative_size)
            else:
                negs = (list(group_negatives) * 2)[:negative_size]
        elif data_args.train_n_passages == 1:
            negs = []
        elif data_args.negative_passage_no_shuffle:
            negs = group_negatives[:negative_size]
        else:
            _offset = epoch * negative_size % len(group_negatives)
            negs = list(group_negatives)
            if hashed_seed is not None:
                random.Random(hashed_seed).shuffle(negs)
            negs = negs * 2
            negs = negs[_offset : _offset + negative_size]

        for neg in negs:
            encoded_passages.append(self._encode(neg, data_args.p_max_len))
        assert len(encoded_passages) == data_args.train_n_passages
        return {"query": encoded_query, "passages": encoded_passages}

    def epoch_iterator(self, epoch: int = 0, hashed_seed: Optional[int] = None) -> Iterator[Dict]:
        raw = _iter_jsonl(self.data_files, self.shard_index, self.num_shards)
        if self.shuffle_seed is not None:
            raw = _shuffled(raw, 10_000, self.shuffle_seed, epoch)
        for example in raw:
            yield self.process_one(example, epoch, hashed_seed)


class RRTrainDataset(TrainDataset):
    """Yields {"pos_pair": [ids], "neg_pair": [ids]}."""

    def _encode_pair(self, qry, psg):
        from .tokenization import encode_pair_with_segments

        data_args = self.data_args
        return encode_pair_with_segments(
            self.tokenizer, qry, psg, data_args.q_max_len + data_args.p_max_len + 2
        )

    def process_one(self, example: dict, epoch: int, hashed_seed: Optional[int]) -> Dict:
        data_args = self.data_args
        qry = example["query"]
        group_positives = example["positives"]
        group_negatives = example["negatives"]

        if data_args.positive_passage_no_shuffle or hashed_seed is None:
            pos_psg = group_positives[0]
        else:
            pos_psg = group_positives[(hashed_seed + epoch) % len(group_positives)]
        if hashed_seed is None:
            neg_psg = group_negatives[0]
        else:
            neg_psg = group_negatives[(hashed_seed + epoch) % len(group_negatives)]
        pos_ids, pos_segs = self._encode_pair(qry, pos_psg)
        neg_ids, neg_segs = self._encode_pair(qry, neg_psg)
        return {
            "pos_pair": pos_ids, "pos_segs": pos_segs,
            "neg_pair": neg_ids, "neg_segs": neg_segs,
        }

    def epoch_iterator(self, epoch: int = 0, hashed_seed: Optional[int] = None) -> Iterator[Dict]:
        raw = _iter_jsonl(self.data_files, self.shard_index, self.num_shards)
        if self.shuffle_seed is not None:
            raw = _shuffled(raw, 10_000, self.shuffle_seed, epoch)
        for example in raw:
            yield self.process_one(example, epoch, hashed_seed)
