"""Batch collators producing fixed-shape numpy arrays.

The port's own copy of ``openmatch_tpu/data/collators.py``: queries and
passages are padded to a fixed length with numpy, so the batch shape does
not depend on the texts. Batches stay numpy; the trainer moves them to its
device. ``QPCollator`` keeps each query's passages contiguous (positive
first), which the contrastive targets' stride relies on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


def pad_ids(batch_ids: List[List[int]], max_len: int, pad_id: int) -> Dict[str, np.ndarray]:
    n = len(batch_ids)
    input_ids = np.full((n, max_len), pad_id, dtype=np.int32)
    attention_mask = np.zeros((n, max_len), dtype=np.int32)
    for i, ids in enumerate(batch_ids):
        ids = ids[:max_len]
        input_ids[i, : len(ids)] = ids
        attention_mask[i, : len(ids)] = 1
    return {"input_ids": input_ids, "attention_mask": attention_mask}


@dataclass
class QPCollator:
    """[{query, passages}] → {"query": {...[B, q_len]}, "passage": {...[B*n, p_len]}}."""

    pad_token_id: int
    q_max_len: int = 32
    p_max_len: int = 128

    def __call__(self, features: List[Dict]) -> Dict[str, Dict[str, np.ndarray]]:
        queries = [f["query"] for f in features]
        passages = [p for f in features for p in f["passages"]]
        return {
            "query": pad_ids(queries, self.q_max_len, self.pad_token_id),
            "passage": pad_ids(passages, self.p_max_len, self.pad_token_id),
        }


@dataclass
class PairCollator:
    """[{pos_pair, neg_pair}] → {"pos_pairs": {...}, "neg_pairs": {...}}.

    Pads to q_max_len + p_max_len + 2 (reference data_collator.py:53-75).
    """

    pad_token_id: int
    q_max_len: int = 32
    p_max_len: int = 128

    @property
    def max_len(self) -> int:
        return self.q_max_len + self.p_max_len + 2

    def __call__(self, features: List[Dict]) -> Dict[str, Dict[str, np.ndarray]]:
        out = {
            "pos_pairs": pad_ids([f["pos_pair"] for f in features], self.max_len, self.pad_token_id),
            "neg_pairs": pad_ids([f["neg_pair"] for f in features], self.max_len, self.pad_token_id),
        }
        if "pos_segs" in features[0]:  # BERT segment ids (query=0, passage=1)
            for key, field in (("pos_pairs", "pos_segs"), ("neg_pairs", "neg_segs")):
                segs = np.zeros_like(out[key]["input_ids"])
                for i, f in enumerate(features):
                    s = f[field][: self.max_len]
                    segs[i, : len(s)] = s
                out[key]["token_type_ids"] = segs
        return out


@dataclass
class InferenceCollator:
    """[{"id", "input_ids"}] -> (ids, {"input_ids", "attention_mask"}).

    Mirrors the reference's DRInferenceCollator/RRInferenceCollator: text
    ids ride alongside the tensor batch.
    """

    pad_token_id: int
    max_len: int = 128

    def __call__(self, features: List[Dict]):
        text_ids = [f["id"] for f in features]
        batch = pad_ids([f["input_ids"] for f in features], self.max_len, self.pad_token_id)
        return text_ids, batch
