"""Batch collators producing fixed-shape numpy arrays.

The port's own copy of ``pad_ids`` and ``InferenceCollator`` from
``openmatch_tpu/data/collators.py``: queries and passages are padded to a
fixed length with numpy, so the batch shape does not depend on the texts.
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
