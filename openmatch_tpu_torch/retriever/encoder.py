"""Batch encoding of corpora/queries to embedding shards.

Port of ``openmatch_tpu/retriever/encoder.py``. The shard format is the
same byte for byte (``embeddings.{corpus|query}.rank.{i}.npz`` holding
``embeddings`` and ``ids``, plus a ``.manifest.json`` sidecar), so shards
written by either package load in the other. The file helpers are copies
because the JAX module imports jax at its top.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..data.collators import InferenceCollator
from ..data.loader import batched, prefetch
from ..utils.profiling import span


def encode_dataset(
    model,
    dataset: Iterable[dict],
    batch_size: int,
    max_len: int,
    pad_token_id: int,
    is_query: bool = False,
    out_dtype=np.float16,
    device=None,
) -> Tuple[np.ndarray, List[str]]:
    """Encode an id+input_ids stream -> (embeddings [N, D], ids).

    Runs under ``torch.inference_mode`` on ``device`` (default: the
    device of the model's parameters). Batches are padded to
    ``batch_size`` rows like the JAX version, so a query encodes to the
    same bits whichever batch it lands in. A batch's upload and encode are
    an ``encode.launch`` span, its read-back an ``encode.readback`` span."""
    if device is None:
        device = next(model.parameters()).device
    collator = InferenceCollator(pad_token_id=pad_token_id, max_len=max_len)
    chunks, all_ids = [], []
    stream = batched(dataset, batch_size, collator, pad_to_full=True)
    with torch.inference_mode():
        for (text_ids, batch), n_valid in prefetch(stream, depth=4):
            with span("encode.launch"):
                ids = torch.from_numpy(batch["input_ids"]).to(device)
                mask = torch.from_numpy(batch["attention_mask"]).to(device)
                reps = model.encode(ids, mask, is_query=is_query)
            with span("encode.readback"):
                reps = reps.float().cpu().numpy()[:n_valid]
            chunks.append(reps.astype(out_dtype))
            all_ids.extend(text_ids[:n_valid])
    if not chunks:
        # (0, D), not (0, 0): an empty shard must still concatenate
        return np.zeros((0, model.out_dim), out_dtype), []
    return np.concatenate(chunks, axis=0), all_ids


def shard_path(save_dir: str, kind: str, shard_index: int) -> str:
    return os.path.join(save_dir, f"embeddings.{kind}.rank.{shard_index}.npz")


def save_embeddings(embeddings: np.ndarray, ids: List[str], path: str,
                    num_shards: Optional[int] = None):
    """Write one shard atomically (tmp + rename), plus a sidecar manifest
    when the writer knows the collection's shard count; ``list_shards``
    uses the sidecars to detect missing shards."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, embeddings=embeddings, ids=np.array(ids))
    os.replace(tmp, path)
    if num_shards is not None:
        mtmp = path + ".manifest.tmp"
        with open(mtmp, "w") as f:
            json.dump({"num_shards": int(num_shards),
                       "rows": int(embeddings.shape[0])}, f)
        os.replace(mtmp, path + ".manifest.json")


def load_embeddings(path: str) -> Tuple[np.ndarray, List[str]]:
    with np.load(path, allow_pickle=False) as z:
        return z["embeddings"], [str(x) for x in z["ids"]]


def list_shards(save_dir: str, kind: str) -> List[str]:
    """Shard paths in rank order. With sidecar manifests, every rank
    0..num_shards-1 must be present (a gap would search a partial index)."""
    names = [
        n for n in os.listdir(save_dir)
        if n.startswith(f"embeddings.{kind}.rank.") and n.endswith(".npz")
        and not n.endswith(".tmp.npz")
    ]
    paths = [os.path.join(save_dir, n)
             for n in sorted(names, key=lambda n: int(n.split(".")[-2]))]
    declared = set()
    for p in paths:
        mpath = p + ".manifest.json"
        if os.path.exists(mpath):
            with open(mpath) as f:
                declared.add(json.load(f)["num_shards"])
    if declared:
        if len(declared) > 1:
            raise ValueError(
                f"shard manifests in {save_dir} disagree on num_shards: "
                f"{sorted(declared)}")
        want = declared.pop()
        have = {int(p.split(".")[-2]) for p in paths}
        missing = sorted(set(range(want)) - have)
        if missing:
            raise ValueError(
                f"embedding shards missing from {save_dir}: ranks {missing} "
                f"of {want} (partial encode? rerun build_index for them)")
    return paths
