"""Tokenizer-facing encode helpers accepting raw text or token-id lists.

The port's own copy of ``openmatch_tpu/data/tokenization.py``: ``encode_one``
(``InferenceDataset`` and ``DRTrainDataset`` need it), ``encode_pair`` and
``encode_pair_with_segments`` (``RRTrainDataset``). Id
lists are truncated and passed through ``build_inputs_with_special_tokens``
(what ``encode_plus`` does with pre-tokenized input, which fast tokenizers
refuse); text goes the normal route.
"""

from __future__ import annotations

from typing import List, Union

Content = Union[str, List[int]]


def _is_id_list(content) -> bool:
    return isinstance(content, (list, tuple)) and (
        len(content) == 0 or isinstance(content[0], int)
    )


def encode_one(tokenizer, content: Content, max_length: int) -> List[int]:
    """Single-sequence encoding with special tokens, truncating to max_length."""
    if _is_id_list(content):
        num_special = tokenizer.num_special_tokens_to_add(pair=False)
        ids = list(content)[: max(max_length - num_special, 0)]
        return tokenizer.build_inputs_with_special_tokens(ids)
    return tokenizer.encode_plus(
        content,
        truncation="only_first",
        max_length=max_length,
        padding=False,
        return_attention_mask=False,
        return_token_type_ids=False,
    )["input_ids"]


def _to_ids(tokenizer, content: Content) -> List[int]:
    """Content as special-token-free ids (text tokenized, id lists as-is)."""
    if _is_id_list(content):
        return list(content)
    return tokenizer.encode(content, add_special_tokens=False)


def encode_pair(tokenizer, a: Content, b: Content, max_length: int) -> List[int]:
    """Pair encoding with longest-first truncation to max_length. MIXED
    pairs (text query against a pre-tokenized corpus doc — the rerank-over-
    preprocessed-collection path) are normalized to the id-list route;
    fast tokenizers reject encode_plus((str, List[int])) outright."""
    if _is_id_list(a) or _is_id_list(b):
        a, b = _to_ids(tokenizer, a), _to_ids(tokenizer, b)
        num_special = tokenizer.num_special_tokens_to_add(pair=True)
        budget = max(max_length - num_special, 0)
        while len(a) + len(b) > budget:
            if len(a) >= len(b):
                a.pop()
            else:
                b.pop()
        return tokenizer.build_inputs_with_special_tokens(a, b)
    return tokenizer.encode_plus(
        (a, b),
        truncation="longest_first",
        max_length=max_length,
        padding=False,
        return_attention_mask=False,
        return_token_type_ids=False,
    )["input_ids"]


def encode_pair_with_segments(tokenizer, a: Content, b: Content, max_length: int):
    """(input_ids, token_type_ids) for a pair — BERT cross-encoders need the
    segment boundary (query=0, passage=1); fast tokenizers provide
    create_token_type_ids_from_sequences for the id-list path. Mixed
    text/id pairs are normalized to ids (see encode_pair)."""
    if _is_id_list(a) or _is_id_list(b):
        a, b = _to_ids(tokenizer, a), _to_ids(tokenizer, b)
        num_special = tokenizer.num_special_tokens_to_add(pair=True)
        budget = max(max_length - num_special, 0)
        while len(a) + len(b) > budget:
            if len(a) >= len(b):
                a.pop()
            else:
                b.pop()
        ids = tokenizer.build_inputs_with_special_tokens(a, b)
        try:
            segs = tokenizer.create_token_type_ids_from_sequences(a, b)
        except Exception:
            segs = [0] * len(ids)
        return ids, segs
    enc = tokenizer.encode_plus(
        (a, b),
        truncation="longest_first",
        max_length=max_length,
        padding=False,
        return_attention_mask=False,
        return_token_type_ids=True,
    )
    return enc["input_ids"], enc.get("token_type_ids") or [0] * len(enc["input_ids"])
