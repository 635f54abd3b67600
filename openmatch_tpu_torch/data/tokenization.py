"""Tokenizer-facing encode helper accepting raw text or token-id lists.

The port's own copy of ``encode_one`` from
``openmatch_tpu/data/tokenization.py`` (``InferenceDataset`` needs it). Id
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
