"""Tiny cells for CPU tests: the real mixes and configurations with every
size cut down, so a whole run takes seconds on the CPU."""

from __future__ import annotations

import copy

from benchmark.common import Cell, find_cell

# a tiny BERT at the published 0.02 scale gives every query the same rep;
# at 0.2 the reps differ as the full-size model's do
TINY_BERT = {"vocab_size": 2048, "hidden_size": 64, "num_hidden_layers": 2,
             "num_attention_heads": 4, "intermediate_size": 128,
             "max_position_embeddings": 128, "initializer_range": 0.2}
TINY_T5 = {"vocab_size": 512, "d_model": 64, "d_kv": 16, "d_ff": 128,
           "num_layers": 2, "num_decoder_layers": 2, "num_heads": 4}


def tiny(name: str, limits=None) -> Cell:
    cell = copy.deepcopy(find_cell(name))
    c, t = cell.config, cell.traffic
    c.update(TINY_BERT if c["model_type"] == "bert" else TINY_T5)
    if t["kind"] == "search":
        t.update(rate_per_s=200, warm_load_s=0.2, senders=2, k=10,
                 queries_per_request=4,
                 max_batch=8, index_rows=4099, depth=40, check_sample=16)
        t["word_ids"] = {"lo": 1000, "hi": 2048, "zipf": 1.0}
    elif t["kind"] == "encode":
        t.update(batch_size=8, warm_batches=1, pool_passages=64,
                 check_sample=8)
        t["word_ids"] = {"lo": 3, "hi": 500, "zipf": 1.0}
        c["dr"] = dict(c["dr"], p_max_len=32)
        t["passage_tokens"] = dict(t["passage_tokens"], mu=3.0, min=4,
                                   max=32)
    elif t["kind"] == "train":
        t.update(queries=4, passages_per_query=2,
                 pool_steps=4, warm_steps=1, learning_rate=1e-3)
        t["word_ids"] = {"lo": 1000, "hi": 2048, "zipf": 1.0}
        c["dr"] = dict(c["dr"], q_max_len=8, p_max_len=16)
        t["query_tokens"] = dict(t["query_tokens"], min=3, max=8)
        t["passage_tokens"] = dict(t["passage_tokens"], mu=2.5, min=4,
                                   max=16)
    if limits is not None:
        cell.limits = dict(limits)
    return cell
