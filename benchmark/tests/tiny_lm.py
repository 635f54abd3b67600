"""A tiny cell for the CPU tests of the ``encode_lm`` driver: the real mix
and configuration with every size cut down, as ``tiny.py`` does for the
others."""

from __future__ import annotations

import copy

from benchmark.common import find_cell

# hidden 64, one dense and two MoE layers of 8 experts (top 2, one shared),
# latent 16, 4 heads of 16 + 8 query/key dims and 16 value dims
TINY_DEEPSEEK = {"vocab_size": 512, "hidden_size": 64,
                 "intermediate_size": 128, "moe_intermediate_size": 32,
                 "num_hidden_layers": 3, "num_attention_heads": 4,
                 "num_key_value_heads": 4, "n_routed_experts": 8,
                 "n_shared_experts": 1, "num_experts_per_tok": 2,
                 "first_k_dense_replace": 1, "kv_lora_rank": 16,
                 "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                 "v_head_dim": 16, "eos_token_id": 511, "pad_token_id": 510,
                 "initializer_range": 0.1, "e_score_correction_bias_std": 0.05}


def tiny_lm(name: str, limits=None, dtype="float32"):
    cell = copy.deepcopy(find_cell(name))
    c, t = cell.config, cell.traffic
    if t["kind"] == "encode_lm":
        c.update(TINY_DEEPSEEK)
        c["dr"] = dict(c["dr"], p_max_len=32, dtype=dtype)
        t.update(batch_size=8, warm_batches=1, pool_passages=64,
                 check_sample=8, suffix_ids=[511])
        t["word_ids"] = {"lo": 0, "hi": 500, "zipf": 1.0}
        t["passage_tokens"] = dict(t["passage_tokens"], mu=2.8, min=4,
                                   max=32)
    if limits is not None:
        cell.limits = dict(limits)
    return cell
