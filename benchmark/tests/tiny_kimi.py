"""A tiny cell for the CPU tests of the ``encode_kimi`` driver: the real
mix and configuration with every size cut down, as ``tiny_lm.py`` does
for ``encode_lm``."""

from __future__ import annotations

import copy

from benchmark.common import find_cell

CELL = "kimi-linear-48b-a3b.encode-doc"

# hidden 64; four layers (KDA + dense, KDA + MoE, NoPE MLA + MoE, KDA +
# MoE) of 2 KDA heads of 16 and 4 MLA heads of 16 + 8 query/key dims and
# 16 value dims, latent 16; the router over 8 experts (top 2, one
# shared), half of them held
TINY_KIMI = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 96,
             "moe_intermediate_size": 32, "num_hidden_layers": 4,
             "num_attention_heads": 4, "num_key_value_heads": 4,
             "num_experts": 4, "published_num_experts": 8,
             "held_experts": [0, 4], "num_shared_experts": 1,
             "num_experts_per_token": 2, "first_k_dense_replace": 1,
             "kv_lora_rank": 16, "qk_nope_head_dim": 16,
             "qk_rope_head_dim": 8, "v_head_dim": 16,
             "linear_attn_config": {"kda_layers": [1, 2, 4],
                                    "full_attn_layers": [3], "num_heads": 2,
                                    "head_dim": 16,
                                    "short_conv_kernel_size": 4},
             "eos_token_id": 511, "pad_token_id": 510,
             "initializer_range": 0.1, "e_score_correction_bias_std": 0.05}


def tiny_kimi(limits=None, dtype="float32", **changes):
    cell = copy.deepcopy(find_cell(CELL))
    c, t = cell.config, cell.traffic
    c.update(TINY_KIMI, **changes)
    c["dr"] = dict(c["dr"], p_max_len=48, dtype=dtype)
    t.update(batch_size=8, warm_batches=1, pool_passages=64, check_sample=8,
             suffix_ids=[511])
    t["word_ids"] = {"lo": 0, "hi": 500, "zipf": 1.0}
    t["passage_tokens"] = dict(t["passage_tokens"], mu=3.0, min=4, max=48)
    if limits is not None:
        cell.limits = dict(limits)
    return cell
