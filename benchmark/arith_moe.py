"""The yardstick of the DeepSeek-V3 (latent attention, routed experts)
cells: FLOPs of a passage and the bound of the routed experts' grouped
products, from shapes and the traffic alone (frozen with the benchmark,
as ``arith.py``). The work counted is what the passages need: each passage
at its own length, pad positions as no work, whatever the program does
with them.
"""

from __future__ import annotations

import numpy as np

from .arith import bound_s

BF16_BYTES = 2


def token_flops(cfg: dict) -> float:
    """The products of one token through the whole encoder, 2 FLOPs a
    multiply-add: per layer the latent attention's four projections
    (``q_proj``, ``kv_a_proj_with_mqa``, ``kv_b_proj``, ``o_proj``), then
    the dense SwiGLU of the first ``first_k_dense_replace`` layers, or the
    router, the ``num_experts_per_tok`` routed experts and the shared
    experts. Embedding lookups, norms, RoPE, softmax and the unused LM
    head are left out."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    attn = 2 * (d * H * (nope + rope) + d * (rank + rope)
                + rank * H * (nope + vd) + H * vd * d)
    dense = 2 * 3 * d * cfg["intermediate_size"]
    moe_w = cfg["moe_intermediate_size"]
    moe = (2 * d * cfg["n_routed_experts"]
           + cfg["num_experts_per_tok"] * 2 * 3 * d * moe_w
           + 2 * 3 * d * moe_w * cfg["n_shared_experts"])
    n_dense = cfg["first_k_dense_replace"]
    layers = cfg["num_hidden_layers"]
    return float(layers * attn + n_dense * dense + (layers - n_dense) * moe)


def attention_flops(cfg: dict, length) -> np.ndarray:
    """Causal attention of a passage of ``length`` tokens: the scores and
    the weighted sum of the L(L + 1) / 2 query-key pairs a causal mask
    keeps, in every head of every layer."""
    L = np.asarray(length, np.float64)
    pairs = L * (L + 1) / 2
    per_pair = 2 * cfg["num_attention_heads"] * (
        cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
        + cfg["v_head_dim"])
    return cfg["num_hidden_layers"] * per_pair * pairs


def passage_flops(cfg: dict, lengths) -> float:
    """The FLOPs of encoding passages of ``lengths`` tokens (summed)."""
    L = np.asarray(lengths, np.float64)
    return float(L.sum() * token_flops(cfg)
                 + attention_flops(cfg, L).sum())


def expert_gemm_bound_s(cfg: dict, real_tokens: int) -> tuple:
    """(seconds, "bytes" | "operations"): the least time for the routed
    experts' grouped products of one call over ``real_tokens`` tokens, in
    every MoE layer: 2 x 3 x hidden x width operations a routed slot
    (gate, up and down), ``num_experts_per_tok`` slots a token; every
    expert's weights read once, each slot's hidden state in and out of
    the gate-and-up product and its width-wide activation in and its
    output out of the down product, in bf16."""
    d, w = cfg["hidden_size"], cfg["moe_intermediate_size"]
    E = cfg["n_routed_experts"]
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    slots = real_tokens * cfg["num_experts_per_tok"]
    ops = moe_layers * slots * 2 * 3 * d * w
    n_bytes = moe_layers * BF16_BYTES * (
        E * 3 * d * w + slots * (d + 2 * w) + slots * (w + d))
    return bound_s(n_bytes, ops)
