"""The yardstick of the Kimi-Linear (KDA linear attention, NoPE latent
attention, a share of the routed experts) cells: FLOPs of a document, the
bound of K13 (the chunked KDA forward) and of the held experts' grouped
products, from shapes, the documents' lengths and the held slots counted
(frozen with the benchmark, as ``arith.py``). Each document counts at its
own length; pad positions are no work, whatever the program does with
them. 2 FLOPs a multiply-add.
"""

from __future__ import annotations

import numpy as np

from .arith import bound_s

BF16_BYTES, FP32_BYTES = 2, 4


def _kda(cfg: dict) -> tuple:
    lin = cfg["linear_attn_config"]
    return lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]


def kda_recurrence_flops(cfg: dict) -> float:
    """One token of one KDA layer's recurrence, all heads: the decay of
    the state (D x D multiplies), k^T S, the rank-one update and S^T q
    (D x D multiply-adds each)."""
    H, D, _ = _kda(cfg)
    return float(H * 7 * D * D)


def token_flops(cfg: dict) -> dict:
    """The products of one token through each part of the encoder, not
    counting the routed experts (``held_slot_flops``) or the latent
    attention's causal core (``attention_flops``): ``kda`` (the q, k, v
    and o projections, the low-rank decay and gate projections, beta, the
    convolutions and the recurrence, over every KDA layer), ``mla`` (the
    four latent-attention projections, over every MLA layer), ``dense``
    (the first layers' SwiGLU), ``moe`` (the router over the published
    width and the shared experts, over every MoE layer)."""
    d, Hq = cfg["hidden_size"], cfg["num_attention_heads"]
    H, D, K = _kda(cfg)
    HD = H * D
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    n_kda = len(cfg["linear_attn_config"]["kda_layers"])
    n_mla = cfg["num_hidden_layers"] - n_kda
    kda = (2 * (4 * d * HD + 2 * (d * D + D * HD) + d * H)
           + 2 * 3 * HD * K + kda_recurrence_flops(cfg))
    mla = 2 * (d * Hq * (nope + rope) + d * (rank + rope)
               + rank * Hq * (nope + vd) + Hq * vd * d)
    w = cfg["moe_intermediate_size"]
    n_dense = cfg["first_k_dense_replace"]
    moe = (2 * d * cfg["published_num_experts"]
           + 2 * 3 * d * w * cfg["num_shared_experts"])
    return {"kda": float(n_kda * kda), "mla": float(n_mla * mla),
            "dense": float(n_dense * 2 * 3 * d * cfg["intermediate_size"]),
            "moe": float((cfg["num_hidden_layers"] - n_dense) * moe)}


def attention_flops(cfg: dict, length) -> np.ndarray:
    """The latent attention's causal core of a document of ``length``
    tokens: scores and weighted sum of the L(L + 1) / 2 pairs a causal
    mask keeps, in every head of every MLA layer."""
    L = np.asarray(length, np.float64)
    n_mla = cfg["num_hidden_layers"] - len(
        cfg["linear_attn_config"]["kda_layers"])
    per_pair = 2 * cfg["num_attention_heads"] * (
        cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
        + cfg["v_head_dim"])
    return n_mla * per_pair * L * (L + 1) / 2


def held_slot_flops(cfg: dict) -> float:
    """One routed slot through a held expert: gate, up and down."""
    return float(2 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"])


def document_flops(cfg: dict, lengths, held_slots: float) -> float:
    """The FLOPs of encoding documents of ``lengths`` tokens (summed) whose
    routed slots reached a held expert ``held_slots`` times."""
    L = np.asarray(lengths, np.float64)
    return float(L.sum() * sum(token_flops(cfg).values())
                 + attention_flops(cfg, L).sum()
                 + held_slots * held_slot_flops(cfg))


def kda_chunk_bound_s(cfg: dict, tokens: float) -> tuple:
    """(seconds, "bytes" | "operations"): the least time for K13 over
    ``tokens`` real tokens in one KDA layer: q, k and v (bf16, before the
    convolution), g (fp32 a key channel) and beta (fp32 a head) read once,
    o (bf16) written once, and the recurrence's operations. The chunk
    size does not enter."""
    H, D, _ = _kda(cfg)
    per_token = H * (3 * D * BF16_BYTES + D * FP32_BYTES + FP32_BYTES
                     + D * BF16_BYTES)
    return bound_s(tokens * per_token, tokens * kda_recurrence_flops(cfg))


def held_expert_gemm_bound_s(cfg: dict, held_slots: float) -> tuple:
    """(seconds, "bytes" | "operations"): the least time for one MoE
    layer's grouped products over ``held_slots`` slots routed to the held
    experts: 2 x 3 x hidden x width operations a slot; every held expert's
    weights read once, each slot's hidden state in and out of the
    gate-and-up product and its width-wide activation in and its output
    out of the down product, in bf16."""
    d, w = cfg["hidden_size"], cfg["moe_intermediate_size"]
    held = cfg["held_experts"][1]
    ops = held_slots * held_slot_flops(cfg)
    n_bytes = BF16_BYTES * (held * 3 * d * w
                            + held_slots * (d + 2 * w + w + d))
    return bound_s(n_bytes, ops)
