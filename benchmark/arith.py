"""The benchmark's yardstick: the H100's published peaks, the bound of the
exact-search scoring kernel, and the FLOP counts of the models it runs.

This file is frozen with the benchmark. Later changes to the program do
not move it, so a per-layer share computed from it means the same in
every check. Every count is worked out from shapes alone.

Peaks: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the
card's full 700 W limit.
"""

from __future__ import annotations

import math

BF16_FLOPS = 989e12       # dense bf16 tensor-core rate, FLOP/s
HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth, bytes/s


def bound_s(n_bytes: float, n_flops: float) -> tuple:
    """(seconds, "bytes" | "operations"): the least time the card could
    take for work that moves ``n_bytes`` (each input read once, each output
    written once) and does ``n_flops`` bf16 tensor-core operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def gmax_bound_s(q_rows: int, dim: int, row_elems: int,
                 out_elems: int) -> tuple:
    """Bound of a kernel that scores ``row_elems`` bf16 corpus values once
    against ``q_rows`` bf16 queries of ``dim`` and writes ``out_elems`` fp32
    values (the block maxima): a multiply-add is 2 operations. A copy of
    the program's ``chip_smoke.gmax_bound``, in seconds."""
    return bound_s(row_elems * 2 + q_rows * dim * 2 + out_elems * 4,
                   2 * q_rows * row_elems)


def plain_gmax_call_bound_s(q_rows: int, n_docs: int, dim: int,
                            group: int = 8, fanout: int = 8) -> tuple:
    """Bound of one exact-search scoring call over an ``n_docs`` x ``dim``
    corpus held as ``group``-row blocks: every body row read once, the
    block maxima and their ``fanout``-wide first pyramid level written."""
    nb = n_docs // group
    return gmax_bound_s(q_rows, dim, nb * group * dim,
                        q_rows * (nb + math.ceil(nb / fanout)))


# ---- model FLOPs --------------------------------------------------------


def bert_forward_flops(seq: int, hidden: int, layers: int,
                       intermediate: int) -> float:
    """One sequence of ``seq`` tokens through a BERT encoder: the four
    attention projections and the two FFN products (2 FLOPs a
    multiply-add), plus the attention scores and the weighted sum
    (2 x 2 x seq^2 x hidden). Embedding lookups, LayerNorm, softmax and
    the unused pooler are left out."""
    per_layer = (2 * seq * (4 * hidden * hidden + 2 * hidden * intermediate)
                 + 4 * seq * seq * hidden)
    return float(layers * per_layer)


def bert_config_flops(cfg: dict, seq: int) -> float:
    return bert_forward_flops(seq, cfg["hidden_size"],
                              cfg["num_hidden_layers"],
                              cfg["intermediate_size"])


def t5_encdec_step_flops(cfg: dict, seq: int) -> float:
    """One passage of ``seq`` tokens through a T5 encoder, then one decoder
    step fed the start token (the dense-retrieval rep): the encoder's
    products and attention, and per decoder layer the self-attention of
    one token, the cross-attention's query and output of one token, its
    keys and values over the ``seq`` encoder states, its attention over
    them, and the FFN of one token. The LM head's logits are left out: the
    rep does not need them."""
    d, inner = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"]
    ff = cfg["d_ff"]
    mats = 3 if str(cfg.get("feed_forward_proj", "relu")).startswith(
        "gated") else 2
    enc_layer = (2 * seq * (4 * d * inner + mats * d * ff)
                 + 4 * seq * seq * inner)
    dec_layer = (2 * 4 * d * inner + 4 * inner   # self-attention, 1 token
                 + 2 * 2 * d * inner             # cross q and o
                 + 2 * 2 * seq * d * inner       # cross k and v
                 + 4 * seq * inner               # cross scores and sum
                 + 2 * mats * d * ff)            # FFN
    return float(cfg["num_layers"] * enc_layer
                 + cfg.get("num_decoder_layers", cfg["num_layers"])
                 * dec_layer)


def dr_train_step_flops(cfg: dict, n_queries: int, n_passages: int,
                        q_len: int, p_len: int) -> float:
    """One contrastive step of a BERT bi-encoder: forward and backward
    (3 x the forward) of every query and passage at its padded length,
    plus the score matrix of the loss, forward and backward."""
    fwd = (n_queries * bert_config_flops(cfg, q_len)
           + n_passages * bert_config_flops(cfg, p_len))
    loss = 2.0 * n_queries * n_passages * cfg["hidden_size"]
    return 3.0 * (fwd + loss)


def search_query_flops(cfg: dict, q_len: int, n_docs: int) -> float:
    """One query of an exact search: its encoder pass at ``q_len`` and its
    score against every document (2 x n_docs x hidden). The program's
    rescore of its selected blocks repeats scores already counted and is
    left out."""
    return bert_config_flops(cfg, q_len) + 2.0 * n_docs * cfg["hidden_size"]


def mfu_pct(flops: float, seconds: float) -> float:
    """``flops`` done in ``seconds`` as a share of the bf16 peak, in %."""
    return 100.0 * flops / (seconds * BF16_FLOPS)
