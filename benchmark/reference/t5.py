"""Plain T5 in float32, from HF ``T5Model``'s equations: the encoder, then
one decoder step fed the start token, whose final hidden state is the
dense-retrieval rep (``t5_encdec``).

Reads the HF-named weights the benchmark drew, imports nothing of the
program. RMS norm (no mean, no bias), attention without the 1/sqrt
scaling, a relative-position bias from layer 0's table shared by every
layer (bidirectional log buckets in the encoder, causal in the decoder),
masked keys at float32's lowest value, the ReLU FFN, residuals around
each block, and a final RMS norm per stack. Cross-attention takes the
mask and no position bias. ``precision="fp8"`` rounds every product's
operands and the hidden states between sublayers to fp8 (the
control)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .quant import activation, linear, matmul


def bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
           max_distance: int) -> torch.Tensor:
    """HF T5's ``_relative_position_bucket`` of ``rel`` = key - query."""
    out = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        out += (rel > 0).long() * num_buckets
        n = rel.abs()
    else:
        n = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    large = max_exact + (
        torch.log(n.float().clamp_min(1) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return out + torch.where(n < max_exact, n, large)


def rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def _pos_bias(table, q_len, k_len, bidirectional, cfg, device):
    rel = (torch.arange(k_len, device=device)[None, :]
           - torch.arange(q_len, device=device)[:, None])
    b = bucket(rel, bidirectional, cfg["relative_attention_num_buckets"],
               cfg["relative_attention_max_distance"])
    return table[b].permute(2, 0, 1)[None]  # [1, H, q, k]


def _attention(w, p, x, kv, bias, cfg, precision):
    B, Sq, _ = x.shape
    Sk = kv.shape[1]
    H, dk = cfg["num_heads"], cfg["d_kv"]
    q = linear(x, w[f"{p}.q.weight"], None, precision)
    k = linear(kv, w[f"{p}.k.weight"], None, precision)
    v = linear(kv, w[f"{p}.v.weight"], None, precision)
    q = q.view(B, Sq, H, dk).transpose(1, 2)
    k = k.view(B, Sk, H, dk).transpose(1, 2)
    v = v.view(B, Sk, H, dk).transpose(1, 2)
    probs = torch.softmax(matmul(q, k.transpose(-1, -2), precision) + bias,
                          dim=-1)
    ctx = matmul(probs, v, precision).transpose(1, 2).reshape(B, Sq, H * dk)
    return linear(ctx, w[f"{p}.o.weight"], None, precision)


def _ffn(w, p, x, precision):
    h = F.relu(linear(x, w[f"{p}.DenseReluDense.wi.weight"], None,
                      precision))
    return linear(h, w[f"{p}.DenseReluDense.wo.weight"], None, precision)


def reps(w: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
         mask: torch.Tensor, precision: Optional[str] = None
         ) -> torch.Tensor:
    """Token ids [B, S] and mask [B, S] -> decoder step 0's final hidden
    state [B, d]."""
    if str(cfg.get("feed_forward_proj", "relu")) != "relu":
        raise ValueError("the reference has the ReLU FFN only")
    B, S = ids.shape
    eps = cfg["layer_norm_epsilon"]
    dev = ids.device
    neg = torch.finfo(torch.float32).min
    mask_bias = torch.where(mask[:, None, None, :] > 0, 0.0, neg)
    emb = w["shared.weight"]
    enc_table = w["encoder.block.0.layer.0.SelfAttention."
                  "relative_attention_bias.weight"]
    bias = _pos_bias(enc_table, S, S, True, cfg, dev) + mask_bias
    x = emb[ids.long()]
    for i in range(cfg["num_layers"]):
        p = f"encoder.block.{i}.layer"
        h = rms(x, w[f"{p}.0.layer_norm.weight"], eps)
        x = activation(x + _attention(w, f"{p}.0.SelfAttention", h, h, bias,
                                      cfg, precision), precision)
        x = activation(x + _ffn(w, f"{p}.1", rms(
            x, w[f"{p}.1.layer_norm.weight"], eps), precision), precision)
    enc = activation(rms(x, w["encoder.final_layer_norm.weight"], eps),
                     precision)

    dec_table = w["decoder.block.0.layer.0.SelfAttention."
                  "relative_attention_bias.weight"]
    self_bias = _pos_bias(dec_table, 1, 1, False, cfg, dev)
    y = emb[torch.full((B, 1), cfg.get("decoder_start_token_id", 0),
                       device=dev)]
    for i in range(cfg.get("num_decoder_layers", cfg["num_layers"])):
        p = f"decoder.block.{i}.layer"
        h = rms(y, w[f"{p}.0.layer_norm.weight"], eps)
        y = activation(y + _attention(w, f"{p}.0.SelfAttention", h, h,
                                      self_bias, cfg, precision), precision)
        y = activation(y + _attention(
            w, f"{p}.1.EncDecAttention",
            rms(y, w[f"{p}.1.layer_norm.weight"], eps), enc, mask_bias, cfg,
            precision), precision)
        y = activation(y + _ffn(w, f"{p}.2", rms(
            y, w[f"{p}.2.layer_norm.weight"], eps), precision), precision)
    return activation(rms(y, w["decoder.final_layer_norm.weight"], eps),
                      precision)[:, 0]
