"""Plain BERT encoder in float32, from HF ``BertModel``'s equations.

Reads the HF-named weights the benchmark drew, imports nothing of the
program. Embeddings (word + position + token type) and LayerNorm; per
layer, self-attention with the scores scaled by 1/sqrt(head size) and
masked keys set to float32's lowest value, the output projection, a
residual and LayerNorm, then the exact-erf GELU FFN, a residual and
LayerNorm. The [CLS] row of the last layer is the dense-retrieval rep.
``precision="fp8"`` rounds every product's operands and the hidden
states between sublayers to fp8 (the control)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .quant import activation, linear, matmul


def encode(w: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
           mask: torch.Tensor, precision: Optional[str] = None
           ) -> torch.Tensor:
    """Token ids [B, S] and mask [B, S] -> last hidden states [B, S, d]."""
    B, S = ids.shape
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = d // H
    eps = cfg["layer_norm_eps"]
    pos = torch.arange(S, device=ids.device)
    x = (w["embeddings.word_embeddings.weight"][ids.long()]
         + w["embeddings.position_embeddings.weight"][pos][None]
         + w["embeddings.token_type_embeddings.weight"][0][None, None])
    x = activation(F.layer_norm(x, (d,), w["embeddings.LayerNorm.weight"],
                                w["embeddings.LayerNorm.bias"], eps),
                   precision)
    neg = torch.finfo(torch.float32).min
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, neg)
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}"

        def lin(name, h):
            return linear(h, w[f"{p}.{name}.weight"], w[f"{p}.{name}.bias"],
                          precision)

        def heads(t):
            return t.view(B, S, H, hd).transpose(1, 2)

        q = heads(lin("attention.self.query", x))
        k = heads(lin("attention.self.key", x))
        v = heads(lin("attention.self.value", x))
        scores = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(hd)
        probs = torch.softmax(scores + bias, dim=-1)
        ctx = matmul(probs, v, precision).transpose(1, 2).reshape(B, S, d)
        x = activation(F.layer_norm(
            x + lin("attention.output.dense", ctx), (d,),
            w[f"{p}.attention.output.LayerNorm.weight"],
            w[f"{p}.attention.output.LayerNorm.bias"], eps), precision)
        h = F.gelu(lin("intermediate.dense", x), approximate="none")
        x = activation(F.layer_norm(
            x + lin("output.dense", h), (d,),
            w[f"{p}.output.LayerNorm.weight"],
            w[f"{p}.output.LayerNorm.bias"], eps), precision)
    return x


def reps(w, cfg: dict, ids, mask, precision: Optional[str] = None):
    """The [CLS] rep [B, d] of each row (``pooling: first``)."""
    return encode(w, cfg, ids, mask, precision)[:, 0]
