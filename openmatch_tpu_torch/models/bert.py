"""BERT-family encoder (BERT / RoBERTa / ELECTRA) as a PyTorch module.

Port of ``openmatch_tpu/models/bert.py`` with its precision points:
parameters are fp32 and every layer computes in ``dtype`` (bf16 on the
serving path); attention logits and softmax are fp32, probabilities are
cast back to ``dtype``; LayerNorm statistics are fp32; the additive
attention mask is finfo(float32).min. Attention is plain matmul and
softmax, as the JAX version is plain einsums (no kernel there either).

Dropout sits where the JAX version puts it: on the embeddings after
``embeddings_ln``, on the attention probabilities, on the attention output
before ``attention_ln`` and on the FFN output before ``output_ln``. It runs
only in training mode and only when ``forward`` is given a
``torch.Generator``: masks are drawn from that generator alone (never the
global RNG), so GradCache can replay a chunk with the same masks by
restoring the generator's state. Without one the graph is the
dropout-free serving graph.

Parameter layout follows PyTorch (``nn.Linear.weight`` is [out, in]); the
fused QKV projection is one [3*d, d] linear whose rows are q, k, v, each
head-major. ``models/jax_convert.py`` maps the Flax tree onto it.

Tensor parallelism (``parallel/tp.py``): the attention reads its head count
from its local ``qkv`` rows, so one module serves tp = 1 and tp > 1; a
block's ``tp`` (None unless ``tp.shard_model`` set it) puts the
copy-to-model-group before the column-parallel products and the
reduce-from-model-group after the row-parallel ones.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

ACT2FN = {
    # HF "gelu" is the exact erf GELU
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "tanh": torch.tanh,
}


@dataclass(frozen=True)
class BertConfig:
    """Same fields and defaults as ``openmatch_tpu.models.bert.BertConfig``,
    so ``openmatch_config.json`` files load in both packages."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    position_offset: int = 0  # RoBERTa: pad_token_id + 1
    embedding_size: Optional[int] = None  # ELECTRA: embed small, project up
    add_pooler: bool = False
    hidden_dropout_prob: float = 0.0  # training only; unused when serving
    attention_probs_dropout_prob: float = 0.0

    def to_dict(self):
        return dataclasses.asdict(self)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale by
    1 / (1 - rate), masks drawn from ``generator``; identity without one."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=generator)
    return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32, output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in x's dtype (fp32 parameters cast per call)."""
    bias = layer.bias.to(x.dtype) if layer.bias is not None else None
    return F.linear(x, layer.weight.to(x.dtype), bias)


def copy_in(x: torch.Tensor, tp) -> torch.Tensor:
    """``x`` entering column-parallel products (``tp``: a ``TPContext`` or
    None)."""
    return x if tp is None else tp.copy_in(x)


def row_linear(x: torch.Tensor, layer: nn.Linear, tp) -> torch.Tensor:
    """A row-parallel ``linear``: under ``tp`` the partial products are
    summed over the model group, then the bias is added once."""
    if tp is None:
        return linear(x, layer)
    y = tp.reduce_out(F.linear(x, layer.weight.to(x.dtype)))
    return y + layer.bias.to(x.dtype) if layer.bias is not None else y


class BertSelfAttention(nn.Module):
    tp = None

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.probs_rate = cfg.attention_probs_dropout_prob
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden: torch.Tensor, attention_bias: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S, _ = hidden.shape
        dtype = hidden.dtype
        n_heads = self.qkv.weight.shape[0] // (3 * self.head_dim)  # local
        qkv = linear(copy_in(hidden, self.tp), self.qkv).view(
            B, S, 3, n_heads, self.head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B,H,S,hd]
        # 1 / sqrt(hd) rounded as the JAX version rounds it
        scale = 1.0 / torch.tensor(float(self.head_dim)).sqrt().to(dtype)
        # bf16 operands are exact in fp32, so upcasting and multiplying in
        # fp32 is the JAX einsum with preferred_element_type=float32
        logits = (q * scale).float() @ k.float().transpose(-1, -2)
        logits = logits + attention_bias  # [B, 1, 1, S] fp32
        probs = torch.softmax(logits, dim=-1).to(dtype)
        probs = dropout(probs, self.probs_rate, generator)
        ctx = (probs.float() @ v.float()).to(dtype)  # [B, H, S, hd]
        ctx = ctx.transpose(1, 2).reshape(B, S, -1)
        return row_linear(ctx, self.out, self.tp)


class BertLayer(nn.Module):
    tp = None

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertSelfAttention(cfg)
        self.attention_ln = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.output_ln = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.act = ACT2FN[cfg.hidden_act]
        self.hidden_rate = cfg.hidden_dropout_prob

    def forward(self, hidden, attention_bias, generator=None):
        attn = self.attention(hidden, attention_bias, generator)
        attn = dropout(attn, self.hidden_rate, generator)
        hidden = self.attention_ln(hidden + attn)
        ffn = row_linear(self.act(linear(copy_in(hidden, self.tp),
                                         self.intermediate)),
                         self.output, self.tp)
        ffn = dropout(ffn, self.hidden_rate, generator)
        return self.output_ln(hidden + ffn)


class BertEncoder(nn.Module):
    """Returns {"last_hidden_state": [B, S, d]} (plus "pooler_output"
    when ``config.add_pooler``), computed in ``dtype``."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        emb = cfg.embedding_size or cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, emb)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                emb)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, emb)
        self.embeddings_ln = LayerNorm(emb, eps=cfg.layer_norm_eps)
        self.embeddings_project = (
            nn.Linear(emb, cfg.hidden_size)
            if cfg.embedding_size and cfg.embedding_size != cfg.hidden_size
            else None)
        self.layers = nn.ModuleList(BertLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.pooler = (nn.Linear(cfg.hidden_size, cfg.hidden_size)
                       if cfg.add_pooler else None)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """``generator`` turns dropout on, in training mode only."""
        cfg = self.config
        if not self.training:
            generator = None
        B, S = input_ids.shape
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if cfg.position_offset:
            # RoBERTa: positions count non-pad tokens, offset by pad_id + 1
            positions = torch.cumsum(attention_mask, dim=-1) * attention_mask
            positions = positions + cfg.position_offset - 1
        else:
            positions = torch.arange(S, device=input_ids.device).expand(B, S)
        hidden = (self.word_embeddings(input_ids).to(self.dtype)
                  + self.position_embeddings(positions.long()).to(self.dtype)
                  + self.token_type_embeddings(token_type_ids.long()).to(
                      self.dtype))
        hidden = self.embeddings_ln(hidden)
        hidden = dropout(hidden, cfg.hidden_dropout_prob, generator)
        if self.embeddings_project is not None:
            hidden = linear(hidden, self.embeddings_project)

        neg = torch.finfo(torch.float32).min
        bias = torch.where(attention_mask[:, None, None, :] > 0,
                           0.0, neg).to(torch.float32)
        for layer in self.layers:
            hidden = layer(hidden, bias, generator)
        outputs = {"last_hidden_state": hidden}
        if self.pooler is not None:
            outputs["pooler_output"] = torch.tanh(
                linear(hidden[:, 0], self.pooler))
        return outputs
