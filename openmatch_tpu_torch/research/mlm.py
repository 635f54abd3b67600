"""Masked-language-model domain-adaptive pretraining (port of
``openmatch_tpu/research/mlm.py``): continue pretraining a BERT encoder on
in-domain text before fine-tuning.

- ``MLMModel``: ``bert`` (the port's ``BertEncoder``), then the MLM
  transform ``transform`` (dense) -> the config's activation ->
  ``transform_ln``, and ``decoder_bias``: the submodules carry the Flax
  module's names, so ``models/jax_convert.py`` maps one tree onto the
  other.
- ``mlm_logits``: the decoder is tied to ``bert.word_embeddings``; the
  product runs in fp32, plus ``decoder_bias``.
- ``mask_tokens``: BERT's 80/10/10 masking of 15% of the tokens that are
  neither special nor padding, drawn from a ``torch.Generator``; the draws
  can also be passed in.
- ``mlm_loss``: cross-entropy over the selected positions (label -100 is
  skipped).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.bert import ACT2FN, BertConfig, BertEncoder, LayerNorm, linear


class MLMModel(nn.Module):
    """Encoder plus MLM transform head; ``forward`` returns the transformed
    hidden states [B, S, d] (the tied decode is ``mlm_logits``)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.bert = BertEncoder(config, dtype)
        self.transform = nn.Linear(config.hidden_size, config.hidden_size)
        self.transform_ln = LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps)
        self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size))

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        hidden = self.bert(input_ids, attention_mask, token_type_ids,
                           generator=generator)["last_hidden_state"]
        x = ACT2FN[self.config.hidden_act](linear(hidden, self.transform))
        return self.transform_ln(x)

    @torch.no_grad()
    def init_head(self, seed: int = 0):
        """The head's weights under flax's defaults: the transform's kernel
        truncated normal with variance 1 / fan_in, zero biases, a unit
        LayerNorm; drawn from a generator seeded with ``seed``."""
        g = torch.Generator().manual_seed(seed)
        d = self.config.hidden_size
        std = d ** -0.5 / 0.87962566103423978
        w = torch.empty(d, d)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
        self.transform.weight.copy_(w)
        self.transform.bias.zero_()
        self.transform_ln.weight.fill_(1.0)
        self.transform_ln.bias.zero_()
        self.decoder_bias.zero_()


def mlm_logits(model: MLMModel, input_ids, attention_mask,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[B, S, vocab] fp32 logits with the decoder tied to the word
    embeddings. The tie needs embedding dim == hidden_size (standard BERT):
    a factorized-embedding checkpoint (``embedding_size`` set, ELECTRA) is
    refused by name."""
    cfg = model.config
    emb_dim = getattr(cfg, "embedding_size", None) or cfg.hidden_size
    if emb_dim != cfg.hidden_size:
        raise ValueError(
            f"MLM head ties the decoder to the word-embedding table, which "
            f"requires embedding_size ({emb_dim}) == hidden_size "
            f"({cfg.hidden_size}); factorized-embedding encoders need a "
            "projection back to the embedding dim, which this head does "
            "not implement")
    x = model(input_ids, attention_mask, generator=generator)
    table = model.bert.word_embeddings.weight
    return torch.matmul(x.float(), table.float().t()) + model.decoder_bias


def mask_tokens(
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    mask_token_id: int,
    vocab_size: int,
    special_ids: Sequence[int] = (0, 101, 102, 103),
    mlm_probability: float = 0.15,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked_ids, labels); labels are -100 where nothing is predicted.

    ``draws`` = (select uniform, action uniform, random ids), each of
    ``input_ids``' shape, replaces the generator's draws (a test feeds the
    JAX version's)."""
    if draws is None:
        shape, dev = input_ids.shape, input_ids.device
        draws = (torch.rand(shape, generator=generator, device=dev),
                 torch.rand(shape, generator=generator, device=dev),
                 torch.randint(0, vocab_size, shape, generator=generator,
                               device=dev))
    u_select, u_action, random_ids = draws
    special = torch.zeros_like(input_ids, dtype=torch.bool)
    for sid in special_ids:
        special |= input_ids == sid
    eligible = (attention_mask > 0) & ~special
    selected = (u_select < mlm_probability) & eligible
    labels = torch.where(selected, input_ids, -100)
    masked = torch.where(selected & (u_action < 0.8), mask_token_id,
                         input_ids)
    masked = torch.where(selected & (u_action >= 0.8) & (u_action < 0.9),
                         random_ids.to(input_ids.dtype), masked)
    return masked, labels


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is not -100."""
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    losses = torch.logsumexp(logits, -1) - logits.gather(
        -1, safe[..., None])[..., 0]
    return (losses * valid).sum() / torch.clamp(valid.sum(), min=1)
