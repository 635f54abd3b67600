"""The v1 neural rerankers: KNRM, Conv-KNRM, TK, EDRM, BertRanker and
BertMaxP (port of ``openmatch_tpu/v1/models.py``).

Each model scores a (query, doc) pair and returns ``(score, feats)``: the
``ranking`` task gives a scalar score, ``classification`` two logits.
Submodules carry the Flax modules' names, so ``models/jax_convert.py``'s
``v1_params_from_jax`` / ``v1_params_to_jax`` map one tree onto the other.
``INPUTS`` names the batch keys ``score_batch`` passes to ``forward``, in
order (the collators of ``v1/dataset.py`` and ``v1/long_doc.py`` make
them).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.bert import BertConfig, BertEncoder
from .kernel_matcher import KernelMatcher
from .modules import Conv1DEncoder, Embedder, TransformerEncoder, dense

WORD_INPUTS = ("query_idx", "query_mask", "doc_idx", "doc_mask")
BERT_INPUTS = ("input_ids", "input_mask", "segment_ids")


def _task_head(task: str, in_dim: int) -> nn.Linear:
    if task == "ranking":
        return dense(in_dim, 1)
    if task == "classification":
        return dense(in_dim, 2)
    raise ValueError("Task must be `ranking` or `classification`.")


def _squeeze_score(score: torch.Tensor) -> torch.Tensor:
    return score[..., 0] if score.shape[-1] == 1 else score


class V1Model(nn.Module):
    INPUTS: Tuple[str, ...] = WORD_INPUTS
    num_heads = 1  # splits attention weights in the Flax layout

    def score_batch(self, batch: Dict[str, torch.Tensor]):
        """``forward`` on the batch's ``INPUTS`` -> (score, feats)."""
        return self(*(batch[k] for k in self.INPUTS))


class KNRM(V1Model):
    """Kernel pooling over the raw-embedding cosine match matrix."""

    def __init__(self, vocab_size: int, embed_dim: int, kernel_num: int = 21,
                 task: str = "ranking"):
        super().__init__()
        self.embedder = Embedder(vocab_size, embed_dim)
        self.matcher = KernelMatcher(kernel_num)
        self.dense = _task_head(task, kernel_num)

    def forward(self, query_ids, query_masks, doc_ids, doc_masks):
        logits = self.matcher(self.embedder(query_ids), query_masks,
                              self.embedder(doc_ids), doc_masks)
        return _squeeze_score(self.dense(logits)), logits


class ConvKNRM(V1Model):
    """n-gram convolution encodings cross-matched with kernel pooling:
    len(sizes)^2 matcher calls, concatenated."""

    def __init__(self, vocab_size: int, embed_dim: int, kernel_num: int = 21,
                 kernel_dim: int = 128, kernel_sizes: Sequence[int] = (1, 2, 3),
                 task: str = "ranking"):
        super().__init__()
        self.embedder = Embedder(vocab_size, embed_dim)
        self.encoder = Conv1DEncoder(embed_dim, kernel_dim, kernel_sizes)
        self.matcher = KernelMatcher(kernel_num)
        self.dense = _task_head(task, kernel_num * len(kernel_sizes) ** 2)

    def forward(self, query_ids, query_masks, doc_ids, doc_masks):
        _, q_encs = self.encoder(self.embedder(query_ids), query_masks)
        _, d_encs = self.encoder(self.embedder(doc_ids), doc_masks)
        n = len(q_encs)
        logits = self.matcher.cross(q_encs, [query_masks] * n, d_encs,
                                    [doc_masks] * n)
        return _squeeze_score(self.dense(logits)), logits


class TK(V1Model):
    """Transformer-contextualised kernel ranking: a learned mixer blends
    the raw embeddings with the transformer's before kernel pooling."""

    def __init__(self, vocab_size: int, embed_dim: int, head_num: int = 10,
                 hidden_dim: int = 100, layer_num: int = 2,
                 kernel_num: int = 21, task: str = "ranking"):
        super().__init__()
        self.embedder = Embedder(vocab_size, embed_dim)
        self.num_heads = head_num
        self.encoder = TransformerEncoder(embed_dim, head_num, hidden_dim,
                                          layer_num)
        self.mixer = nn.Parameter(torch.full((1, 1, 1), 0.5))
        self.matcher = KernelMatcher(kernel_num)
        self.dense = _task_head(task, kernel_num)

    def forward(self, query_ids, query_masks, doc_ids, doc_masks):
        q_embed = self.embedder(query_ids)
        d_embed = self.embedder(doc_ids)
        q_ctx = self.encoder(q_embed, query_masks)
        d_ctx = self.encoder(d_embed, doc_masks)
        q_mix = self.mixer * q_embed + (1 - self.mixer) * q_ctx
        d_mix = self.mixer * d_embed + (1 - self.mixer) * d_ctx
        logits = self.matcher(q_mix, query_masks, d_mix, doc_masks)
        return _squeeze_score(self.dense(logits)), logits


class EDRM(V1Model):
    """Entity-Duet ranking: word n-gram encodings plus an entity channel
    enriched by a convolution and max-pool over the entities' descriptions;
    (n_sizes + 1)^2 cross matcher calls."""

    INPUTS = ("query_wrd_idx", "query_wrd_mask", "doc_wrd_idx",
              "doc_wrd_mask", "query_ent_idx", "query_ent_mask",
              "doc_ent_idx", "doc_ent_mask", "query_des_idx", "doc_des_idx")

    def __init__(self, wrd_vocab_size: int, ent_vocab_size: int,
                 wrd_embed_dim: int, ent_embed_dim: int, max_des_len: int = 20,
                 max_ent_num: int = 3, kernel_num: int = 21,
                 kernel_dim: int = 128, kernel_sizes: Sequence[int] = (1, 2, 3),
                 task: str = "ranking"):
        super().__init__()
        if ent_embed_dim != kernel_dim:
            raise ValueError("ent_embed_dim must equal kernel_dim.")
        self.wrd_embed_dim = wrd_embed_dim
        self.max_des_len = max_des_len
        self.max_ent_num = max_ent_num
        self.wrd_embedder = Embedder(wrd_vocab_size, wrd_embed_dim)
        self.ent_embedder = Embedder(ent_vocab_size, ent_embed_dim)
        self.wrd_encoder = Conv1DEncoder(wrd_embed_dim, kernel_dim,
                                         kernel_sizes)
        self.des_encoder = Conv1DEncoder(wrd_embed_dim * max_ent_num,
                                         kernel_dim, (1,))
        self.matcher = KernelMatcher(kernel_num)
        self.dense = _task_head(task,
                                kernel_num * (len(kernel_sizes) + 1) ** 2)

    def _entity_channel(self, ent_embed, des_embed):
        """The entity embedding plus a max-pool over the conv-encoded
        description window."""
        B = des_embed.shape[0]
        des = des_embed.reshape(B, -1, self.wrd_embed_dim * self.max_ent_num)
        _, des_encs = self.des_encoder(des)
        win = self.max_des_len - self.max_ent_num + 1
        seq = des_encs[0]
        n_ent = seq.shape[1] // win
        pooled = seq[:, : n_ent * win].reshape(B, n_ent, win, -1).max(
            dim=2).values
        return ent_embed + pooled

    def forward(self, query_wrd_ids, query_wrd_masks, doc_wrd_ids,
                doc_wrd_masks, query_ent_ids, query_ent_masks, doc_ent_ids,
                doc_ent_masks, query_des_ids, doc_des_ids):
        _, q_encs = self.wrd_encoder(self.wrd_embedder(query_wrd_ids),
                                     query_wrd_masks)
        _, d_encs = self.wrd_encoder(self.wrd_embedder(doc_wrd_ids),
                                     doc_wrd_masks)
        q_encs = list(q_encs) + [self._entity_channel(
            self.ent_embedder(query_ent_ids),
            self.wrd_embedder(query_des_ids))]
        d_encs = list(d_encs) + [self._entity_channel(
            self.ent_embedder(doc_ent_ids), self.wrd_embedder(doc_des_ids))]
        n = len(q_encs)
        logits = self.matcher.cross(
            q_encs, [query_wrd_masks] * (n - 1) + [query_ent_masks],
            d_encs, [doc_wrd_masks] * (n - 1) + [doc_ent_masks])
        return _squeeze_score(self.dense(logits)), logits


def _bert_rep(outputs: dict, mode: str) -> torch.Tensor:
    if mode == "cls":
        return outputs["last_hidden_state"][:, 0, :]
    if mode == "pooling":
        return outputs["pooler_output"]
    raise ValueError("Mode must be `cls` or `pooling`.")


class BertRanker(V1Model):
    """A BERT-family cross-encoder: the [CLS] or pooler rep -> task head.
    The encoder computes in fp32, as the JAX driver builds it."""

    INPUTS = BERT_INPUTS

    def __init__(self, config: BertConfig, mode: str = "cls",
                 task: str = "ranking"):
        super().__init__()
        self.mode = mode
        self.num_heads = config.num_attention_heads
        self.bert = BertEncoder(config)
        self.dense = _task_head(task, config.hidden_size)

    def forward(self, input_ids, input_mask, segment_ids=None):
        logits = _bert_rep(self.bert(input_ids, input_mask, segment_ids),
                           self.mode)
        return _squeeze_score(self.dense(logits)), logits


class BertMaxP(V1Model):
    """Long documents by chunk and max-pool: the doc is split into
    ``num_passages`` BERT inputs ([B, P, L], run as one [B*P, L] batch);
    the per-passage reps are max-pooled, then scored by a ReLU MLP."""

    INPUTS = BERT_INPUTS

    def __init__(self, config: BertConfig, num_passages: int = 4,
                 mode: str = "cls", task: str = "ranking"):
        super().__init__()
        self.num_passages = num_passages
        self.mode = mode
        self.num_heads = config.num_attention_heads
        self.bert = BertEncoder(config)
        self.dense1 = dense(config.hidden_size, 128)
        self.dense2 = _task_head(task, 128)

    def forward(self, input_ids, input_mask, segment_ids=None):
        B, P, L = input_ids.shape
        assert P == self.num_passages

        def flat(x):
            return None if x is None else x.reshape(B * P, L)

        reps = _bert_rep(self.bert(flat(input_ids), flat(input_mask),
                                   flat(segment_ids)), self.mode)
        reps = reps.reshape(B, P, -1).max(dim=1).values
        hidden = F.relu(self.dense1(reps))
        return _squeeze_score(self.dense2(hidden)), hidden
