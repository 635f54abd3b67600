"""Contrastive supervision synthesis: T5 query generation and ContrastQG
(port of ``openmatch_tpu/research/qg.py``).

The recipe: (1) train a seed QG model passage -> query; (2) train
ContrastQG on (doc+, doc-) -> query; (3) the pipeline generates a seed
query for each target-domain doc, retrieves with BM25 to pick contrast
doc pairs, generates contrastive queries, and writes synthetic
(query, doc+, doc-) training triples (``drivers/qg_synthesis.py``).

``QGModel`` wraps ``models.t5.T5Seq2Seq`` (teacher forcing) with greedy or
temperature decoding. The ContrastQG input is one encoder sequence,
"positive: <doc+> negative: <doc->". Sampling draws from an explicit
``torch.Generator``; with ``temperature > 0`` and none given, the
functions seed one with 0, as the JAX versions seed ``PRNGKey(0)``.
"""

from __future__ import annotations

import json
import logging
import random
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.collators import pad_ids
from ..device import resolve_device
from ..models.t5 import (T5Config, T5Seq2Seq, greedy_generate, load_t5_encdec,
                         seq2seq_loss, shift_right)

logger = logging.getLogger(__name__)


class QGModel:
    """Trainer and generator around ``T5Seq2Seq``: the model is
    ``self.model``, on ``device`` (the card unless the caller names the
    CPU)."""

    def __init__(self, config: T5Config, state_dict=None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.model = T5Seq2Seq(config, dtype)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()

    @classmethod
    def from_pretrained(cls, model_name_or_path: str,
                        dtype: torch.dtype = torch.float32,
                        device="cuda") -> "QGModel":
        """An HF T5 directory (``config.json`` and its weights)."""
        device = resolve_device(device)
        cfg, state = load_t5_encdec(model_name_or_path)
        return cls(cfg, state, dtype=dtype, device=device)

    @torch.no_grad()
    def init_params(self, seed: int = 0):
        """Seeded weights under flax's default laws: ``Dense`` kernels
        truncated normal with variance 1 / fan_in, ``shared`` normal with
        variance 1 / d_model, the position-bias tables normal(1), the norms
        ones."""
        g = torch.Generator().manual_seed(seed)
        for name, p in self.model.named_parameters():
            cpu = torch.empty(p.shape)
            if name.endswith("rel_bias"):
                cpu.normal_(0.0, 1.0, generator=g)
            elif name.endswith("ln.weight"):
                cpu.fill_(1.0)
            elif name == "shared.weight":
                cpu.normal_(0.0, self.config.d_model ** -0.5, generator=g)
            else:  # [out, in] linear weights
                std = p.shape[1] ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
            p.copy_(cpu)
        return self.model.state_dict()

    # -- training -------------------------------------------------------

    def loss(self, batch: Dict) -> torch.Tensor:
        """``batch``: input_ids / attention_mask (the source doc), labels
        [B, T] (the target query's ids, pad 0) and label_mask."""
        t = {k: torch.as_tensor(np.asarray(v)).to(self.device)
             for k, v in batch.items()}
        dec_in = shift_right(t["labels"].long(),
                             self.config.decoder_start_token_id,
                             self.config.pad_token_id)
        out = self.model(t["input_ids"], t["attention_mask"], dec_in)
        return seq2seq_loss(out["logits"], t["labels"], t["label_mask"])

    def make_train_step(self, optimizer, scheduler=None):
        """``step(batch) -> loss``: one update of ``self.model`` by
        ``optimizer`` (e.g. ``train.state.make_optimizer`` over
        ``self.model.parameters()``), then ``scheduler.step()``."""
        def step(batch):
            self.model.train()
            optimizer.zero_grad(set_to_none=True)
            loss = self.loss(batch)
            loss.backward()
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            self.model.eval()
            return loss.detach()

        return step

    # -- generation -----------------------------------------------------

    def generate(self, input_ids, attention_mask, max_new_tokens: int = 32,
                 eos_token_id: int = 1, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, max_new_tokens] ids on the model's device."""
        ids = torch.as_tensor(np.asarray(input_ids)).to(self.device)
        mask = torch.as_tensor(np.asarray(attention_mask)).to(self.device)
        return greedy_generate(self.model, ids, mask, max_new_tokens,
                               eos_token_id, temperature, generator)


def _decode_generated(tokenizer, ids, eos_token_id: int = 1) -> str:
    ids = [int(t) for t in ids]
    if eos_token_id in ids:
        ids = ids[: ids.index(eos_token_id)]
    return tokenizer.decode(ids, skip_special_tokens=True).strip()


def _sampling_generator(qg: QGModel, temperature: float,
                        generator: Optional[torch.Generator]):
    if temperature and generator is None:
        generator = torch.Generator(device=qg.device).manual_seed(0)
    return generator


def _generate_texts(qg: QGModel, tokenizer, sources: List[List[int]],
                    max_src_len: int, max_new_tokens: int,
                    temperature: float, eos_token_id: int,
                    generator) -> List[str]:
    batch = pad_ids(sources, max_src_len, qg.config.pad_token_id)
    gen = qg.generate(batch["input_ids"], batch["attention_mask"],
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      eos_token_id=eos_token_id, generator=generator)
    return [_decode_generated(tokenizer, g, eos_token_id)
            for g in gen.cpu().numpy()]


def generate_seed_queries(
    qg: QGModel,
    tokenizer,
    corpus: Dict[str, str],
    doc_ids: Optional[List[str]] = None,
    max_src_len: int = 256,
    max_new_tokens: int = 24,
    batch_size: int = 16,
    temperature: float = 0.0,
    eos_token_id: int = 1,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, str]:
    """One seed query per target-domain document from the trained QG
    model: {doc_id: query_text}, empty generations dropped."""
    generator = _sampling_generator(qg, temperature, generator)
    ids = list(doc_ids if doc_ids is not None else corpus.keys())
    out: Dict[str, str] = {}
    for i in range(0, len(ids), batch_size):
        chunk = ids[i: i + batch_size]
        enc = [tokenizer(corpus[d], truncation=True,
                         max_length=max_src_len)["input_ids"]
               for d in chunk]
        texts = _generate_texts(qg, tokenizer, enc, max_src_len,
                                max_new_tokens, temperature, eos_token_id,
                                generator)
        for d, q in zip(chunk, texts):
            if q:
                out[d] = q
    return out


def make_contrast_input(tokenizer, pos_doc: str, neg_doc: str,
                        max_len: int) -> List[int]:
    """'positive: <doc+> negative: <doc->' encoder sequence."""
    text = f"positive: {pos_doc} negative: {neg_doc}"
    return tokenizer(text, truncation=True, max_length=max_len)["input_ids"]


def build_contrast_pairs(
    run: Dict[str, Dict[str, float]],
    seed_doc_of_query: Dict[str, str],
    top_rank_pos: int = 1,
    neg_rank_range: Tuple[int, int] = (50, 100),
    seed: int = 0,
) -> Iterable[Tuple[str, str, str]]:
    """From a BM25 run over seed queries, yield (qid, pos_doc_id,
    neg_doc_id): pos = the seed query's source doc (or the top hit), neg
    drawn from a lower rank band (the same ``random.Random(seed)`` draws as
    JAX's)."""
    rng = random.Random(seed)
    for qid, docs in run.items():
        ranked = [d for d, _ in sorted(docs.items(), key=lambda kv: kv[1],
                                       reverse=True)]
        if not ranked:
            continue
        pos = seed_doc_of_query.get(qid, ranked[0])
        lo, hi = neg_rank_range
        band = [d for d in ranked[lo:hi] if d != pos]
        if not band:
            band = [d for d in ranked[top_rank_pos:] if d != pos]
        if not band:
            continue
        yield qid, pos, rng.choice(band)


def synthesize_training_data(
    qg: QGModel,
    tokenizer,
    corpus: Dict[str, str],
    pairs: Iterable[Tuple[str, str, str]],
    out_path: str,
    max_src_len: int = 256,
    max_new_tokens: int = 24,
    batch_size: int = 16,
    temperature: float = 0.0,
    eos_token_id: int = 1,
    generator: Optional[torch.Generator] = None,
) -> int:
    """Generate contrastive queries for (pos, neg) doc pairs and write
    OpenMatch train jsonl; returns the number of examples written."""
    generator = _sampling_generator(qg, temperature, generator)
    pair_list = list(pairs)
    n = 0
    with open(out_path, "w") as f:
        for i in range(0, len(pair_list), batch_size):
            chunk = pair_list[i: i + batch_size]
            enc = [make_contrast_input(tokenizer, corpus[p], corpus[ng],
                                       max_src_len)
                   for _, p, ng in chunk]
            texts = _generate_texts(qg, tokenizer, enc, max_src_len,
                                    max_new_tokens, temperature,
                                    eos_token_id, generator)
            for (_, pos, neg), query in zip(chunk, texts):
                if not query:
                    continue
                f.write(json.dumps({
                    "query": query,
                    "positives": [corpus[pos]],
                    "negatives": [corpus[neg]],
                }) + "\n")
                n += 1
    return n
