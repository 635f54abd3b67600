"""Cross-encoder reranking model as an ``nn.Module`` (port of
``openmatch_tpu/models/rr_model.py``).

Backbones:

- ``bert``: the pooled rep of a BERT-family encoder through a bias-free
  ``LinearHead(hidden, 1)``: scores [B, 1];
- ``t5`` (monoT5): one decoder step; the score is the logits at
  ``[neg_token, pos_token]``: [B, 2]. Its loss is always ``ce``;
- ``t5enc``: the T5 encoder, pooled, through the head: [B, 1].

``relevance_logprob`` turns two columns into log P(relevant) and passes one
column through. ``save`` and ``load`` read and write the JAX package's
checkpoint directory (``openmatch_config.json`` plus fp32
``params.msgpack``, the bytes JAX ``RRModel.save`` writes for the same
weights); ``load`` refuses a dense-retrieval checkpoint. ``build`` and
``load`` put the model on the card unless the caller names the CPU.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device, resolve_dtype
from ..losses import rr_loss_functions
from .dr_model import (OPENMATCH_CONFIG, _looks_like_t5, config_from_dict,
                       dropout_active, hidden_size, lecun_normal, make_encoder,
                       num_heads)
from .flax_msgpack import read_flax_msgpack, write_flax_msgpack
from .hf_convert import load_bert_encoder
from .jax_convert import params_from_jax, params_to_jax
from .pooling import LinearHead, pool_hidden
from .t5 import load_t5_encdec, load_t5_encoder

# backbone -> the DRModel encoder it runs
_ENCODER_OF = {"bert": "bert", "t5": "t5_encdec", "t5enc": "t5"}


class RRModel(nn.Module):
    def __init__(
        self,
        encoder_config,
        backbone_type: str = "bert",
        feature: str = "last_hidden_state",
        pooling: str = "first",
        pos_token_id: Optional[int] = None,
        neg_token_id: Optional[int] = None,
        head_in_dim: int = 768,
        loss_fn_str: str = "bce",
        margin: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if backbone_type not in _ENCODER_OF:
            raise ValueError(backbone_type)
        self.encoder_config = encoder_config
        self.backbone_type = backbone_type
        self.feature = feature
        self.pooling = pooling
        self.pos_token_id = pos_token_id
        self.neg_token_id = neg_token_id
        self.head_in_dim = head_in_dim
        # monoT5 trains its two-logit score with ce (JAX rr_model.py:51)
        self.loss_fn_str = "ce" if backbone_type == "t5" else loss_fn_str
        self.margin = margin
        self.dtype = dtype
        self.encoder = make_encoder(_ENCODER_OF[backbone_type],
                                    encoder_config, dtype)
        self.head = None if self.is_monot5 else LinearHead(head_in_dim, 1)

    @property
    def is_monot5(self) -> bool:
        return self.backbone_type == "t5"

    @property
    def dropout_active(self) -> bool:
        return dropout_active(self.encoder_config)

    # ---- scoring --------------------------------------------------------

    def score(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
              token_type_ids: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Score concatenated (query, passage) pairs: [B, 1] from the head,
        or [B, 2], the logits at [neg, pos] (monoT5), in ``dtype``. Only
        BERT reads ``token_type_ids``; ``generator`` turns dropout on in
        training mode."""
        if self.backbone_type != "bert":
            token_type_ids = None
        out = self.encoder(input_ids, attention_mask,
                           token_type_ids=token_type_ids, generator=generator)
        if self.is_monot5:
            return out["logits"][:, 0, [self.neg_token_id, self.pos_token_id]]
        reps = pool_hidden(out[self.feature], attention_mask, self.pooling)
        return self.head(reps)

    def loss(self, pos_batch: Dict[str, torch.Tensor],
             neg_batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """The pairwise loss of ``loss_fn_str`` over positive and negative
        pair batches; returns (loss, (pos_scores, neg_scores))."""
        pos_scores = self.score(**pos_batch, generator=generator)
        neg_scores = self.score(**neg_batch, generator=generator)
        if self.loss_fn_str == "ce" and pos_scores.shape[-1] != 2:
            raise ValueError(
                "loss_fn 'ce' requires 2-column scores (monoT5); this "
                f"backbone produces {pos_scores.shape[-1]}-column scores — "
                "use 'mr', 'smr', or 'bce'.")
        fn = rr_loss_functions[self.loss_fn_str]
        if self.loss_fn_str in ("mr", "smr"):
            if pos_scores.shape[-1] == 1:
                loss = fn(pos_scores[:, 0], neg_scores[:, 0],
                          margin=self.margin)
            else:
                loss = fn(pos_scores, neg_scores, margin=self.margin)
        elif self.loss_fn_str == "ce":
            loss = fn(pos_scores, neg_scores)
        else:  # bce over scalar scores
            loss = fn(pos_scores[:, 0], neg_scores[:, 0])
        return loss, (pos_scores, neg_scores)

    @staticmethod
    def relevance_logprob(scores: torch.Tensor) -> torch.Tensor:
        """The ranking score: two columns give log P(relevant) (log-softmax,
        column 1), one column passes through."""
        if scores.shape[-1] == 2:
            return torch.log_softmax(scores, dim=-1)[:, 1]
        return scores[:, 0]

    # ---- construction and persistence -----------------------------------

    def config_dict(self) -> Dict[str, Any]:
        return {
            "plm_backbone": {"type": self.backbone_type,
                             "feature": self.feature},
            "pooling": self.pooling,
            "pos_token_id": self.pos_token_id,
            "neg_token_id": self.neg_token_id,
            "head_in_dim": self.head_in_dim,
            "encoder_config": self.encoder_config.to_dict(),
        }

    @classmethod
    def build(cls, model_args, train_args=None, tokenizer=None,
              device="cuda") -> "RRModel":
        """``ModelArguments`` -> a model on ``device`` (the card unless the
        caller names the CPU), in eval mode: an OpenMatch checkpoint loads;
        a raw HF directory converts as BERT, as monoT5 (a T5 / GTR one), or
        as ``t5enc`` with ``--encoder_only`` (JAX ``RRModel.build``). Each
        of ``--pos_token`` / ``--neg_token`` must tokenize to one id, and
        monoT5 needs both. A new head is drawn from a generator seeded with
        0 (JAX seeds it with ``PRNGKey(0)``)."""
        device = resolve_device(device)
        path = model_args.model_name_or_path
        dtype = resolve_dtype(model_args.dtype)
        if path and os.path.exists(os.path.join(path, OPENMATCH_CONFIG)):
            model = cls.load(path, dtype=dtype, device=device)
        else:
            pos_id = neg_id = None
            if model_args.pos_token and tokenizer is not None:
                pos_id = _single_id(tokenizer, model_args.pos_token,
                                    "--pos_token")
                neg_id = _single_id(tokenizer, model_args.neg_token,
                                    "--neg_token")
            if model_args.encoder_only:
                backbone, (cfg, state) = "t5enc", load_t5_encoder(path)
            elif _looks_like_t5(path):
                backbone, (cfg, state) = "t5", load_t5_encdec(path)
            else:
                backbone, (cfg, state) = "bert", load_bert_encoder(path)
            if backbone == "t5" and (pos_id is None or neg_id is None):
                raise ValueError(
                    "monoT5 reranking scores the decoder logits at the "
                    "[neg, pos] label tokens — pass --pos_token/--neg_token "
                    "(e.g. 'true'/'false', reference reranking_model.py:"
                    "110-114)")
            model = cls(
                encoder_config=cfg, backbone_type=backbone,
                feature=model_args.feature, pooling=model_args.pooling,
                pos_token_id=pos_id, neg_token_id=neg_id,
                head_in_dim=(model_args.projection_in_dim
                             if backbone == "bert" else hidden_size(cfg)),
                dtype=dtype)
            state = {f"encoder.{k}": v for k, v in state.items()}
            if model.head is not None:
                state["head.linear.weight"] = lecun_normal(1,
                                                           model.head_in_dim)
            model.load_state_dict(state, strict=True)
            model = model.to(device).eval()
        if train_args is not None and not model.is_monot5:
            model.loss_fn_str = train_args.loss_fn
            model.margin = train_args.margin
        return model

    def save(self, output_dir: str):
        """``openmatch_config.json`` and fp32 ``params.msgpack`` in the JAX
        package's layout (JAX ``RRModel.save``)."""
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, OPENMATCH_CONFIG), "w") as f:
            json.dump(self.config_dict(), f, indent=4)
        tree = params_to_jax(self.state_dict(), num_heads(self.encoder_config))
        write_flax_msgpack(tree, os.path.join(output_dir, "params.msgpack"))

    def load_weights(self, ckpt_dir: str):
        """Copy ``ckpt_dir/params.msgpack`` into the parameters in place."""
        tree = read_flax_msgpack(os.path.join(ckpt_dir, "params.msgpack"))
        self.load_state_dict(params_from_jax(tree), strict=True)

    @classmethod
    def load(cls, ckpt_dir: str, dtype=torch.float32,
             device="cuda") -> "RRModel":
        """A JAX-package reranker checkpoint -> the model in eval mode on
        ``device``, resolved before anything is read. A dense-retrieval
        checkpoint is refused."""
        device = resolve_device(device)
        with open(os.path.join(ckpt_dir, OPENMATCH_CONFIG)) as f:
            cfg = json.load(f)
        if "tied" in cfg:
            raise ValueError(
                f"{ckpt_dir} is a dense-retrieval (DRModel) checkpoint, not a "
                "reranker; pass it to DRModel/the retrieve drivers instead.")
        backbone = cfg["plm_backbone"]["type"]
        model = cls(
            encoder_config=config_from_dict(
                "bert" if backbone == "bert" else "t5",
                cfg["encoder_config"]),
            backbone_type=backbone,
            feature=cfg["plm_backbone"]["feature"],
            pooling=cfg["pooling"],
            pos_token_id=cfg.get("pos_token_id"),
            neg_token_id=cfg.get("neg_token_id"),
            head_in_dim=cfg.get("head_in_dim", 768),
            dtype=resolve_dtype(dtype),
        )
        model.load_weights(ckpt_dir)
        return model.to(device).eval()


def _single_id(tokenizer, token: str, flag: str) -> int:
    ids = tokenizer.encode(token, add_special_tokens=False)
    if len(ids) != 1:
        raise ValueError(
            f"{flag}={token!r} tokenizes to {len(ids)} pieces ({ids}); "
            "monoT5 scoring needs a single-token label (reference uses "
            "'true'/'false')")
    return ids[0]

