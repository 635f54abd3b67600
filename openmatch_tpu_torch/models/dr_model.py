"""Bi-encoder dense retrieval model as an ``nn.Module``.

Port of ``openmatch_tpu/models/dr_model.py``: tied or untied query/passage
towers, "first"/"mean" pooling, an optional bias-free head and optional L2
normalisation. ``DRModel.load`` and ``DRModel.save`` read and write the JAX
package's checkpoint directory (``openmatch_config.json`` plus flax-msgpack
``params.msgpack``) through the port's own codec (``models/flax_msgpack``),
so a model trained in either package serves in the other. ``DRModel.build``
also converts a raw HuggingFace BERT / RoBERTa / ELECTRA directory
(``models/hf_convert``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..device import resolve_device, resolve_dtype
from .bert import BertConfig, BertEncoder
from .flax_msgpack import read_flax_msgpack, write_flax_msgpack
from .hf_convert import load_bert_encoder
from .jax_convert import params_from_jax, params_to_jax
from .pooling import LinearHead, pool_hidden

OPENMATCH_CONFIG = "openmatch_config.json"
_T5_TODO = ("T5 backbones ({}) are not ported to PyTorch yet; they follow "
            "in the port's T5 step (ROADMAP.md, P7)")


class DRModel(nn.Module):
    def __init__(
        self,
        encoder_config: BertConfig,
        backbone_type: str = "bert",
        tied: bool = True,
        feature: str = "last_hidden_state",
        pooling: str = "first",
        normalize: bool = False,
        has_head: bool = False,
        head_in_dim: int = 768,
        head_out_dim: int = 768,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if backbone_type in ("t5", "t5_encdec"):
            raise NotImplementedError(_T5_TODO.format(backbone_type))
        if backbone_type != "bert":
            raise ValueError(f"Unknown backbone type {backbone_type}")
        self.encoder_config = encoder_config
        self.backbone_type = backbone_type
        self.tied = tied
        self.feature = feature
        self.pooling = pooling
        self.normalize = normalize
        self.has_head = has_head
        self.head_in_dim = head_in_dim
        self.head_out_dim = head_out_dim
        self.dtype = dtype
        self.encoder_q = BertEncoder(encoder_config, dtype)
        self.encoder_p = None if tied else BertEncoder(encoder_config, dtype)
        self.head_q = LinearHead(head_in_dim, head_out_dim) if has_head else None
        self.head_p = (LinearHead(head_in_dim, head_out_dim)
                       if has_head and not tied else None)

    @property
    def out_dim(self) -> int:
        return self.head_out_dim if self.has_head \
            else self.encoder_config.hidden_size

    @property
    def dropout_active(self) -> bool:
        """True when the encoder config carries nonzero dropout rates (the
        trainer then passes a generator; inference never does)."""
        c = self.encoder_config
        return bool(c.hidden_dropout_prob or c.attention_probs_dropout_prob)

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               is_query: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token ids [B, S] -> representations [B, D] in ``dtype``.
        ``generator`` turns dropout on in training mode (``bert.dropout``)."""
        query_tower = is_query or self.tied
        encoder = self.encoder_q if query_tower else self.encoder_p
        head = self.head_q if query_tower else self.head_p
        hidden = encoder(input_ids, attention_mask,
                         generator=generator)[self.feature]
        reps = pool_hidden(hidden, attention_mask, self.pooling)
        if head is not None:
            reps = head(reps)
        if self.normalize:
            norm = torch.linalg.vector_norm(reps, dim=-1, keepdim=True)
            reps = reps / norm.clamp_min(1e-12)
        return reps

    def encode_query(self, input_ids, attention_mask, generator=None):
        return self.encode(input_ids, attention_mask, True, generator)

    def encode_passage(self, input_ids, attention_mask, generator=None):
        return self.encode(input_ids, attention_mask, False, generator)

    # ---- construction ---------------------------------------------------

    def config_dict(self) -> Dict[str, Any]:
        return {
            "tied": self.tied,
            "plm_backbone": {"type": self.backbone_type,
                             "feature": self.feature},
            "pooling": self.pooling,
            "linear_head": self.has_head,
            "normalize": self.normalize,
            "head_in_dim": self.head_in_dim,
            "head_out_dim": self.head_out_dim,
            "encoder_config": self.encoder_config.to_dict(),
        }

    @classmethod
    def from_config_dict(cls, cfg: Dict[str, Any],
                         dtype: torch.dtype = torch.float32) -> "DRModel":
        backbone = cfg["plm_backbone"]["type"]
        if backbone in ("t5", "t5_encdec"):
            raise NotImplementedError(_T5_TODO.format(backbone))
        return cls(
            encoder_config=BertConfig(**cfg["encoder_config"]),
            backbone_type=backbone,
            tied=cfg["tied"],
            feature=cfg["plm_backbone"]["feature"],
            pooling=cfg["pooling"],
            normalize=cfg["normalize"],
            has_head=cfg["linear_head"],
            head_in_dim=cfg.get("head_in_dim", 768),
            head_out_dim=cfg.get("head_out_dim", 768),
            dtype=dtype,
        )

    @classmethod
    def load(cls, ckpt_dir: str, dtype=torch.float32,
             device="cuda") -> "DRModel":
        """Read a JAX-package checkpoint directory; weights stay fp32 and
        ``dtype`` is the compute dtype. Returns the model in eval mode on
        ``device``: the card unless the caller names the CPU. The device is
        resolved first, so asking for a card that is not there raises before
        anything is read."""
        device = resolve_device(device)
        with open(os.path.join(ckpt_dir, OPENMATCH_CONFIG)) as f:
            cfg = json.load(f)
        model = cls.from_config_dict(cfg, resolve_dtype(dtype))
        model.load_weights(ckpt_dir)
        return model.to(device).eval()

    def load_weights(self, ckpt_dir: str):
        """Copy the weights of ``ckpt_dir/params.msgpack`` into this model's
        parameters in place (they keep their device)."""
        tree = read_flax_msgpack(os.path.join(ckpt_dir, "params.msgpack"))
        self.load_state_dict(params_from_jax(tree), strict=True)

    def save(self, output_dir: str):
        """Write ``openmatch_config.json`` and fp32 ``params.msgpack`` in
        the JAX package's layout (JAX ``DRModel.save``)."""
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, OPENMATCH_CONFIG), "w") as f:
            json.dump(self.config_dict(), f, indent=4)
        tree = params_to_jax(self.state_dict(),
                             self.encoder_config.num_attention_heads)
        write_flax_msgpack(tree, os.path.join(output_dir, "params.msgpack"))

    @classmethod
    def build(cls, model_args, device="cuda") -> "DRModel":
        """``ModelArguments`` -> a loaded model (the drivers' entry), on the
        card unless the caller names the CPU: an OpenMatch checkpoint
        directory loads, a raw HuggingFace BERT / RoBERTa / ELECTRA
        directory converts (JAX ``DRModel.build``). A new linear head is
        drawn from a generator seeded with 0 (JAX seeds its head with
        ``PRNGKey(0)``); untied towers start as copies of each other."""
        device = resolve_device(device)
        path = model_args.model_name_or_path
        if path and os.path.exists(os.path.join(path, OPENMATCH_CONFIG)):
            return cls.load(path, dtype=model_args.dtype, device=device)
        if _looks_like_t5(path):
            raise NotImplementedError(_T5_TODO.format(path))
        enc_config, enc_state = load_bert_encoder(path)
        model = cls(
            encoder_config=enc_config,
            tied=not model_args.untie_encoder,
            feature=model_args.feature,
            pooling=model_args.pooling,
            normalize=model_args.normalize,
            has_head=model_args.add_linear_head,
            head_in_dim=model_args.projection_in_dim,
            head_out_dim=model_args.projection_out_dim,
            dtype=resolve_dtype(model_args.dtype),
        )
        state = {f"encoder_q.{k}": v for k, v in enc_state.items()}
        if not model.tied:
            state.update({f"encoder_p.{k}": v.clone()
                          for k, v in enc_state.items()})
        if model.has_head:
            w = lecun_normal(model.head_out_dim, model.head_in_dim)
            state["head_q.linear.weight"] = w
            if not model.tied:
                state["head_p.linear.weight"] = w.clone()
        model.load_state_dict(state, strict=True)
        return model.to(device).eval()


def lecun_normal(out_dim: int, in_dim: int) -> torch.Tensor:
    """flax's default ``Dense`` init (truncated normal, variance 1/fan_in)
    as an [out, in] weight, drawn from a generator seeded with 0."""
    g = torch.Generator().manual_seed(0)
    std = (1.0 / in_dim) ** 0.5 / 0.87962566103423978
    w = torch.empty(out_dim, in_dim)
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


def _looks_like_t5(path: str) -> bool:
    """JAX ``_looks_like_t5``: a T5 / GTR name or a T5 ``config.json``."""
    name = os.path.basename(str(path).rstrip("/")).lower()
    if "t5" in name or "gtr" in name:
        return True
    cfg_path = os.path.join(path, "config.json")
    if os.path.isdir(path) and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            return json.load(f).get("model_type") == "t5"
    return False
