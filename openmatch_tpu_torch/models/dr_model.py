"""Bi-encoder dense retrieval model as an ``nn.Module``.

Port of ``openmatch_tpu/models/dr_model.py``: tied or untied query/passage
towers, "first"/"mean" pooling, an optional bias-free head and optional L2
normalisation. Backbones: ``bert`` (BERT / RoBERTa / ELECTRA), ``t5`` (the
T5 encoder with the configured pooling: GTR, ``--encoder_only``),
``t5_encdec`` (full T5: the rep is the hidden state of one decoder step
fed the start token, whatever the pooling, JAX ``dr_model.py:134-139``)
and, in the port only, ``deepseek_v3`` (a DeepSeek-V3 / Moonlight causal
LM, ``models/deepseek_v3``, with ``last`` pooling), whose weights are held
in the model's dtype rather than as fp32 masters, and which ``DRTrainer``
does not train.

On a card, an inference call (no autograd, eval mode, no dropout
generator, no tensor parallelism) replays the whole encode as a CUDA graph
captured once per input shape (``models/graphs``); ``graph_stats`` counts
captures, replays and eager calls. An encoder that packs its real tokens
(``deepseek_v3``: ``packed_slots``) also has its calls' real tokens,
packed slots and overflowing batches counted there; such a batch runs
eagerly, in two halves of its rows.

``DRModel.load`` and ``DRModel.save`` read and write the JAX package's
checkpoint directory (``openmatch_config.json`` plus flax-msgpack
``params.msgpack``) through the port's own codec (``models/flax_msgpack``),
so a model trained in either package serves in the other; a port-only
backbone writes ``model.pt`` (``torch.save`` of its state) in its place.
``DRModel.build`` also converts a raw HuggingFace BERT / RoBERTa / ELECTRA
directory (``models/hf_convert``), T5 / GTR directory (``models/t5``) or
DeepSeek-V3 directory (``models/deepseek_v3``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from ..device import resolve_device, resolve_dtype
from .bert import BertConfig, BertEncoder
from .deepseek_v3 import (DeepseekV3Config, DeepseekV3Encoder,
                          is_deepseek_v3, load_deepseek_v3)
from .flax_msgpack import read_flax_msgpack, write_flax_msgpack
from .graphs import EncodeGraphs, engages
from .hf_convert import load_bert_encoder
from .jax_convert import params_from_jax, params_to_jax
from .pooling import LinearHead, pool_hidden
from .t5 import (T5Config, T5Encoder, T5EncoderDecoderStep, load_t5_encdec,
                 load_t5_encoder)

OPENMATCH_CONFIG = "openmatch_config.json"
PORT_WEIGHTS = "model.pt"  # a port-only backbone's weights (torch.save)


class Backbone(NamedTuple):
    encoder: type
    config: type
    hidden: str  # the config's field of the rep's width
    heads: str  # ... and of the attention heads
    port_only: bool = False  # no JAX twin: weights in PORT_WEIGHTS, held
    #                          in the model's dtype, not trained here


_ENCODERS = {
    "bert": Backbone(BertEncoder, BertConfig, "hidden_size",
                     "num_attention_heads"),
    "t5": Backbone(T5Encoder, T5Config, "d_model", "num_heads"),
    "t5_encdec": Backbone(T5EncoderDecoderStep, T5Config, "d_model",
                          "num_heads"),
    "deepseek_v3": Backbone(DeepseekV3Encoder, DeepseekV3Config,
                            "hidden_size", "num_attention_heads", True),
}


def _backbone(backbone_type: str) -> Backbone:
    if backbone_type not in _ENCODERS:
        raise ValueError(f"Unknown backbone type {backbone_type}")
    return _ENCODERS[backbone_type]


def make_encoder(backbone_type: str, config, dtype: torch.dtype):
    """The encoder module of a backbone (a key of ``_ENCODERS``)."""
    b = _backbone(backbone_type)
    if not isinstance(config, b.config):
        raise TypeError(f"backbone {backbone_type!r} needs a "
                        f"{b.config.__name__}, got {type(config).__name__}")
    return b.encoder(config, dtype)


def config_from_dict(backbone_type: str, d: Dict[str, Any]):
    """``openmatch_config.json``'s ``encoder_config`` -> its config."""
    return _backbone(backbone_type).config(**d)


def _of_config(config) -> Backbone:
    return next(b for b in _ENCODERS.values() if isinstance(config, b.config))


def hidden_size(config) -> int:
    return getattr(config, _of_config(config).hidden)


def num_heads(config) -> int:
    return getattr(config, _of_config(config).heads)


def dropout_active(config) -> bool:
    """True when the encoder config carries nonzero dropout rates (the
    trainer then passes a generator; inference never does)."""
    return bool(getattr(config, "hidden_dropout_prob", 0.0)
                or getattr(config, "attention_probs_dropout_prob", 0.0)
                or getattr(config, "dropout_rate", 0.0))


class DRModel(nn.Module):
    def __init__(
        self,
        encoder_config,
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
        self.encoder_q = make_encoder(backbone_type, encoder_config, dtype)
        self.encoder_p = (None if tied else
                          make_encoder(backbone_type, encoder_config, dtype))
        self.head_q = LinearHead(head_in_dim, head_out_dim) if has_head else None
        self.head_p = (LinearHead(head_in_dim, head_out_dim)
                       if has_head and not tied else None)
        self._graphs = EncodeGraphs()
        self._packing = ({"packed_tokens": 0, "packed_slots": 0,
                          "packed_overflow": 0}
                         if hasattr(self.encoder_q, "packed_slots") else {})

    @property
    def graph_stats(self) -> Dict[str, int]:
        """Calls of ``encode`` so far: graph ``captures`` and ``replays``,
        and the calls that ran ``eager``; for an encoder that packs, the
        real tokens (``packed_tokens``), the slots they were packed into
        (``packed_slots``, twice a batch's for one run in halves) and the
        batches that overflowed (``packed_overflow``)."""
        return {**self._graphs.stats, **self._packing}

    @property
    def out_dim(self) -> int:
        return self.head_out_dim if self.has_head \
            else hidden_size(self.encoder_config)

    @property
    def dropout_active(self) -> bool:
        return dropout_active(self.encoder_config)

    @property
    def port_only(self) -> bool:
        """A backbone without a JAX twin (``Backbone.port_only``)."""
        return _backbone(self.backbone_type).port_only

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               is_query: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token ids [B, S] -> representations [B, D] in ``dtype``.
        ``generator`` turns dropout on in training mode (``bert.dropout``).
        Where ``graphs.engages``, a replay of the graph captured for the
        call's shape (``models/graphs``), else ``encode_eager``; a batch
        that overflows its encoder's packed stream runs eagerly."""
        overflow = self._count_packed(is_query, attention_mask)
        if not overflow and engages(self, input_ids, generator):
            reps = self._graphs.encode(self, is_query or self.tied,
                                       input_ids, attention_mask)
            if reps is not None:
                return reps
        self._graphs.stats["eager"] += 1
        return self.encode_eager(input_ids, attention_mask, is_query,
                                 generator)

    def _count_packed(self, is_query: bool,
                      attention_mask: torch.Tensor) -> bool:
        """For a tower that packs: count the batch in ``graph_stats`` (a
        read from the card); True when it overflows the packed stream."""
        if not self._packing:
            return False
        encoder = self.encoder_q if is_query or self.tied else self.encoder_p
        tokens = int(attention_mask.count_nonzero())
        slots = encoder.packed_slots(*attention_mask.shape)
        over = tokens > slots
        self._packing["packed_tokens"] += tokens
        self._packing["packed_slots"] += 2 * slots if over else slots
        self._packing["packed_overflow"] += over
        return over

    def encode_eager(self, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor, is_query: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """``encode``, its operations launched one at a time."""
        query_tower = is_query or self.tied
        encoder = self.encoder_q if query_tower else self.encoder_p
        head = self.head_q if query_tower else self.head_p
        outputs = encoder(input_ids, attention_mask, generator=generator)
        if self.backbone_type == "t5_encdec":
            reps = outputs["decoder_hidden"][:, 0, :]
        else:
            reps = pool_hidden(outputs[self.feature], attention_mask,
                               self.pooling)
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
        return cls(
            encoder_config=config_from_dict(backbone, cfg["encoder_config"]),
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

    @staticmethod
    def read_tree(ckpt_dir: str) -> dict:
        """The Flax parameter tree of ``ckpt_dir/params.msgpack``."""
        return read_flax_msgpack(os.path.join(ckpt_dir, "params.msgpack"))

    def load_weights(self, ckpt_dir: str):
        """Copy the weights of ``ckpt_dir/params.msgpack`` (``model.pt``
        for a port-only backbone) into this model's parameters in place
        (they keep their device)."""
        if self.port_only:
            state = torch.load(os.path.join(ckpt_dir, PORT_WEIGHTS),
                               map_location="cpu", weights_only=True,
                               mmap=True)
        else:
            state = params_from_jax(self.read_tree(ckpt_dir))
        self.load_state_dict(state, strict=True)

    def save(self, output_dir: str, state_dict=None):
        """Write ``openmatch_config.json`` and fp32 ``params.msgpack`` in
        the JAX package's layout (JAX ``DRModel.save``): of ``state_dict``
        when given (a tensor-parallel trainer's gathered parameters), else
        of the model's own."""
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, OPENMATCH_CONFIG), "w") as f:
            json.dump(self.config_dict(), f, indent=4)
        state = self.state_dict() if state_dict is None else state_dict
        if self.port_only:
            torch.save(state, os.path.join(output_dir, PORT_WEIGHTS))
            return
        tree = params_to_jax(state, num_heads(self.encoder_config))
        write_flax_msgpack(tree, os.path.join(output_dir, "params.msgpack"))

    @classmethod
    def build(cls, model_args, device="cuda") -> "DRModel":
        """``ModelArguments`` -> a loaded model (the drivers' entry), on the
        card unless the caller names the CPU: an OpenMatch checkpoint
        directory loads, a raw HuggingFace BERT / RoBERTa / ELECTRA
        directory converts, and a T5 / GTR one (a ``t5`` or ``gtr`` name or
        a T5 ``config.json``) builds ``t5_encdec``, or ``t5`` with
        ``--encoder_only`` (JAX ``DRModel.build``). A new linear head is
        drawn from a generator seeded with 0 (JAX seeds its head with
        ``PRNGKey(0)``); untied towers start as copies of each other. A
        DeepSeek-V3 directory (``model_type`` ``deepseek_v3``) builds
        ``deepseek_v3``, its weights held in ``model_args.dtype``."""
        device = resolve_device(device)
        path = model_args.model_name_or_path
        if path and os.path.exists(os.path.join(path, OPENMATCH_CONFIG)):
            return cls.load(path, dtype=model_args.dtype, device=device)
        if path and is_deepseek_v3(path):
            backbone, (enc_config, enc_state) = "deepseek_v3", \
                load_deepseek_v3(path, resolve_dtype(model_args.dtype))
        elif not _looks_like_t5(path):
            backbone, (enc_config, enc_state) = "bert", load_bert_encoder(path)
        elif model_args.encoder_only:
            backbone, (enc_config, enc_state) = "t5", load_t5_encoder(path)
        else:
            backbone, (enc_config, enc_state) = ("t5_encdec",
                                                 load_t5_encdec(path))
        model = cls(
            encoder_config=enc_config,
            backbone_type=backbone,
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
