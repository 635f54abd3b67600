"""A raw HuggingFace BERT / RoBERTa / ELECTRA checkpoint -> the port's encoder.

Twin of ``openmatch_tpu/models/hf_convert.py`` without ``transformers`` or
``safetensors``: ``config.json`` is read with ``json``, ``pytorch_model.bin``
with ``torch.load(weights_only=True)`` and ``model.safetensors`` with
``read_safetensors`` below (the safetensors layout is an 8-byte little-endian
header length, a JSON header of ``{name: {dtype, shape, data_offsets}}``,
then the raw bytes). HF keys map straight onto the port's modules:

- ``attention.self.{query,key,value}`` -> one fused ``qkv`` linear, rows
  q, k, v (each already head-major in HF's [out, in] layout);
- ``attention.output.dense`` -> ``attention.out``; the LayerNorms ->
  ``attention_ln`` / ``output_ln`` / ``embeddings_ln``;
- a checkpoint without segment embeddings gets zeros, as in JAX.

The config follows ``BertConfig.from_hf_config`` of the JAX package: RoBERTa
offsets positions by ``pad_token_id + 1``, ELECTRA may embed narrower and
project up, and only BERT has a pooler. Fields missing from ``config.json``
take HF ``BertConfig``'s defaults.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import torch

from .bert import BertConfig

# HF BertConfig's defaults, for fields a config.json leaves out
_HF_DEFAULTS = {
    "vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072,
    "hidden_act": "gelu", "max_position_embeddings": 512,
    "type_vocab_size": 2, "layer_norm_eps": 1e-12, "pad_token_id": 0,
    "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
}
_PREFIXES = ("bert.", "roberta.", "electra.", "model.")
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which is not supported")
        lo, hi = info["data_offsets"]
        if hi == lo:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        flat = torch.frombuffer(data, dtype=torch.uint8, count=hi - lo,
                                offset=base + lo)
        out[name] = flat.view(dtype).reshape(info["shape"]).clone()
    return out


def read_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of an HF checkpoint directory: ``model.safetensors``
    first, then ``pytorch_model.bin``, as the JAX loader looks."""
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    pt = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{path} holds neither model.safetensors nor "
                            "pytorch_model.bin")


def bert_config_from_hf(hf: dict) -> BertConfig:
    """``config.json``'s dict -> ``BertConfig`` (JAX ``from_hf_config``)."""
    def get(key):
        value = hf.get(key)
        return _HF_DEFAULTS[key] if value is None else value

    model_type = hf.get("model_type", "bert")
    pad = get("pad_token_id")
    embedding_size = hf.get("embedding_size")
    if embedding_size == get("hidden_size"):
        embedding_size = None
    return BertConfig(
        vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
        num_hidden_layers=get("num_hidden_layers"),
        num_attention_heads=get("num_attention_heads"),
        intermediate_size=get("intermediate_size"),
        hidden_act=get("hidden_act"),
        max_position_embeddings=get("max_position_embeddings"),
        type_vocab_size=get("type_vocab_size"),
        layer_norm_eps=get("layer_norm_eps"),
        pad_token_id=pad or 0,
        position_offset=(pad + 1 if model_type in
                         ("roberta", "camembert", "xlm-roberta") else 0),
        embedding_size=embedding_size,
        add_pooler=model_type in ("bert",),
        hidden_dropout_prob=get("hidden_dropout_prob") or 0.0,
        attention_probs_dropout_prob=get("attention_probs_dropout_prob")
        or 0.0,
    )


def _strip_prefix(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        for p in _PREFIXES:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def encoder_state_from_hf(sd: Dict[str, torch.Tensor],
                          config: BertConfig) -> Dict[str, torch.Tensor]:
    """An HF state dict -> the port's ``BertEncoder`` state (fp32)."""
    sd = {k: v.float() for k, v in _strip_prefix(sd).items()}
    emb_dim = config.embedding_size or config.hidden_size
    out = {
        "word_embeddings.weight": sd["embeddings.word_embeddings.weight"],
        "position_embeddings.weight":
            sd["embeddings.position_embeddings.weight"],
        "token_type_embeddings.weight": sd.get(
            "embeddings.token_type_embeddings.weight",
            torch.zeros(config.type_vocab_size, emb_dim)),
        "embeddings_ln.weight": sd["embeddings.LayerNorm.weight"],
        "embeddings_ln.bias": sd["embeddings.LayerNorm.bias"],
    }
    if config.embedding_size and config.embedding_size != config.hidden_size:
        for s in ("weight", "bias"):
            out[f"embeddings_project.{s}"] = sd[f"embeddings_project.{s}"]
    for i in range(config.num_hidden_layers):
        p, lp = f"encoder.layer.{i}", f"layers.{i}"
        for s in ("weight", "bias"):
            out[f"{lp}.attention.qkv.{s}"] = torch.cat(
                [sd[f"{p}.attention.self.{n}.{s}"]
                 for n in ("query", "key", "value")])
            out[f"{lp}.attention.out.{s}"] = \
                sd[f"{p}.attention.output.dense.{s}"]
            out[f"{lp}.attention_ln.{s}"] = \
                sd[f"{p}.attention.output.LayerNorm.{s}"]
            out[f"{lp}.intermediate.{s}"] = sd[f"{p}.intermediate.dense.{s}"]
            out[f"{lp}.output.{s}"] = sd[f"{p}.output.dense.{s}"]
            out[f"{lp}.output_ln.{s}"] = sd[f"{p}.output.LayerNorm.{s}"]
    if config.add_pooler and "pooler.dense.weight" in sd:
        for s in ("weight", "bias"):
            out[f"pooler.{s}"] = sd[f"pooler.dense.{s}"]
    return out


def load_bert_encoder(path: str) -> Tuple[BertConfig,
                                          Dict[str, torch.Tensor]]:
    """An HF checkpoint directory -> (BertConfig, encoder state dict)."""
    with open(os.path.join(path, "config.json")) as f:
        config = bert_config_from_hf(json.load(f))
    return config, encoder_state_from_hf(read_hf_state_dict(path), config)
