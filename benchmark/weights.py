"""Seeded weights in the published (HuggingFace) layout, made on the
device in a few large calls.

Each model's weights are drawn at once into one flat fp32 buffer by a
``torch.Generator`` on the device (one ``normal_``), then every tensor is
a view of it scaled to its published initial scale; LayerNorm weights are
ones and biases zeros. The program loads them through its own HuggingFace
converters and the reference reads them by name, so both sides start
from the same numbers."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _fill(shapes: List[Tuple[str, tuple, float]], seed: int,
          device) -> Dict[str, torch.Tensor]:
    """``(name, shape, std)`` -> tensors: std > 0 drawn N(0, std^2) from one
    buffer, std 1.0 with the marker ``"ones"`` ones, 0 zeros."""
    drawn = [(n, s, std) for n, s, std in shapes if isinstance(std, float)
             and std > 0]
    total = sum(torch.Size(s).numel() for _, s, _ in drawn)
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    buf.normal_(generator=g)
    out, at = {}, 0
    for name, shape, std in shapes:
        if std == "ones":
            out[name] = torch.ones(shape, device=device)
        elif std == 0.0:
            out[name] = torch.zeros(shape, device=device)
        else:
            n = torch.Size(shape).numel()
            out[name] = buf[at:at + n].view(shape).mul_(std)
            at += n
    return out


def bert_shapes(cfg: dict) -> List[Tuple[str, tuple, float]]:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    std = float(cfg.get("initializer_range", 0.02))
    shapes = [("embeddings.word_embeddings.weight", (cfg["vocab_size"], d),
               std),
              ("embeddings.position_embeddings.weight",
               (cfg["max_position_embeddings"], d), std),
              ("embeddings.token_type_embeddings.weight",
               (cfg["type_vocab_size"], d), std),
              ("embeddings.LayerNorm.weight", (d,), "ones"),
              ("embeddings.LayerNorm.bias", (d,), 0.0)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}"
        for n in ("query", "key", "value"):
            shapes += [(f"{p}.attention.self.{n}.weight", (d, d), std),
                       (f"{p}.attention.self.{n}.bias", (d,), 0.0)]
        shapes += [(f"{p}.attention.output.dense.weight", (d, d), std),
                   (f"{p}.attention.output.dense.bias", (d,), 0.0),
                   (f"{p}.attention.output.LayerNorm.weight", (d,), "ones"),
                   (f"{p}.attention.output.LayerNorm.bias", (d,), 0.0),
                   (f"{p}.intermediate.dense.weight", (ff, d), std),
                   (f"{p}.intermediate.dense.bias", (ff,), 0.0),
                   (f"{p}.output.dense.weight", (d, ff), std),
                   (f"{p}.output.dense.bias", (d,), 0.0),
                   (f"{p}.output.LayerNorm.weight", (d,), "ones"),
                   (f"{p}.output.LayerNorm.bias", (d,), 0.0)]
    shapes += [("pooler.dense.weight", (d, d), std),
               ("pooler.dense.bias", (d,), 0.0)]
    return shapes


def t5_shapes(cfg: dict) -> List[Tuple[str, tuple, float]]:
    """HF T5's initial scales (``initializer_factor`` 1): embeddings N(0,
    1), q N(0, (d * d_kv)^-1/2), k and v N(0, d^-1/2), o N(0, (H *
    d_kv)^-1/2), wi N(0, d^-1/2), wo N(0, d_ff^-1/2), the relative bias
    N(0, d^-1/2)."""
    d, kv, H, ff = cfg["d_model"], cfg["d_kv"], cfg["num_heads"], cfg["d_ff"]
    f = float(cfg.get("initializer_factor", 1.0))
    inner = H * kv
    shapes = [("shared.weight", (cfg["vocab_size"], d), f * 1.0)]
    stacks = (("encoder", cfg["num_layers"]),
              ("decoder", cfg.get("num_decoder_layers", cfg["num_layers"])))
    for stack, layers in stacks:
        for i in range(layers):
            p = f"{stack}.block.{i}.layer"
            blocks = ["SelfAttention"] + (["EncDecAttention"]
                                          if stack == "decoder" else [])
            for j, attn in enumerate(blocks):
                shapes += [
                    (f"{p}.{j}.{attn}.q.weight", (inner, d),
                     f * (d * kv) ** -0.5),
                    (f"{p}.{j}.{attn}.k.weight", (inner, d), f * d ** -0.5),
                    (f"{p}.{j}.{attn}.v.weight", (inner, d), f * d ** -0.5),
                    (f"{p}.{j}.{attn}.o.weight", (d, inner),
                     f * inner ** -0.5),
                    (f"{p}.{j}.layer_norm.weight", (d,), "ones")]
            if i == 0:
                shapes.append(
                    (f"{p}.0.SelfAttention.relative_attention_bias.weight",
                     (cfg["relative_attention_num_buckets"], H),
                     f * d ** -0.5))
            k = len(blocks)
            shapes += [(f"{p}.{k}.DenseReluDense.wi.weight", (ff, d),
                        f * d ** -0.5),
                       (f"{p}.{k}.DenseReluDense.wo.weight", (d, ff),
                        f * ff ** -0.5),
                       (f"{p}.{k}.layer_norm.weight", (d,), "ones")]
        shapes.append((f"{stack}.final_layer_norm.weight", (d,), "ones"))
    return shapes


SHAPES = {"bert": bert_shapes, "t5": t5_shapes}


def hf_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded fp32 state dict of ``cfg`` (an HF ``config.json``) on
    ``device``, in HF names."""
    return _fill(SHAPES[cfg["model_type"]](cfg), seed, device)
