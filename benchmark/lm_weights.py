"""Seeded weights of a DeepSeek-V3 configuration in the published
(HuggingFace ``DeepseekV3Model``) layout, drawn tensor by tensor on the
device, straight in bf16.

``weights.hf_state`` draws a whole model into one fp32 buffer, which at
15.6B parameters would be 62 GB; here each tensor has its own seed,
derived from the run's seed and the tensor's name, so any tensor can be
drawn alone, as often as it is asked for, and always comes out the same:
the program is loaded tensor by tensor through its own converter, and the
plain reference draws each layer again when it reaches it, so no second
copy of the model is held. Scales as ``transformers`` initialises the
model (``initializer_range`` for every linear layer, the embedding and the
router; RMS norm weights one); ``e_score_correction_bias`` (learned in
the published model) is drawn N(0, ``e_score_correction_bias_std``^2) in
fp32, as the checkpoint stores it."""

from __future__ import annotations

import zlib
from collections.abc import Mapping
from typing import List, Tuple

import numpy as np
import torch

from .common import TAG_WEIGHTS


def deepseek_v3_shapes(cfg: dict) -> List[Tuple[str, tuple, object]]:
    """``(name, shape, std)``: std a float for a drawn tensor, "ones" for a
    norm, ("bias", std) for the router's fp32 correction bias. The LM head
    is left out: the rep does not read it."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    rank, E = cfg["kv_lora_rank"], cfg["n_routed_experts"]
    std = float(cfg.get("initializer_range", 0.02))

    def mlp(p, width):
        return [(f"{p}.gate_proj.weight", (width, d), std),
                (f"{p}.up_proj.weight", (width, d), std),
                (f"{p}.down_proj.weight", (d, width), std)]

    shapes = [("embed_tokens.weight", (cfg["vocab_size"], d), std)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}"
        a = f"{p}.self_attn"
        shapes += [(f"{p}.input_layernorm.weight", (d,), "ones"),
                   (f"{a}.q_proj.weight", (H * (nope + rope), d), std),
                   (f"{a}.kv_a_proj_with_mqa.weight", (rank + rope, d), std),
                   (f"{a}.kv_a_layernorm.weight", (rank,), "ones"),
                   (f"{a}.kv_b_proj.weight", (H * (nope + vd), rank), std),
                   (f"{a}.o_proj.weight", (d, H * vd), std),
                   (f"{p}.post_attention_layernorm.weight", (d,), "ones")]
        if i < cfg["first_k_dense_replace"]:
            shapes += mlp(f"{p}.mlp", cfg["intermediate_size"])
            continue
        shapes += [(f"{p}.mlp.gate.weight", (E, d), std),
                   (f"{p}.mlp.gate.e_score_correction_bias", (E,),
                    ("bias", float(cfg["e_score_correction_bias_std"])))]
        for e in range(E):
            shapes += mlp(f"{p}.mlp.experts.{e}", cfg["moe_intermediate_size"])
        shapes += mlp(f"{p}.mlp.shared_experts",
                      cfg["moe_intermediate_size"] * cfg["n_shared_experts"])
    shapes.append(("norm.weight", (d,), "ones"))
    return shapes


def tensor_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for the tensor ``name`` of the run
    ``seed``."""
    state = np.random.SeedSequence(
        [int(seed) % 2**64, TAG_WEIGHTS, zlib.crc32(name.encode())]
    ).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1])) & (2**63 - 1)


class Drawn(Mapping):
    """The seeded weights of ``cfg`` by HF name; each lookup draws the
    tensor anew on ``device`` (bf16, the bias fp32) and keeps nothing."""

    def __init__(self, cfg: dict, seed: int, device,
                 dtype: torch.dtype = torch.bfloat16):
        self.seed, self.device, self.dtype = seed, torch.device(device), dtype
        self.shapes = {n: (s, std) for n, s, std in deepseek_v3_shapes(cfg)}

    def __getitem__(self, name: str) -> torch.Tensor:
        shape, std = self.shapes[name]
        if std == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        dtype = self.dtype
        if isinstance(std, tuple):
            dtype, std = torch.float32, std[1]
        g = torch.Generator(device=self.device).manual_seed(
            tensor_seed(self.seed, name))
        return torch.empty(shape, dtype=dtype, device=self.device).normal_(
            0.0, std, generator=g)

    def __iter__(self):
        return iter(self.shapes)

    def __len__(self) -> int:
        return len(self.shapes)

