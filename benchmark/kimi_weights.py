"""Seeded weights of a Kimi-Linear configuration in the published
(HuggingFace ``KimiLinearModel``) layout, drawn tensor by tensor on the
device, as ``lm_weights.Drawn`` draws DeepSeek-V3's: each tensor from its
own seed (the run's seed and the tensor's name), so the program loads
them one by one and the plain reference draws each layer again when it
reaches it.

Only the routed experts the configuration holds (``held_experts``) are
drawn; an expert keeps its published index in its name, and so its seed.
Scales as ``transformers`` and the layer's own code initialise the model:
``initializer_range`` for every linear layer, the embedding and the
router; norm weights one; each short convolution's taps uniform in
+-1/sqrt(width) (PyTorch's ``Conv1d`` default, one input channel a
group); ``A_log`` the log of U(1, 16); ``dt_bias`` the inverse softplus
of a dt log-uniform in [0.001, 0.1] (Mamba's), both fp32; the router's
``e_score_correction_bias`` N(0, ``e_score_correction_bias_std``^2) fp32;
``g_b_proj``'s bias at the linear layers' scale (zero at initialisation,
drawn so that it is read). The LM head is left out: the rep does not read
it. The configuration's file lists these under ``assumed``."""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from .lm_weights import Drawn, tensor_seed


def kimi_linear_shapes(cfg: dict) -> List[Tuple[str, tuple, object]]:
    """``(name, shape, kind)``: a float std for a drawn tensor, "ones" for
    a norm, ("bias", std) for the router's fp32 correction bias,
    ("uniform", bound) for convolution taps, "A_log" and "dt_bias"."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    lin = cfg["linear_attn_config"]
    kh, D, K = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
    HD = kh * D
    E = cfg["published_num_experts"]
    first, count = cfg["held_experts"]
    w_moe = cfg["moe_intermediate_size"]
    std = float(cfg.get("initializer_range", 0.02))

    def mlp(p, width):
        return [(f"{p}.gate_proj.weight", (width, d), std),
                (f"{p}.up_proj.weight", (width, d), std),
                (f"{p}.down_proj.weight", (d, width), std)]

    shapes = [("embed_tokens.weight", (cfg["vocab_size"], d), std)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}"
        a = f"{p}.self_attn"
        shapes.append((f"{p}.input_layernorm.weight", (d,), "ones"))
        if i + 1 in lin["kda_layers"]:
            for part in "qkv":
                shapes.append((f"{a}.{part}_proj.weight", (HD, d), std))
            for part in "qkv":
                shapes.append((f"{a}.{part}_conv1d.weight", (HD, 1, K),
                               ("uniform", 1 / math.sqrt(K))))
            shapes += [(f"{a}.f_a_proj.weight", (D, d), std),
                       (f"{a}.f_b_proj.weight", (HD, D), std),
                       (f"{a}.b_proj.weight", (kh, d), std),
                       (f"{a}.g_a_proj.weight", (D, d), std),
                       (f"{a}.g_b_proj.weight", (HD, D), std),
                       (f"{a}.g_b_proj.bias", (HD,), std),
                       (f"{a}.A_log", (kh,), "A_log"),
                       (f"{a}.dt_bias", (HD,), "dt_bias"),
                       (f"{a}.o_norm.weight", (D,), "ones"),
                       (f"{a}.o_proj.weight", (d, HD), std)]
        else:
            shapes += [(f"{a}.q_proj.weight", (H * (nope + rope), d), std),
                       (f"{a}.kv_a_proj_with_mqa.weight", (rank + rope, d),
                        std),
                       (f"{a}.kv_a_layernorm.weight", (rank,), "ones"),
                       (f"{a}.kv_b_proj.weight", (H * (nope + vd), rank),
                        std),
                       (f"{a}.o_proj.weight", (d, H * vd), std)]
        shapes.append((f"{p}.post_attention_layernorm.weight", (d,), "ones"))
        if i < cfg["first_k_dense_replace"]:
            shapes += mlp(f"{p}.mlp", cfg["intermediate_size"])
            continue
        shapes += [(f"{p}.mlp.gate.weight", (E, d), std),
                   (f"{p}.mlp.gate.e_score_correction_bias", (E,),
                    ("bias", float(cfg["e_score_correction_bias_std"])))]
        for e in range(first, first + count):
            x = f"{p}.mlp.experts.{e}"
            shapes += [(f"{x}.w1.weight", (w_moe, d), std),
                       (f"{x}.w3.weight", (w_moe, d), std),
                       (f"{x}.w2.weight", (d, w_moe), std)]
        shapes += mlp(f"{p}.mlp.shared_experts",
                      w_moe * cfg["num_shared_experts"])
    shapes.append(("norm.weight", (d,), "ones"))
    return shapes


class KimiDrawn(Drawn):
    """The seeded weights of a Kimi-Linear ``cfg`` by HF name; each lookup
    draws the tensor anew on ``device`` and keeps nothing."""

    def __init__(self, cfg: dict, seed: int, device,
                 dtype: torch.dtype = torch.bfloat16):
        self.seed, self.device, self.dtype = seed, torch.device(device), dtype
        self.shapes = {n: (s, kind) for n, s, kind in kimi_linear_shapes(cfg)}

    def __getitem__(self, name: str) -> torch.Tensor:
        shape, kind = self.shapes[name]
        if kind not in ("A_log", "dt_bias") and not (
                isinstance(kind, tuple) and kind[0] == "uniform"):
            return super().__getitem__(name)
        g = torch.Generator(device=self.device).manual_seed(
            tensor_seed(self.seed, name))
        u = torch.rand(shape, generator=g, device=self.device)
        if kind == "A_log":
            return torch.log(1 + 15 * u)
        if kind == "dt_bias":
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.exp(lo + (hi - lo) * u).clamp_min(1e-4)
            return dt + torch.log(-torch.expm1(-dt))
        return ((2 * u - 1) * kind[1]).to(self.dtype)
