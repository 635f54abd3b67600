"""Kimi-Linear (Kimi-Linear-48B-A3B and its family) as a dense-retrieval
encoder: a hybrid causal LM whose rep is the final state at the last
token (RepLLaMA's recipe: the document's ids, then the end id).

Port only: the JAX package has no such backbone. The layers:

- Pre-norm residual layers (RMSNorm, statistics in fp32), the final norm
  after the last. The token mixer of layer i (1-based in the config's
  ``linear_attn_config``) is KDA where ``kda_layers`` names it and latent
  attention where ``full_attn_layers`` does (three to one in the published
  model). Layer 0's MLP is a dense SwiGLU, the others are MoE layers.
- KDA (Kimi Delta Attention), per token and head (``ops/kda``): q, k and
  v are ``SiLU(causal_conv(W x))``, a depthwise convolution of width
  ``short_conv_kernel_size`` with zero history at each document's first
  token; q and k L2-normalised (eps 1e-6), q scaled by D^-1/2; the log
  decay ``g = -exp(A_log[h]) x softplus(f_b(f_a(x)) + dt_bias)`` in fp32,
  one a key channel; ``beta = sigmoid(b(x))``, one a head; the state
  ``S_t = (I - beta k k^T) Diag(exp(g)) S_{t-1} + beta k v^T`` [D, D] fp32,
  zero at each document's start, and ``o_t = S_t^T q_t``; then each head's
  output RMS-normed (eps ``rms_norm_eps``) times the weight, gated by
  ``sigmoid(g_b(g_a(x)))`` (``g_b`` with a bias), and ``o_proj``.
- Latent attention without position encoding (``mla_use_nope``):
  ``deepseek_v3.MLAttention`` with ``rope=False``, whose 64-wide rotary
  parts stay plain dimensions.
- MoE: ``deepseek_v3.MoE`` (sigmoid scores, the correction bias selects,
  the chosen scores renormalised times ``routed_scaling_factor``, one
  shared expert) over the routed experts it holds: ``held_experts``
  (first, count), all ``num_experts`` by default. The router keeps its
  published width and top k; slots routed to experts not held add
  nothing (one card's share under expert parallelism, without the
  exchange).

As ``deepseek_v3``, pad positions are not computed: the forward packs the
batch's real tokens into ``packed_slots(B, S)`` slots on the device, runs
every token-wise operation there, the attention core on the padded layout
and K13 over the packed stream with each document's bounds (a cumsum of
the mask, no host read), so the forward replays as a CUDA graph and a
document encodes to the same bits in any batch; a batch that overflows the
stream runs eagerly in two halves of its rows.

Weights are held in the model's ``dtype``; the router, ``A_log`` and
``dt_bias`` in fp32. A model is loaded from HF-named tensors
(``load_hf_tensor``, ``state_from_hf``). Spans (``utils.profiling``):
``kda.attention``, ``kda.chunk``, ``mla.attention``, ``moe.route``,
``moe.experts``. Counters, updated in place by every call (graph replays
included) and zeroed by ``reset_expert_slots``: ``expert_slots`` [MoE
layers, num_experts] (real-token slots routed to each expert),
``held_slots`` [MoE layers] (those routed to a held expert) and
``kda_chunks`` (K13's chunks run, a document and head each); ``counters``
reads them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kda import CHUNK, kda_chunk
from ..utils.profiling import span
from .deepseek_v3 import (MLP, DeepseekV3Config, Linear, MLAttention, MoE,
                          PackedEncoder, Packing, RMSNorm, attention_bias)
from .hf_convert import read_hf_state_dict, read_safetensors

KDA_LAYERS = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22,
              23, 25, 26)
FULL_ATTN_LAYERS = (4, 8, 12, 16, 20, 24, 27)


@dataclass(frozen=True)
class KimiLinearConfig:
    """The fields of an HF ``kimi_linear`` ``config.json`` the encoder
    reads (``linear_attn_config``'s flattened as ``kda_*``); the defaults
    are Kimi-Linear-48B-A3B's. ``held_experts`` (first, count) is the
    share of each MoE layer's routed experts held, None for all."""

    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    num_experts: int = 256
    num_shared_experts: int = 1
    num_experts_per_token: int = 8
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    routed_scaling_factor: float = 2.446
    moe_renormalize: bool = True
    kda_layers: Tuple[int, ...] = KDA_LAYERS
    full_attn_layers: Tuple[int, ...] = FULL_ATTN_LAYERS
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    kda_conv_size: int = 4
    held_experts: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        for name in ("kda_layers", "full_attn_layers", "held_experts"):
            value = getattr(self, name)
            if value is not None:
                object.__setattr__(self, name, tuple(value))
        layers = sorted(self.kda_layers + self.full_attn_layers)
        if layers != list(range(1, self.num_hidden_layers + 1)):
            raise ValueError(
                f"kimi_linear: kda_layers and full_attn_layers must name "
                f"layers 1 .. {self.num_hidden_layers} once each")
        first, count = self.held
        if not 0 <= first < first + count <= self.num_experts:
            raise ValueError(f"kimi_linear: held_experts "
                             f"{self.held_experts} outside "
                             f"0 .. {self.num_experts}")

    @property
    def held(self) -> Tuple[int, int]:
        return self.held_experts or (0, self.num_experts)

    @property
    def n_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    def is_kda(self, index: int) -> bool:
        """Whether layer ``index`` (0-based) mixes tokens with KDA."""
        return index + 1 in self.kda_layers

    def deepseek_view(self) -> DeepseekV3Config:
        """The ``DeepseekV3Config`` of the shared latent attention, MLPs
        and MoE layers."""
        return DeepseekV3Config(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            moe_intermediate_size=self.moe_intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            n_routed_experts=self.num_experts,
            n_shared_experts=self.num_shared_experts,
            num_experts_per_tok=self.num_experts_per_token,
            first_k_dense_replace=self.first_k_dense_replace,
            kv_lora_rank=self.kv_lora_rank,
            qk_nope_head_dim=self.qk_nope_head_dim,
            qk_rope_head_dim=self.qk_rope_head_dim,
            v_head_dim=self.v_head_dim, rms_norm_eps=self.rms_norm_eps,
            routed_scaling_factor=self.routed_scaling_factor,
            norm_topk_prob=self.moe_renormalize)

    def to_dict(self):
        return dataclasses.asdict(self)


# what the encoder implements; a config.json asking for more is refused
_REQUIRED = {"q_lora_rank": None, "rope_scaling": None,
             "num_expert_group": 1, "topk_group": 1, "moe_layer_freq": 1,
             "hidden_act": "silu", "moe_router_activation_func": "sigmoid",
             "mla_use_nope": True, "num_nextn_predict_layers": 0}
_LINEAR = {"kda_layers": "kda_layers",
           "full_attn_layers": "full_attn_layers",
           "num_heads": "kda_num_heads", "head_dim": "kda_head_dim",
           "short_conv_kernel_size": "kda_conv_size"}


def kimi_linear_config_from_hf(hf: dict) -> KimiLinearConfig:
    """``config.json``'s dict -> ``KimiLinearConfig``; raises, naming the
    key, on settings the encoder does not implement (query compression,
    scaled RoPE or RoPE in MLA, several expert groups, another activation,
    multi-token prediction layers, ...)."""
    for key, want in _REQUIRED.items():
        if key in hf and hf[key] != want:
            raise ValueError(f"kimi_linear: {key}={hf[key]!r} is not "
                             f"implemented (only {want!r})")
    fields = {f.name for f in dataclasses.fields(KimiLinearConfig)}
    kw = {k: v for k, v in hf.items() if k in fields and v is not None}
    linear = hf.get("linear_attn_config") or {}
    kw.update({ours: linear[theirs] for theirs, ours in _LINEAR.items()
               if theirs in linear})
    return KimiLinearConfig(**kw)


def doc_offsets(real: torch.Tensor, n: int) -> torch.Tensor:
    """[B + 1] int64: each row's first slot in the packed stream of ``n``
    slots and the end of the last (``Packing``'s row-major order)."""
    return F.pad(torch.cumsum(real.sum(1), 0), (1, 0)).clamp_max_(n)


def kda_decay(f: torch.Tensor, A_log: torch.Tensor,
              dt_bias: torch.Tensor, heads: int) -> torch.Tensor:
    """The log decay [T, H x D] fp32 of each key channel:
    ``-exp(A_log[h]) x softplus(f + dt_bias)``."""
    T = f.shape[0]
    g = F.softplus(f.float() + dt_bias).view(T, heads, -1)
    return (g * -A_log.float().exp()[:, None]).view(T, -1)


def output_gate(o: torch.Tensor, weight: torch.Tensor, gate: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Each head's output [T, H, D] RMS-normed in fp32 times ``weight``
    [D], gated by ``sigmoid(gate)`` [T, H x D]; [T, H x D] in o's dtype."""
    o32 = o.float()
    normed = o32 * torch.rsqrt(o32.square().mean(-1, keepdim=True) + eps)
    gated = normed * weight.float() * torch.sigmoid(
        gate.float()).view_as(o32)
    return gated.flatten(1).to(o.dtype)


class KDAttention(nn.Module):
    """The KDA token mixer. q, k and v are one product ``qkv_proj`` [3 x H
    x D, hidden] (q's rows, k's, v's) and their convolutions' taps one
    ``conv_weight`` [3 x H x D, K]; ``f_a``, ``g_a`` and ``b`` are one
    product ``low_proj`` [2 x D + H, hidden]."""

    def __init__(self, cfg: KimiLinearConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        d, H, D = cfg.hidden_size, cfg.kda_num_heads, cfg.kda_head_dim
        HD = H * D
        self.qkv_proj = Linear(d, 3 * HD, dtype)
        self.conv_weight = nn.Parameter(torch.zeros(3 * HD,
                                                    cfg.kda_conv_size,
                                                    dtype=dtype))
        self.low_proj = Linear(d, 2 * D + H, dtype)
        self.f_b_proj = Linear(D, HD, dtype)
        self.g_b_proj = nn.Linear(D, HD, bias=True, dtype=dtype)
        self.A_log = nn.Parameter(torch.zeros(H))
        self.dt_bias = nn.Parameter(torch.zeros(HD))
        self.o_norm = nn.Parameter(torch.ones(D, dtype=dtype))
        self.o_proj = Linear(HD, d, dtype)

    def forward(self, h: torch.Tensor, cu: torch.Tensor) -> torch.Tensor:
        """h [T, d] packed, ``cu`` [B + 1] the documents' bounds in it."""
        cfg = self.cfg
        H, D = cfg.kda_num_heads, cfg.kda_head_dim
        f, gate, b = self.low_proj(h).split([D, D, H], -1)
        g = kda_decay(self.f_b_proj(f), self.A_log, self.dt_bias, H)
        beta = b.float().sigmoid().contiguous()
        with span("kda.chunk"):
            o = kda_chunk(self.qkv_proj(h), self.conv_weight, g, beta, cu,
                          H)
        return self.o_proj(output_gate(o, self.o_norm, self.g_b_proj(gate),
                                       cfg.rms_norm_eps))


class KimiDecoderLayer(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, index: int,
                 dtype: torch.dtype):
        super().__init__()
        ds = cfg.deepseek_view()
        d = cfg.hidden_size
        self.kda = cfg.is_kda(index)
        self.input_layernorm = RMSNorm(d, cfg.rms_norm_eps, dtype)
        self.self_attn = (KDAttention(cfg, dtype) if self.kda
                          else MLAttention(ds, dtype, rope=False))
        self.post_attention_layernorm = RMSNorm(d, cfg.rms_norm_eps, dtype)
        self.mlp = (MLP(d, cfg.intermediate_size, dtype)
                    if index < cfg.first_k_dense_replace
                    else MoE(ds, dtype, held=cfg.held))

    def forward(self, h, bias, cu, pack, slots, held_slots):
        if self.kda:
            with span("kda.attention"):
                h = h + self.self_attn(self.input_layernorm(h), cu)
        else:
            with span("mla.attention"):
                h = h + self.self_attn(self.input_layernorm(h), bias, None,
                                       None, pack)
        x = self.post_attention_layernorm(h)
        return h + (self.mlp(x) if slots is None
                    else self.mlp(x, pack, slots, held_slots))


class KimiLinearEncoder(PackedEncoder):
    """Returns {"last_hidden_state": [B, S, d]}, the final norm's output
    (zero at pad positions), computed in ``dtype`` (in which the weights
    are held) on the packed stream of the batch's real tokens."""

    def __init__(self, config: KimiLinearConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=dtype)
        self.layers = nn.ModuleList(KimiDecoderLayer(cfg, i, dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.register_buffer("expert_slots", torch.zeros(
            cfg.n_moe_layers, cfg.num_experts, dtype=torch.int64),
            persistent=False)
        self.register_buffer("held_slots", torch.zeros(
            cfg.n_moe_layers, dtype=torch.int64), persistent=False)
        self.register_buffer("kda_chunks", torch.zeros((), dtype=torch.int64),
                             persistent=False)
        self._routes: Optional[list] = None  # see recording_routes

    def reset_expert_slots(self):
        """Zero the counters in place (a CUDA graph keeps their
        addresses)."""
        for t in (self.expert_slots, self.held_slots, self.kda_chunks):
            t.zero_()

    def counters(self) -> Dict[str, int]:
        """The counters' sums (a read from the card): ``held_slots``,
        ``routed_slots`` (every real-token slot of every MoE layer) and
        ``kda_chunks``."""
        return {"held_slots": int(self.held_slots.sum()),
                "routed_slots": int(self.expert_slots.sum()),
                "kda_chunks": int(self.kda_chunks)}

    def _packed(self, input_ids: torch.Tensor, real: torch.Tensor,
                n: int) -> torch.Tensor:
        """The final state [B, S, d] of the batch, its real tokens packed
        into ``n`` slots (at least its count)."""
        cfg = self.config
        pack = Packing.of(real, n)
        bias = attention_bias(real) if cfg.full_attn_layers else None
        cu = doc_offsets(real, n)
        self.kda_chunks.add_(((cu.diff() + CHUNK - 1) // CHUNK).sum()
                             * (cfg.kda_num_heads * len(cfg.kda_layers)))
        h = self.embed_tokens(input_ids.reshape(-1).index_select(
            0, pack.source))
        first_moe = cfg.first_k_dense_replace
        for i, layer in enumerate(self.layers):
            moe = i >= first_moe
            h = layer(h, bias, cu, pack,
                      self.expert_slots[i - first_moe] if moe else None,
                      self.held_slots[i - first_moe] if moe else None)
        return pack.padded(self.norm(h)).masked_fill_(~real[..., None], 0)


# ---- HuggingFace names -> the encoder's ------------------------------------

_EXPERT = re.compile(r"^(layers\.\d+\.mlp)\.experts\.(\d+)\.(w1|w2|w3)"
                     r"\.weight$")
_GATE_UP = re.compile(r"^(layers\.\d+\.mlp(?:\.shared_experts)?)\.(gate|up)"
                      r"_proj\.weight$")
_KDA = re.compile(r"^(layers\.(\d+)\.self_attn)\.(q|k|v|f_a|g_a|b)"
                  r"(_proj|_conv1d)\.weight$")


def hf_target(name: str, t: torch.Tensor, cfg: KimiLinearConfig
              ) -> Optional[Tuple[str, tuple]]:
    """(the encoder's key, the index into it) that the HF tensor ``name``
    (``t``) fills, or None for the LM head and for an expert not held.
    Expert j's ``w1`` (gate) and ``w3`` (up) fill row j - first of
    ``experts.gate_up_proj``, its ``w2`` (down) of ``experts.down_proj``;
    ``q/k/v_proj`` and their ``_conv1d`` stack into ``qkv_proj`` and
    ``conv_weight``, ``f_a/g_a/b_proj`` into ``low_proj``."""
    if name.startswith("model."):
        name = name[len("model."):]
    if name == "lm_head.weight":
        return None
    rows = t.shape[0]
    m = _EXPERT.match(name)
    if m:
        prefix, j, kind = m.group(1), int(m.group(2)), m.group(3)
        first, count = cfg.held
        if not first <= j < first + count:
            return None
        if kind == "w2":
            return f"{prefix}.experts.down_proj", (j - first,)
        half = slice(0, rows) if kind == "w1" else slice(rows, 2 * rows)
        return f"{prefix}.experts.gate_up_proj", (j - first, half)
    m = _GATE_UP.match(name)
    if m:
        half = slice(0, rows) if m.group(2) == "gate" \
            else slice(rows, 2 * rows)
        return f"{m.group(1)}.gate_up_proj.weight", (half,)
    m = _KDA.match(name)
    if m and cfg.is_kda(int(m.group(2))):
        prefix, _, part, kind = m.groups()
        D = cfg.kda_head_dim
        if kind == "_conv1d":
            at = "qkv".index(part) * rows
            return f"{prefix}.conv_weight", (slice(at, at + rows),)
        if part in "qkv":
            at = "qkv".index(part) * rows
            return f"{prefix}.qkv_proj.weight", (slice(at, at + rows),)
        at = {"f_a": 0, "g_a": D, "b": 2 * D}[part]
        return f"{prefix}.low_proj.weight", (slice(at, at + rows),)
    if name.endswith(".self_attn.o_norm.weight"):
        return name[:-len(".weight")], ()
    return name, ()


def load_hf_tensor(dest: Dict[str, torch.Tensor], name: str,
                   t: torch.Tensor, cfg: KimiLinearConfig) -> Optional[str]:
    """Copy the HF tensor ``name`` into its place in ``dest`` (the
    encoder's tensors by key), cast to the destination's dtype and shape
    (a convolution's [C, 1, K] as [C, K]); returns the key filled, None
    for the LM head and for an expert not held."""
    target = hf_target(name, t, cfg)
    if target is None:
        return None
    key, index = target
    if key not in dest:
        raise KeyError(f"kimi_linear: HF tensor {name!r} has no place "
                       f"({key!r})")
    with torch.no_grad():
        place = dest[key][index]
        place.copy_(t.reshape(place.shape))
    return key


def pieces(key: str, cfg: KimiLinearConfig) -> int:
    """How many HF tensors fill the encoder's tensor ``key``."""
    held = cfg.held[1]
    if key.endswith("experts.gate_up_proj"):
        return 2 * held
    if key.endswith("experts.down_proj"):
        return held
    if key.endswith(("qkv_proj.weight", "conv_weight", "low_proj.weight")):
        return 3
    return 2 if key.endswith("gate_up_proj.weight") else 1


def state_from_hf(sd: Dict[str, torch.Tensor], cfg: KimiLinearConfig,
                  dtype: torch.dtype = torch.bfloat16
                  ) -> Dict[str, torch.Tensor]:
    """An HF ``KimiLinearForCausalLM`` / ``KimiLinearModel`` state dict ->
    the encoder's state (weights in ``dtype``, the router, ``A_log`` and
    ``dt_bias`` in fp32); raises if a tensor of the encoder is not filled
    whole."""
    with torch.device("meta"):
        shapes = KimiLinearEncoder(cfg, dtype).state_dict()
    state = {k: torch.empty(v.shape, dtype=v.dtype)
             for k, v in shapes.items()}
    filled = Counter(load_hf_tensor(state, n, t, cfg) for n, t in sd.items())
    short = [k for k in state if filled[k] != pieces(k, cfg)]
    if short:
        more = " ..." if len(short) > 5 else ""
        raise KeyError(f"kimi_linear: tensors not filled from the "
                       f"checkpoint: {short[:5]}{more}")
    return state


def is_kimi_linear(path: str) -> bool:
    cfg_path = os.path.join(str(path), "config.json")
    if not os.path.exists(cfg_path):
        return False
    with open(cfg_path) as f:
        return json.load(f).get("model_type") == "kimi_linear"


def load_kimi_linear(path: str, dtype: torch.dtype = torch.bfloat16
                     ) -> Tuple[KimiLinearConfig, Dict[str, torch.Tensor]]:
    """An HF Kimi-Linear directory (``config.json`` and
    ``model.safetensors``, its shards under
    ``model.safetensors.index.json``, or ``pytorch_model.bin``) ->
    (config, encoder state). Holds the checkpoint and the state in host
    memory together."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = kimi_linear_config_from_hf(json.load(f))
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        sd = {}
        for name in files:
            sd.update(read_safetensors(os.path.join(path, name)))
    else:
        sd = read_hf_state_dict(path)
    return cfg, state_from_hf(sd, cfg, dtype)
