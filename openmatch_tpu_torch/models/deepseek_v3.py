"""The DeepSeek-V3 decoder (Moonlight-16B-A3B and its family) as a
dense-retrieval encoder: a causal LM whose rep is a hidden state of the
last token (RepLLaMA's recipe: the passage's ids, then the end id).

Port only: the JAX package has no such backbone and cannot load its
checkpoint. The equations are DeepSeek-V3's modeling code, which
``transformers``' ``DeepseekV3Model`` follows with ``rope_interleave``:

- RMSNorm: statistics in fp32, the normalised state cast back, times the
  weight. ``kv_a_layernorm`` keeps the published default eps of 1e-6.
- Latent attention (MLA) without query compression: ``q_proj`` gives each
  head a 128-wide part without position and a 64-wide rotary part;
  ``kv_a_proj_with_mqa`` a 512-wide latent and one 64-wide rotary key that
  every head shares; the latent through ``kv_a_layernorm`` and
  ``kv_b_proj`` each head's 128-wide key part and 128-wide value. Scores at
  192^-0.5 under the causal and padding masks, softmax in fp32, then
  ``o_proj``. RoPE rotates interleaved pairs (2i, 2i + 1) by position x
  theta^(-2i / 64), in fp32.
- SwiGLU MLPs (``first_k_dense_replace`` dense layers, then MoE layers).
  Gate and up are one fused ``gate_up_proj`` [2 x width, hidden].
- MoE: router logits in fp32, sigmoid scores; the top ``k`` experts are
  chosen by score plus ``e_score_correction_bias`` (the bias selects and
  does not weight); their unbiased scores divided by their sum (+1e-20)
  and times ``routed_scaling_factor`` weight their outputs; the shared
  experts' MLP is added. Routed experts run through the grouped GEMM
  (``ops/grouped_gemm``): slots sorted by expert on the device (a stable
  sort), counts by ``scatter_add_`` into [E + 1], offsets by ``cumsum``,
  one fused gate-and-up product, SiLU x up, the down product, and each
  token's slots gathered back by the inverse permutation and weighted
  and summed in fp32 by one batched product (no atomics, so replays
  repeat bit for bit).

One departure from the published code: pad positions are not computed.
The forward gathers the batch's real tokens from the right-padded [B, S]
input into a packed stream of ``packed_slots(B, S)`` slots (the tokens of
half the rows, rounded up, at full length), and runs every token-wise
operation on it: the embedding, the norms, the projections, RoPE (each
token's angles gathered by its column), the residuals, the MLPs, the
router, the sort and the gathers. Only the attention core sees the padded
layout: q, k and v are gathered back to [B, S] for it, and its output
packed again. The packing is made on the device from the mask (a cumsum
and a scatter, no host read), so the forward replays as a CUDA graph.
Each of its operations has one shape per input shape and treats each
token alone, so a passage encodes to the same bits whichever batch it
lands in. Slots past the last real token hold no token: their top-k ids
go to a sentinel (E) that sorts last and that no expert processes, and
their routed output is zero. A batch whose real tokens overflow the
stream runs eagerly in two halves of its rows, each of which fits (the
forward reads the count from the card; a capture does not read it, and
``DRModel.encode`` sends such a batch to the eager path). Under the
causal mask with right padding no real position reads a pad position, so
the reps do not change; the final state at a pad position is zero.

The weights are held in the model's ``dtype`` (bf16, as the published
checkpoint stores them), with no fp32 master and no cast per call; the
router's weight and correction bias are held in fp32, in which the router
computes. A model is loaded from HF-named tensors (``state_from_hf``,
``load_hf_tensor``). Spans (``utils.profiling``):
``mla.attention``, ``moe.route``, ``moe.experts``. The encoder's
``expert_slots`` buffer [MoE layers, E] int64 counts the real-token slots
routed to each expert, updated in place by every call (graph replays
included); ``reset_expert_slots`` zeroes it in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
from collections import Counter
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grouped_gemm import grouped_gemm
from ..utils.profiling import span
from .hf_convert import read_hf_state_dict, read_safetensors


@dataclass(frozen=True)
class DeepseekV3Config:
    """The fields of an HF ``deepseek_v3`` ``config.json`` the encoder
    reads; the defaults are Moonlight-16B-A3B's."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True

    @property
    def n_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    def to_dict(self):
        return dataclasses.asdict(self)


# what the encoder implements; a config.json asking for more is refused
_REQUIRED = {"q_lora_rank": None, "rope_scaling": None,
             "scoring_func": "sigmoid", "topk_method": "noaux_tc",
             "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
             "hidden_act": "silu", "attention_bias": False}


def deepseek_v3_config_from_hf(hf: dict) -> DeepseekV3Config:
    """``config.json``'s dict -> ``DeepseekV3Config``; raises on settings
    the encoder does not implement (query compression, scaled RoPE,
    group-limited routing over several groups, ...)."""
    for key, want in _REQUIRED.items():
        if key in hf and hf[key] != want:
            raise ValueError(f"deepseek_v3: {key}={hf[key]!r} is not "
                             f"implemented (only {want!r})")
    fields = {f.name for f in dataclasses.fields(DeepseekV3Config)}
    kw = {k: v for k, v in hf.items() if k in fields and v is not None}
    return DeepseekV3Config(**kw)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True)
                                   + self.eps)
        return self.weight * normed.to(x.dtype)


def Linear(in_features: int, out_features: int,
           dtype: torch.dtype) -> nn.Linear:
    """A bias-free linear layer, its weight [out, in] held in ``dtype``."""
    return nn.Linear(in_features, out_features, bias=False, dtype=dtype)


def rope_tables(cfg: DeepseekV3Config, seq: int, device) -> tuple:
    """(cos, sin) [seq, rope_dim / 2] fp32 of positions 0 .. seq - 1."""
    r = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, r, 2, dtype=torch.float32, device=device) / r))
    angles = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        * inv[None]
    return angles.cos(), angles.sin()


def packed_slots(batch: int, seq: int) -> int:
    """The packed stream's slots for an input [batch, seq]: the tokens of
    half the rows (rounded up) at full length, so either half of the rows
    fits whatever its lengths."""
    return -(-batch // 2) * seq


class Packing(NamedTuple):
    """Where a batch's real tokens sit in a packed stream of ``n`` slots,
    in row-major order: ``source`` [n] each slot's position in the
    flattened [B x S] input (the first position for a slot past the last
    real token), ``real`` [n] whether the slot holds a real token, and
    ``slot`` [B, S] each position's slot (``n`` at a pad position)."""

    source: torch.Tensor
    real: torch.Tensor
    slot: torch.Tensor

    @classmethod
    def of(cls, real: torch.Tensor, n: int) -> "Packing":
        """The packing of the right-padded mask ``real`` [B, S] bool into
        ``n`` slots, made on the device with fixed shapes. A token past the
        ``n``-th has no slot (the caller keeps the count within ``n``)."""
        flat = real.reshape(-1)
        slot = (torch.cumsum(flat, 0) - 1).masked_fill_(~flat, n) \
            .clamp_max_(n)
        source = torch.zeros(n + 1, dtype=torch.int64,
                             device=real.device).scatter_(
            0, slot, torch.arange(flat.numel(), device=real.device))[:n]
        used = torch.arange(n, device=real.device) < flat.sum()
        return cls(source, used, slot.view(real.shape))

    def padded(self, t: torch.Tensor) -> torch.Tensor:
        """Packed ``t`` [n, ...] at the padded layout [B, S, ...]; a pad
        position holds some slot's finite values, which the attention
        core's masks make exactly no weight."""
        n = self.real.numel()
        return t.index_select(0, self.slot.reshape(-1).clamp_max(n - 1)) \
            .view(*self.slot.shape, *t.shape[1:])

    def packed(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` [B, S, ...] (any strides) at the packed layout [n, ...]."""
        S = self.slot.shape[1]
        return t[self.source // S, self.source % S]


def attention_bias(real: torch.Tensor) -> torch.Tensor:
    """[B, 1, S, S] fp32: 0 where query i may read key j (j <= i, j a real
    position), float32's lowest value elsewhere; ``real`` [B, S] bool."""
    S = real.shape[1]
    allowed = torch.ones(S, S, dtype=torch.bool, device=real.device).tril()[
        None] & real[:, None, :]
    return torch.zeros(allowed.shape[0], 1, S, S,
                       device=real.device).masked_fill_(
        ~allowed[:, None], torch.finfo(torch.float32).min)


def rotary(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, n, r] with its pairs (2i, 2i + 1) rotated by the angles
    [S, r / 2] of their positions, in fp32, returned in x's dtype (the
    encoder passes a packed stream [T, n, r] and each token's angles)."""
    pairs = x.float().unflatten(-1, (-1, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack((a * c - b * s, a * s + b * c), -1).flatten(-2).to(
        x.dtype)


class MLAttention(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        d, H = cfg.hidden_size, cfg.num_attention_heads
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        self.scale = qk ** -0.5
        self.q_proj = Linear(d, H * qk, dtype)
        self.kv_a_proj_with_mqa = Linear(
            d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, 1e-6, dtype)
        self.kv_b_proj = Linear(
            cfg.kv_lora_rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            dtype)
        self.o_proj = Linear(H * cfg.v_head_dim, d, dtype)

    def forward(self, h: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, pack: Packing) -> torch.Tensor:
        """h [T, d] packed, ``cos`` and ``sin`` [T, rope / 2] each token's;
        the core runs on the padded layout ``pack`` gives."""
        cfg = self.cfg
        T = h.shape[0]
        H, nope, rope = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                         cfg.qk_rope_head_dim)
        q_nope, q_rope = self.q_proj(h).view(T, H, nope + rope).split(
            [nope, rope], -1)
        latent, k_rope = self.kv_a_proj_with_mqa(h).split(
            [cfg.kv_lora_rank, rope], -1)
        k_nope, v = self.kv_b_proj(self.kv_a_layernorm(latent)).view(
            T, H, nope + cfg.v_head_dim).split([nope, cfg.v_head_dim], -1)
        q_rope = rotary(q_rope, cos, sin)
        k_rope = rotary(k_rope[:, None, :], cos, sin)
        q = pack.padded(torch.cat((q_nope, q_rope), -1)).transpose(1, 2)
        k = pack.padded(torch.cat((k_nope, k_rope.expand(T, H, rope)),
                                  -1)).transpose(1, 2)  # [B, H, S, qk]
        scores = torch.matmul(q, k.transpose(-1, -2)).float()
        scores.mul_(self.scale).add_(bias)
        probs = torch.softmax(scores, dim=-1).to(h.dtype)
        ctx = torch.matmul(probs, pack.padded(v).transpose(1, 2))
        return self.o_proj(pack.packed(ctx.transpose(1, 2)).reshape(T, -1))


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x)), gate and up one product."""

    def __init__(self, hidden: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.gate_up_proj = Linear(hidden, 2 * width, dtype)
        self.down_proj = Linear(width, hidden, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.gate_up_proj(x).chunk(2, -1)
        return self.down_proj(F.silu(gate) * up)


class Router(nn.Module):
    def __init__(self, cfg: DeepseekV3Config):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.zeros(cfg.n_routed_experts,
                                               cfg.hidden_size))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(cfg.n_routed_experts))

    def forward(self, x: torch.Tensor, real: torch.Tensor) -> tuple:
        """x [T, d], real [T] bool -> (expert ids [T, k] int64, weights
        [T, k] fp32); a pad position's ids are the sentinel E."""
        cfg = self.cfg
        scores = F.linear(x.float(), self.weight).sigmoid()
        ids = (scores + self.e_score_correction_bias).topk(
            cfg.num_experts_per_tok, dim=-1).indices
        weights = scores.gather(1, ids)
        if cfg.norm_topk_prob:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        weights = weights * cfg.routed_scaling_factor
        return ids.masked_fill(~real[:, None], cfg.n_routed_experts), weights


class Experts(nn.Module):
    """The routed experts' weights stacked: ``gate_up_proj`` [E, 2 x
    width, hidden] (each expert's gate rows, then its up rows) and
    ``down_proj`` [E, hidden, width]."""

    def __init__(self, cfg: DeepseekV3Config, dtype: torch.dtype):
        super().__init__()
        E, d, w = (cfg.n_routed_experts, cfg.hidden_size,
                   cfg.moe_intermediate_size)
        self.gate_up_proj = nn.Parameter(torch.zeros(E, 2 * w, d,
                                                     dtype=dtype))
        self.down_proj = nn.Parameter(torch.zeros(E, d, w, dtype=dtype))


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg)
        self.experts = Experts(cfg, dtype)
        self.shared_experts = MLP(
            cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts,
            dtype)
        self.routes: Optional[list] = None  # see recording_routes

    def forward(self, x: torch.Tensor, pack: Packing,
                slots: torch.Tensor) -> torch.Tensor:
        """x [T, d] packed; ``slots`` [E] int64 gains the real-token slots
        routed to each expert."""
        cfg = self.cfg
        E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
        real = pack.real
        with span("moe.route"):
            ids, weights = self.gate(x, real)
            if self.routes is not None:  # [B x S, k], pads the sentinel
                self.routes.append(torch.cat((ids, ids.new_full(
                    (1, k), E))).index_select(0, pack.slot.reshape(-1)))
            flat = ids.reshape(-1)
            order = torch.sort(flat, stable=True).indices
            counts = torch.zeros(E + 1, dtype=torch.int64,
                                 device=x.device).scatter_add_(
                0, flat, torch.ones_like(flat))
            slots.add_(counts[:E])
            offsets = F.pad(torch.cumsum(counts[:E], 0), (1, 0)).to(
                torch.int32)
        with span("moe.experts"):
            rows = x.index_select(0, order // k)
            gate, up = grouped_gemm(rows, self.experts.gate_up_proj,
                                    offsets).chunk(2, -1)
            out = grouped_gemm(F.silu(gate) * up,
                               self.experts.down_proj, offsets)
            inverse = torch.empty_like(order).scatter_(
                0, order, torch.arange(order.numel(), device=x.device))
            out = out.index_select(0, inverse).view(x.shape[0], k, -1)
            routed = torch.bmm(weights[:, None, :], out.float()).squeeze(1)
            routed = routed.masked_fill(~real[:, None], 0.0).to(x.dtype)
        return routed + self.shared_experts(x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, dense: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       dtype)
        self.self_attn = MLAttention(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, dtype)
        self.mlp = (MLP(cfg.hidden_size, cfg.intermediate_size, dtype)
                    if dense else MoE(cfg, dtype))

    def forward(self, h, bias, cos, sin, pack, slots):
        with span("mla.attention"):
            h = h + self.self_attn(self.input_layernorm(h), bias, cos, sin,
                                   pack)
        x = self.post_attention_layernorm(h)
        return h + (self.mlp(x) if slots is None
                    else self.mlp(x, pack, slots))


class DeepseekV3Encoder(nn.Module):
    """Returns {"last_hidden_state": [B, S, d]}, the final norm's output
    (zero at pad positions), computed in ``dtype`` (in which the weights
    are held) on the packed stream of the batch's real tokens."""

    def __init__(self, config: DeepseekV3Config,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i < cfg.first_k_dense_replace, dtype)
            for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.register_buffer("expert_slots", torch.zeros(
            cfg.n_moe_layers, cfg.n_routed_experts, dtype=torch.int64),
            persistent=False)
        self._routes: Optional[list] = None  # see recording_routes

    packed_slots = staticmethod(packed_slots)

    def reset_expert_slots(self):
        """Zero the counter in place (a CUDA graph keeps its address)."""
        self.expert_slots.zero_()

    @contextlib.contextmanager
    def recording_routes(self):
        """Within, each eager forward appends each MoE layer's expert ids
        [B x S, k] (a pad position's the sentinel E) to the list yielded,
        layer after layer. A graph replay appends nothing, so record
        through ``DRModel.encode_eager``."""
        log: list = []
        moes = [layer.mlp for layer in self.layers
                if isinstance(layer.mlp, MoE)]
        for moe in moes:
            moe.routes = log
        self._routes = log
        try:
            yield log
        finally:
            for moe in moes:
                moe.routes = None
            self._routes = None

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """Right-padded ids and mask [B, S]; the model has no dropout."""
        real = attention_mask.bool()
        n = packed_slots(*real.shape)
        capturing = real.is_cuda and torch.cuda.is_current_stream_capturing()
        if not capturing and int(real.count_nonzero()) > n:
            return {"last_hidden_state": self._in_halves(input_ids, real, n)}
        return {"last_hidden_state": self._packed(input_ids, real, n)}

    def _packed(self, input_ids: torch.Tensor, real: torch.Tensor,
                n: int) -> torch.Tensor:
        """The final state [B, S, d] of the batch, its real tokens packed
        into ``n`` slots (at least its count)."""
        pack = Packing.of(real, n)
        bias = attention_bias(real)
        cos, sin = rope_tables(self.config, real.shape[1], real.device)
        column = pack.source % real.shape[1]
        cos, sin = cos.index_select(0, column), sin.index_select(0, column)
        h = self.embed_tokens(input_ids.reshape(-1).index_select(
            0, pack.source))
        first_moe = self.config.first_k_dense_replace
        for i, layer in enumerate(self.layers):
            slots = None if i < first_moe else self.expert_slots[i - first_moe]
            h = layer(h, bias, cos, sin, pack, slots)
        return pack.padded(self.norm(h)).masked_fill_(~real[..., None], 0)

    def _in_halves(self, input_ids: torch.Tensor, real: torch.Tensor,
                   n: int) -> torch.Tensor:
        """``_packed`` over each half of the rows into the same ``n``
        slots, which each half fits; a recorded layer's ids [B x S, k] are
        the halves' joined."""
        log, mark = self._routes, len(self._routes or ())
        half = -(-real.shape[0] // 2)
        out = torch.cat([self._packed(input_ids[rows], real[rows], n)
                         for rows in (slice(None, half), slice(half, None))])
        if log is not None:
            halves = log[mark:]
            layers = len(halves) // 2
            log[mark:] = [torch.cat(pair) for pair in
                          zip(halves[:layers], halves[layers:])]
        return out


# ---- HuggingFace names -> the encoder's --------------------------------------

_EXPERT = re.compile(r"^(layers\.\d+\.mlp)\.experts\.(\d+)\.(gate|up|down)"
                     r"_proj\.weight$")
_GATE_UP = re.compile(r"^(layers\.\d+\.mlp(?:\.shared_experts)?)\.(gate|up)"
                      r"_proj\.weight$")


def hf_target(name: str, rows: int) -> Optional[Tuple[str, tuple]]:
    """(the encoder's key, the index into it) that the HF tensor ``name``
    of ``rows`` rows fills, or None for the LM head (the rep does not read
    it). Gate and up rows stack into ``gate_up_proj``; expert j's tensors
    into row j of ``experts.gate_up_proj`` / ``experts.down_proj``."""
    if name.startswith("model."):
        name = name[len("model."):]
    if name == "lm_head.weight":
        return None
    m = _EXPERT.match(name)
    if m:
        prefix, j, kind = m.group(1), int(m.group(2)), m.group(3)
        if kind == "down":
            return f"{prefix}.experts.down_proj", (j,)
        half = slice(0, rows) if kind == "gate" else slice(rows, 2 * rows)
        return f"{prefix}.experts.gate_up_proj", (j, half)
    m = _GATE_UP.match(name)
    if m:
        half = slice(0, rows) if m.group(2) == "gate" \
            else slice(rows, 2 * rows)
        return f"{m.group(1)}.gate_up_proj.weight", (half,)
    return name, ()


def load_hf_tensor(dest: Dict[str, torch.Tensor], name: str,
                   t: torch.Tensor) -> Optional[str]:
    """Copy the HF tensor ``name`` into its place in ``dest`` (the
    encoder's tensors by key, e.g. its ``state_dict()``), cast to the
    destination's dtype; returns the key filled, None for the LM head."""
    target = hf_target(name, t.shape[0])
    if target is None:
        return None
    key, index = target
    if key not in dest:
        raise KeyError(f"deepseek_v3: HF tensor {name!r} has no place "
                       f"({key!r})")
    with torch.no_grad():
        dest[key][index].copy_(t)
    return key


def pieces(key: str, cfg: DeepseekV3Config) -> int:
    """How many HF tensors fill the encoder's tensor ``key``."""
    if key.endswith("experts.gate_up_proj"):
        return 2 * cfg.n_routed_experts
    if key.endswith("experts.down_proj"):
        return cfg.n_routed_experts
    return 2 if key.endswith("gate_up_proj.weight") else 1


def state_from_hf(sd: Dict[str, torch.Tensor], cfg: DeepseekV3Config,
                  dtype: torch.dtype = torch.bfloat16
                  ) -> Dict[str, torch.Tensor]:
    """An HF ``DeepseekV3ForCausalLM`` / ``DeepseekV3Model`` state dict ->
    the encoder's state (weights in ``dtype``, the router in fp32);
    raises if a tensor of the encoder is not filled whole."""
    with torch.device("meta"):
        shapes = DeepseekV3Encoder(cfg, dtype).state_dict()
    state = {k: torch.empty(v.shape, dtype=v.dtype)
             for k, v in shapes.items()}
    filled = Counter(load_hf_tensor(state, n, t) for n, t in sd.items())
    short = [k for k in state if filled[k] != pieces(k, cfg)]
    if short:
        raise KeyError(f"deepseek_v3: tensors not filled from the "
                       f"checkpoint: {short[:5]}{' ...' if len(short) > 5 else ''}")
    return state


def is_deepseek_v3(path: str) -> bool:
    cfg_path = os.path.join(str(path), "config.json")
    if not os.path.exists(cfg_path):
        return False
    with open(cfg_path) as f:
        return json.load(f).get("model_type") == "deepseek_v3"


def load_deepseek_v3(path: str, dtype: torch.dtype = torch.bfloat16
                     ) -> Tuple[DeepseekV3Config, Dict[str, torch.Tensor]]:
    """An HF DeepSeek-V3 directory (``config.json`` and
    ``model.safetensors``, its shards under
    ``model.safetensors.index.json``, or ``pytorch_model.bin``) ->
    (config, encoder state). Holds the checkpoint and the state in host
    memory together."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = deepseek_v3_config_from_hf(json.load(f))
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
