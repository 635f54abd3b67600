"""Plain DeepSeek-V3 (Moonlight-16B-A3B) in float32, from DeepSeek-V3's
modeling code (``transformers``' ``DeepseekV3Model`` with
``rope_interleave``), as a last-token dense retriever: the final norm's
hidden state at each row's last real position, L2-normalised when the
configuration's ``dr.normalize`` says so.

Reads HF-named weights (``DeepseekV3Model``'s names: ``embed_tokens``,
``layers.<i>...``, ``norm``) from any mapping and imports nothing of the
program. Each tensor is read, upcast to float32 and dropped as its layer
is reached, so a mapping that draws a tensor when it is asked for lets the
whole model be computed layer by layer without holding it.

Per layer: RMS norm (statistics over the last axis, then the weight),
latent attention (``q_proj`` heads of 128 positionless + 64 rotary dims;
``kv_a_proj_with_mqa`` a 512-wide latent and one shared 64-wide rotary
key; the latent RMS-normed at eps 1e-6 and through ``kv_b_proj`` to each
head's 128 key dims and 128 value dims; scores at 192^-0.5, causal and
padding masks at float32's lowest value, softmax, ``o_proj``), RoPE as
DeepSeek writes it (the rotary dims as complex pairs (2i, 2i + 1) times
e^(i x position x theta^(-2i / r)), angles in float32), then the dense
SwiGLU for the first ``first_k_dense_replace`` layers and the MoE after:
sigmoid scores of the router's logits, the top ``num_experts_per_tok``
by score plus ``e_score_correction_bias``, weights the chosen unbiased
scores over their sum (+1e-20) times ``routed_scaling_factor``, each
expert's SwiGLU over the tokens routed to it, weighted and summed, plus
the shared experts' SwiGLU.

Departure from the published code: pad positions are not routed (their
routed output is zero). Under the causal mask with right padding no real
position reads a pad position, so the reps are those of the published
code. ``precision="fp8"`` rounds every product's operands and the hidden
states between sublayers to fp8 (the control).

Routing along given choices (``Routes``). A token whose k-th and
(k + 1)-th expert scores lie within rounding of each other may take
either; a bf16 program's hidden states differ from float32's by rounding,
so on seeded weights some such tokens take the other expert in every MoE
layer, and each change moves the token's state and so the next layers'
scores: in float32, a rounding-sized change of the embeddings alone puts
more than half the tokens on other experts in the 27th layer (PERF.md).
The reps then differ as far as fp8's do, whatever the program's
soundness. So ``Routes(given)`` makes the
reference take the choices it is given in each MoE layer (a program's,
read from its eager pass) instead of its own top k, weighted by its own
float32 scores, and keeps in ``shortfall`` how far any given choice lies
below the exact top k: the k-th largest score plus bias less the smallest
chosen one, 0 where the choice is the top k, infinite where a token names
an expert twice or none. A choice within rounding of the top k is
accepted; the rest of the forward is the reference's own.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Optional

import torch
import torch.nn.functional as F

from .quant import activation, linear, matmul


def rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, n, r]: DeepSeek's ``apply_rotary_emb`` at positions 0 ..
    S - 1."""
    S, r = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, r, 2, dtype=torch.float32,
                                          device=x.device) / r))
    angles = torch.outer(torch.arange(S, dtype=torch.float32,
                                      device=x.device), freqs)
    cis = torch.polar(torch.ones_like(angles), angles)  # [S, r / 2]
    pairs = torch.view_as_complex(x.float().reshape(*x.shape[:-1], r // 2,
                                                    2).contiguous())
    return torch.view_as_real(pairs * cis[None, :, None, :]).flatten(-2)


def _w(w: Mapping, name: str) -> torch.Tensor:
    return w[name].float()


def _swiglu(w, p, x, precision):
    gate = linear(x, _w(w, f"{p}.gate_proj.weight"), None, precision)
    up = linear(x, _w(w, f"{p}.up_proj.weight"), None, precision)
    return linear(F.silu(gate) * up, _w(w, f"{p}.down_proj.weight"), None,
                  precision)


def _attention(w, p, x, bias, cfg, precision):
    B, S, _ = x.shape
    H = cfg["num_attention_heads"]
    nope, r, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                   cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    q = linear(x, _w(w, f"{p}.q_proj.weight"), None, precision).view(
        B, S, H, nope + r)
    q_nope, q_rot = q[..., :nope], rope(q[..., nope:], cfg["rope_theta"])
    ckv = linear(x, _w(w, f"{p}.kv_a_proj_with_mqa.weight"), None,
                 precision)
    latent = rms(ckv[..., :rank], _w(w, f"{p}.kv_a_layernorm.weight"), 1e-6)
    k_rot = rope(ckv[..., None, rank:], cfg["rope_theta"])  # [B, S, 1, r]
    kv = linear(latent, _w(w, f"{p}.kv_b_proj.weight"), None,
                precision).view(B, S, H, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.cat([q_nope, q_rot], -1).transpose(1, 2)
    k = torch.cat([k_nope, k_rot.expand(B, S, H, r)], -1).transpose(1, 2)
    scores = matmul(q, k.transpose(-1, -2), precision) * (nope + r) ** -0.5
    probs = torch.softmax(scores + bias, dim=-1)
    ctx = matmul(probs, v.transpose(1, 2), precision).transpose(1, 2)
    return linear(ctx.reshape(B, S, H * vd), _w(w, f"{p}.o_proj.weight"),
                  None, precision)


def route(x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor,
          cfg: dict) -> tuple:
    """x [T, d] -> (expert ids [T, k], weights [T, k]) as the published
    router takes them."""
    scores = torch.sigmoid(x.float() @ gate.float().T)
    ids = torch.topk(scores + bias.float(), cfg["num_experts_per_tok"],
                     dim=-1).indices
    weights = scores.gather(1, ids)
    if cfg.get("norm_topk_prob", True):
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return ids, weights * cfg["routed_scaling_factor"]


def route_along(x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor,
                chosen: torch.Tensor, cfg: dict) -> tuple:
    """x [T, d], chosen [T, k] -> (chosen ids, their weights as ``route``
    weights its own, the largest shortfall of a choice, see the module's
    docstring)."""
    scores = torch.sigmoid(x.float() @ gate.float().T)
    biased = scores + bias.float()
    E = scores.shape[1]
    chosen = chosen.long().to(x.device)
    ids = chosen.clamp(0, E - 1)
    ranked = ids.sort(-1).values
    bad = ((chosen < 0) | (chosen >= E)).any(-1) \
        | (ranked[:, 1:] == ranked[:, :-1]).any(-1)
    kth = biased.topk(cfg["num_experts_per_tok"], dim=-1).values[:, -1]
    short = (kth - biased.gather(1, ids).min(-1).values).clamp_min(0)
    short = torch.where(bad, math.inf, short)
    weights = scores.gather(1, ids)
    if cfg.get("norm_topk_prob", True):
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return (ids, weights * cfg["routed_scaling_factor"],
            float(short.max()) if short.numel() else 0.0)


class Routes:
    """The routing of one forward: ``given`` (the choices [T, k] of each
    MoE layer in turn, over the batch's real positions row after row) or
    None for the reference's own top k; ``taken`` gains each layer's
    choices, ``shortfall`` the largest of the given ones."""

    def __init__(self, given: Optional[List[torch.Tensor]] = None):
        self.given = given
        self.taken: List[torch.Tensor] = []
        self.shortfall = 0.0


def _moe(w, p, x, real, cfg, precision, routes: Optional[Routes] = None):
    """x [B, S, d]: the routed experts over the real positions, plus the
    shared experts over every position."""
    flat = x.reshape(-1, x.shape[-1])
    keep = real.reshape(-1).nonzero().squeeze(1)
    tokens = flat[keep]
    gate = _w(w, f"{p}.gate.weight")
    bias = _w(w, f"{p}.gate.e_score_correction_bias")
    if routes is None or routes.given is None:
        ids, weights = route(tokens, gate, bias, cfg)
    else:
        ids, weights, short = route_along(
            tokens, gate, bias, routes.given[len(routes.taken)], cfg)
        routes.shortfall = max(routes.shortfall, short)
    if routes is not None:
        routes.taken.append(ids)
    routed = torch.zeros_like(tokens)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        out = _swiglu(w, f"{p}.experts.{e}", tokens[tok], precision)
        routed.index_add_(0, tok, out * weights[tok, slot, None])
    full = torch.zeros_like(flat).index_copy_(0, keep, routed)
    return full.view(x.shape) + _swiglu(w, f"{p}.shared_experts", x,
                                        precision)


def hidden_states(w: Mapping, cfg: dict, ids: torch.Tensor,
                  mask: torch.Tensor, precision: Optional[str] = None,
                  routes: Optional[Routes] = None) -> torch.Tensor:
    """Token ids [B, S] and mask [B, S] (right padding) -> the final
    norm's hidden states [B, S, d] (those of pad positions are not the
    published code's), routed as ``routes`` says."""
    S = ids.shape[1]
    eps = cfg["rms_norm_eps"]
    real = mask > 0
    allowed = torch.ones(S, S, dtype=torch.bool,
                         device=ids.device).tril()[None] & real[:, None, :]
    bias = torch.where(allowed[:, None], 0.0, torch.finfo(torch.float32).min)
    x = activation(_w(w, "embed_tokens.weight")[ids.long()], precision)
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}"
        h = rms(x, _w(w, f"{p}.input_layernorm.weight"), eps)
        x = activation(x + _attention(w, f"{p}.self_attn", h, bias, cfg,
                                      precision), precision)
        h = rms(x, _w(w, f"{p}.post_attention_layernorm.weight"), eps)
        if i < cfg["first_k_dense_replace"]:
            y = _swiglu(w, f"{p}.mlp", h, precision)
        else:
            y = _moe(w, f"{p}.mlp", h, real, cfg, precision, routes)
        x = activation(x + y, precision)
    return rms(x, _w(w, "norm.weight"), eps)


def reps(w: Mapping, cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
         precision: Optional[str] = None,
         routes: Optional[Routes] = None) -> torch.Tensor:
    """Token ids [B, S] and mask [B, S] (right padding) -> the reps
    [B, d]: the final norm's state at each row's last real position."""
    x = hidden_states(w, cfg, ids, mask, precision, routes)
    last = (mask.sum(1) - 1).clamp_min(0)
    out = x[torch.arange(ids.shape[0], device=x.device), last]
    if cfg.get("dr", {}).get("normalize", False):
        out = F.normalize(out, dim=-1)
    return activation(out, precision)
