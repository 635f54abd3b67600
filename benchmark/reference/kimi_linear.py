"""Plain Kimi-Linear in float32 as a last-token dense retriever: the final
norm's hidden state at each row's last real position, L2-normalised when
the configuration's ``dr.normalize`` says so. One card's share of the
routed experts (``held_experts``), as the program holds it.

Reads HF-named weights (``KimiLinearModel``'s names, as
``benchmark/kimi_weights.py`` lists them) from any mapping and imports
nothing of the program. Each tensor is read, upcast and dropped as its
layer is reached, so a mapping that draws a tensor when asked lets the
whole model run layer by layer without holding it.

Per layer: RMS norm, then the token mixer the configuration's
``linear_attn_config`` names for it (1-based):

- KDA, token by token (not chunked): q, k and v the SiLU of a causal
  depthwise convolution of width ``short_conv_kernel_size`` over each
  row's projections (zero before the row's first token); q and k
  L2-normalised (eps 1e-6), q times D^-1/2; ``g = -exp(A_log[h]) x
  softplus(f_b(f_a(x)) + dt_bias)``; ``beta = sigmoid(b(x))``; per head
  ``S = S * exp(g)[:, None]``, then ``S += beta k (v - S^T k)^T``, and
  ``o = S^T q``, with ``S`` [D, D] zero at the row's start; then the
  output RMS-normed per head (eps ``rms_norm_eps``) times ``o_norm``,
  times ``sigmoid(g_b(g_a(x)) + bias)``, and ``o_proj``.
- Latent attention without position encoding: DeepSeek-V3's, the 64-wide
  rotary parts left unrotated, in blocks of rows so that the scores fit.

Then the dense SwiGLU for the first ``first_k_dense_replace`` layers and
the MoE after: the router's sigmoid scores over all
``published_num_experts``, the top ``num_experts_per_token`` by score plus
``e_score_correction_bias``, the chosen scores over their sum times
``routed_scaling_factor``; each held expert's SwiGLU (``w1`` gate, ``w3``
up, ``w2`` down) over the tokens routed to it, weighted and summed; what
the experts not held would add is left out; plus the shared expert once.
Pad positions are not routed. Routing along given choices and the
``fp8`` control as ``reference.deepseek_v3`` has them.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from .deepseek_v3 import Routes, rms, route, route_along
from .quant import activation, linear, matmul

MLA_ROWS = 8  # rows a block of the latent attention's scores
L2_EPS = 1e-6


def _w(w: Mapping, name: str) -> torch.Tensor:
    return w[name].float()


def _swiglu(w, gate, up, down, x, precision):
    g = linear(x, _w(w, gate), None, precision)
    u = linear(x, _w(w, up), None, precision)
    return linear(F.silu(g) * u, _w(w, down), None, precision)


def _conv_silu(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """x [B, S, C], taps [C, 1, K]: SiLU of the causal depthwise
    convolution along S, zero before each row's start."""
    K = taps.shape[-1]
    y = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)), taps.float(),
                 groups=x.shape[-1])
    return F.silu(y.transpose(1, 2))


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + L2_EPS)


def kda_recurrence(q, k, v, g, beta) -> torch.Tensor:
    """Token by token: q, k, g [B, S, H, D], v [B, S, H, Dv], beta
    [B, S, H] -> o [B, S, H, Dv]; the state zero at each row's start."""
    B, S, H, D = k.shape
    state = q.new_zeros(B, H, D, v.shape[-1])
    out = []
    for t in range(S):
        state = state * g[:, t].exp()[..., None]
        kt = k[:, t]
        delta = v[:, t] - torch.einsum("bhd,bhde->bhe", kt, state)
        state = state + (beta[:, t, :, None, None] * kt[..., None]
                         * delta[:, :, None, :])
        out.append(torch.einsum("bhd,bhde->bhe", q[:, t], state))
    return torch.stack(out, 1)


def _kda(w, p, x, cfg, precision):
    B, S, _ = x.shape
    lin = cfg["linear_attn_config"]
    H, D = lin["num_heads"], lin["head_dim"]
    q, k, v = (_conv_silu(linear(x, _w(w, f"{p}.{n}_proj.weight"), None,
                                 precision), w[f"{p}.{n}_conv1d.weight"])
               .view(B, S, H, D) for n in "qkv")
    q = l2_normalize(q) * D ** -0.5
    k = l2_normalize(k)
    f = linear(linear(x, _w(w, f"{p}.f_a_proj.weight"), None, precision),
               _w(w, f"{p}.f_b_proj.weight"), None, precision)
    g = -_w(w, f"{p}.A_log").exp()[:, None] * F.softplus(
        f + _w(w, f"{p}.dt_bias")).view(B, S, H, D)
    beta = torch.sigmoid(linear(x, _w(w, f"{p}.b_proj.weight"), None,
                                precision))
    o = kda_recurrence(q, k, v, g, beta)
    o = rms(o, _w(w, f"{p}.o_norm.weight"), cfg["rms_norm_eps"])
    gate = linear(linear(x, _w(w, f"{p}.g_a_proj.weight"), None, precision),
                  _w(w, f"{p}.g_b_proj.weight"), w[f"{p}.g_b_proj.bias"],
                  precision)
    o = o.reshape(B, S, H * D) * torch.sigmoid(gate)
    return linear(o, _w(w, f"{p}.o_proj.weight"), None, precision)


def _mla(w, p, x, real, cfg, precision):
    """DeepSeek-V3's latent attention with no rotation, in blocks of
    ``MLA_ROWS`` rows."""
    B, S, _ = x.shape
    H = cfg["num_attention_heads"]
    nope, r, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                   cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    q = linear(x, _w(w, f"{p}.q_proj.weight"), None, precision).view(
        B, S, H, nope + r).transpose(1, 2)
    ckv = linear(x, _w(w, f"{p}.kv_a_proj_with_mqa.weight"), None,
                 precision)
    latent = rms(ckv[..., :rank], _w(w, f"{p}.kv_a_layernorm.weight"), 1e-6)
    kv = linear(latent, _w(w, f"{p}.kv_b_proj.weight"), None,
                precision).view(B, S, H, nope + vd)
    k = torch.cat([kv[..., :nope], ckv[..., None, rank:].expand(
        B, S, H, r)], -1).transpose(1, 2)
    v = kv[..., nope:].transpose(1, 2)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    ctx = []
    for lo in range(0, B, MLA_ROWS):
        rows = slice(lo, lo + MLA_ROWS)
        allowed = causal[None] & real[rows, None, :]
        bias = torch.where(allowed[:, None], 0.0,
                           torch.finfo(torch.float32).min)
        scores = matmul(q[rows], k[rows].transpose(-1, -2), precision) \
            * (nope + r) ** -0.5
        probs = torch.softmax(scores + bias, dim=-1)
        ctx.append(matmul(probs, v[rows], precision))
    ctx = torch.cat(ctx).transpose(1, 2).reshape(B, S, H * vd)
    return linear(ctx, _w(w, f"{p}.o_proj.weight"), None, precision)


def router_config(cfg: dict) -> dict:
    """The router's keys under ``reference.deepseek_v3``'s names."""
    return {"num_experts_per_tok": cfg["num_experts_per_token"],
            "norm_topk_prob": cfg.get("moe_renormalize", True),
            "routed_scaling_factor": cfg["routed_scaling_factor"]}


def _moe(w, p, x, real, cfg, precision, routes: Optional[Routes] = None):
    """x [B, S, d]: the held routed experts over the real positions, plus
    the shared expert over every position."""
    flat = x.reshape(-1, x.shape[-1])
    keep = real.reshape(-1).nonzero().squeeze(1)
    tokens = flat[keep]
    gate = _w(w, f"{p}.gate.weight")
    bias = _w(w, f"{p}.gate.e_score_correction_bias")
    rcfg = router_config(cfg)
    if routes is None or routes.given is None:
        ids, weights = route(tokens, gate, bias, rcfg)
    else:
        ids, weights, short = route_along(
            tokens, gate, bias, routes.given[len(routes.taken)], rcfg)
        routes.shortfall = max(routes.shortfall, short)
    if routes is not None:
        routes.taken.append(ids)
    routed = torch.zeros_like(tokens)
    first, count = cfg["held_experts"]
    for e in range(first, first + count):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x_e = f"{p}.experts.{e}"
        out = _swiglu(w, f"{x_e}.w1.weight", f"{x_e}.w3.weight",
                      f"{x_e}.w2.weight", tokens[tok], precision)
        routed.index_add_(0, tok, out * weights[tok, slot, None])
    full = torch.zeros_like(flat).index_copy_(0, keep, routed)
    s = f"{p}.shared_experts"
    return full.view(x.shape) + _swiglu(
        w, f"{s}.gate_proj.weight", f"{s}.up_proj.weight",
        f"{s}.down_proj.weight", x, precision)


def hidden_states(w: Mapping, cfg: dict, ids: torch.Tensor,
                  mask: torch.Tensor, precision: Optional[str] = None,
                  routes: Optional[Routes] = None) -> torch.Tensor:
    """Token ids [B, S] and mask [B, S] (right padding) -> the final
    norm's hidden states [B, S, d] (those of pad positions are not the
    published code's), routed as ``routes`` says."""
    eps = cfg["rms_norm_eps"]
    real = mask > 0
    kda_layers = cfg["linear_attn_config"]["kda_layers"]
    x = activation(_w(w, "embed_tokens.weight")[ids.long()], precision)
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}"
        h = rms(x, _w(w, f"{p}.input_layernorm.weight"), eps)
        if i + 1 in kda_layers:
            y = _kda(w, f"{p}.self_attn", h, cfg, precision)
        else:
            y = _mla(w, f"{p}.self_attn", h, real, cfg, precision)
        x = activation(x + y, precision)
        h = rms(x, _w(w, f"{p}.post_attention_layernorm.weight"), eps)
        if i < cfg["first_k_dense_replace"]:
            y = _swiglu(w, f"{p}.mlp.gate_proj.weight",
                        f"{p}.mlp.up_proj.weight",
                        f"{p}.mlp.down_proj.weight", h, precision)
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
