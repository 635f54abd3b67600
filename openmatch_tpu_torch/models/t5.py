"""The T5 stack as PyTorch modules (port of ``openmatch_tpu/models/t5.py``).

Three uses, as in the JAX package:

- ``T5Encoder``: the encoder alone (GTR, ``--encoder_only``, the ``t5enc``
  reranker);
- ``T5EncoderDecoderStep``: the encoder, then ONE decoder step fed
  ``decoder_start_token_id``. Its ``decoder_hidden[:, 0]`` is the full-T5
  dense-retrieval rep, and its logits at ``[neg_token, pos_token]`` are the
  monoT5 score;
- ``T5Seq2Seq``: the same parameters under teacher forcing over any decoder
  ids, with ``shift_right``, ``seq2seq_loss`` and ``greedy_generate``
  (query generation, ``research/qg.py``).

Precision points, each the JAX module's:

- parameters are fp32 and every layer computes in ``dtype``; the position
  bias, the mask bias (``finfo(float32).min``) and the attention logits are
  fp32, the probabilities are cast back to ``dtype``;
- attention logits are not scaled by 1/sqrt(d_kv) (T5 folds it into init);
- ``RMSNorm`` normalises in fp32, casts to ``dtype``, then multiplies by its
  weight cast to ``dtype``;
- the relative position buckets take an fp32 ``log`` truncated to int. The
  table is built on the host with numpy and cached by length, so it is the
  same on every device (it equals the JAX function's, tested for S up to
  512 at the t5-base and the test settings);
- a tied lm_head scales the decoder state by ``d_model ** -0.5`` (in
  ``dtype``, the scalar rounded to ``dtype`` as JAX rounds a weak scalar)
  and multiplies by the shared embedding in ``dtype``, as ``nn.Embed.attend``
  does after promoting both operands to the module dtype: the logits are
  ``dtype``. An untied ``lm_head`` is a bias-free linear.

Dropout sits where the JAX module puts it (embeddings, attention
probabilities, each sublayer output, the FFN inner activation, the final
norms) and runs only in training mode when ``forward`` is given a
``torch.Generator`` (``bert.dropout``).

HF checkpoints load without ``transformers``: ``load_t5_encoder`` and
``load_t5_encdec`` read ``config.json`` and the weights through
``hf_convert.read_hf_state_dict``. HF keeps T5's projections in the
``nn.Linear`` [out, in] layout, so they copy straight across.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.gumbel import categorical
from .bert import ACT2FN, copy_in, dropout, linear, row_linear
from .graphs import hold
from .hf_convert import read_hf_state_dict


@dataclass(frozen=True)
class T5Config:
    """Same fields and defaults as ``openmatch_tpu.models.t5.T5Config``."""

    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_decoder_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # "relu" | "gated-gelu"
    tie_word_embeddings: bool = True
    decoder_start_token_id: int = 0
    pad_token_id: int = 0
    dropout_rate: float = 0.0

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated")

    @property
    def ff_act(self) -> str:
        if self.is_gated:
            return self.feed_forward_proj.split("-")[1]
        return self.feed_forward_proj

    def to_dict(self):
        return dataclasses.asdict(self)


# HF T5Config's defaults, for fields a config.json leaves out
_HF_DEFAULTS = {
    "vocab_size": 32128, "d_model": 512, "d_kv": 64, "d_ff": 2048,
    "num_layers": 6, "num_heads": 8, "relative_attention_num_buckets": 32,
    "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
    "feed_forward_proj": "relu", "tie_word_embeddings": True,
    "dropout_rate": 0.1,
}


def t5_config_from_hf(hf: dict) -> T5Config:
    """``config.json``'s dict -> ``T5Config`` (JAX ``from_hf_config``,
    which renames ``gated-gelu_new`` to ``gated-gelu``)."""
    def get(key):
        value = hf.get(key)
        return _HF_DEFAULTS[key] if value is None else value

    return T5Config(
        vocab_size=get("vocab_size"), d_model=get("d_model"),
        d_kv=get("d_kv"), d_ff=get("d_ff"), num_layers=get("num_layers"),
        num_decoder_layers=hf.get("num_decoder_layers") or get("num_layers"),
        num_heads=get("num_heads"),
        relative_attention_num_buckets=get("relative_attention_num_buckets"),
        relative_attention_max_distance=get(
            "relative_attention_max_distance"),
        layer_norm_epsilon=get("layer_norm_epsilon"),
        feed_forward_proj=get("feed_forward_proj").replace("gated-gelu_new",
                                                           "gated-gelu"),
        tie_word_embeddings=get("tie_word_embeddings"),
        decoder_start_token_id=hf.get("decoder_start_token_id") or 0,
        pad_token_id=hf.get("pad_token_id") or 0,
        dropout_rate=get("dropout_rate") or 0.0,
    )


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        normed = (x32 * torch.reciprocal(torch.sqrt(var + self.eps))).to(
            x.dtype)
        return normed * self.weight.to(x.dtype)


def relative_position_bucket(relative_position: np.ndarray,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> np.ndarray:
    """T5's log-bucketed relative positions (JAX ``relative_position_bucket``
    step for step, in numpy int32 and float32)."""
    ret = np.zeros(relative_position.shape, np.int32)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret += (n < 0).astype(np.int32) * num_buckets
        n = np.abs(n)
    else:
        n = np.maximum(n, 0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    scaled = (np.log(n.astype(np.float32) / np.float32(max_exact)
                     + np.float32(1e-6))
              / np.float32(np.log(max_distance / max_exact))
              * np.float32(num_buckets - max_exact))
    val_if_large = np.minimum(max_exact + scaled.astype(np.int32),
                              num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _bucket_table(q_len: int, k_len: int, bidirectional: bool,
                  num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    """[q_len, k_len] int64 buckets of ``memory - query`` on ``device``.
    Built outside inference mode: a cached inference tensor could not index
    a table whose gradient a later training step takes."""
    rel = np.arange(k_len)[None, :] - np.arange(q_len)[:, None]
    table = relative_position_bucket(rel, bidirectional, num_buckets,
                                     max_distance)
    with torch.inference_mode(False):
        return torch.from_numpy(table.astype(np.int64)).to(device)


def position_bias(table: torch.Tensor, q_len: int, k_len: int,
                  bidirectional: bool, cfg: T5Config) -> torch.Tensor:
    """The fp32 bias [1, H, q_len, k_len] from a [buckets, H] table."""
    buckets = hold(_bucket_table(q_len, k_len, bidirectional,
                                 cfg.relative_attention_num_buckets,
                                 cfg.relative_attention_max_distance,
                                 table.device))
    return table.float()[buckets].permute(2, 0, 1)[None]


def mask_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] mask -> fp32 additive bias [B, 1, 1, S]."""
    neg = torch.finfo(torch.float32).min
    return torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                       neg).to(torch.float32)


class T5Attention(nn.Module):
    """Heads are counted from the local ``q`` rows, so the module serves
    tensor parallelism (``parallel/tp.py``) as it is; ``tp`` is set by
    ``tp.shard_model``."""

    tp = None

    def __init__(self, cfg: T5Config):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.d_kv = cfg.d_kv
        self.rate = cfg.dropout_rate
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        return x.view(B, S, -1, self.d_kv).transpose(1, 2)

    def forward(self, hidden, kv_hidden, bias, generator=None):
        """bias: [1 or B, H or 1, Sq, Skv] fp32, position bias plus mask."""
        dtype = hidden.dtype
        x = copy_in(hidden, self.tp)
        kv = x if kv_hidden is hidden else copy_in(kv_hidden, self.tp)
        q = self._heads(linear(x, self.q))
        k = self._heads(linear(kv, self.k))
        v = self._heads(linear(kv, self.v))
        if self.tp is not None:
            bias = self.tp.heads(bias, q.shape[1])
        # bf16 operands are exact in fp32: the einsum with
        # preferred_element_type=float32
        logits = q.float() @ k.float().transpose(-1, -2) + bias
        probs = torch.softmax(logits, dim=-1).to(dtype)
        probs = dropout(probs, self.rate, generator)
        ctx = (probs.float() @ v.float()).to(dtype)  # [B, H, Sq, d_kv]
        B, _, S, _ = ctx.shape
        return row_linear(ctx.transpose(1, 2).reshape(B, S, -1), self.o,
                          self.tp)


class T5FeedForward(nn.Module):
    tp = None

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.act = ACT2FN["gelu_new" if cfg.ff_act == "gelu" else cfg.ff_act]
        self.gated = cfg.is_gated
        self.rate = cfg.dropout_rate
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, hidden, generator=None):
        hidden = copy_in(hidden, self.tp)
        if self.gated:
            hidden = self.act(linear(hidden, self.wi_0)) * linear(hidden,
                                                                 self.wi_1)
        else:
            hidden = self.act(linear(hidden, self.wi))
        hidden = dropout(hidden, self.rate, generator)
        return row_linear(hidden, self.wo, self.tp)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool = False):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.rate = cfg.dropout_rate
        self.self_attn_ln = RMSNorm(cfg.d_model, eps)
        self.self_attn = T5Attention(cfg)
        self.is_decoder = is_decoder
        if is_decoder:
            self.cross_attn_ln = RMSNorm(cfg.d_model, eps)
            self.cross_attn = T5Attention(cfg)
        self.ff_ln = RMSNorm(cfg.d_model, eps)
        self.ff = T5FeedForward(cfg)

    def forward(self, hidden, self_bias, enc_hidden=None, cross_bias=None,
                generator=None):
        normed = self.self_attn_ln(hidden)
        hidden = hidden + dropout(
            self.self_attn(normed, normed, self_bias, generator), self.rate,
            generator)
        if self.is_decoder:
            normed = self.cross_attn_ln(hidden)
            hidden = hidden + dropout(
                self.cross_attn(normed, enc_hidden, cross_bias, generator),
                self.rate, generator)
        normed = self.ff_ln(hidden)
        return hidden + dropout(self.ff(normed, generator), self.rate,
                                generator)


class _T5Stack(nn.Module):
    """What both modules share: the embedding and the encoder stack. Under
    tensor parallelism (``tp`` set) a position table enters the attentions,
    which take their heads' columns of it, through the
    copy-to-model-group, so each rank's table gradient is the full one."""

    tp = None

    def _position_bias(self, table, q_len: int, k_len: int,
                       bidirectional: bool) -> torch.Tensor:
        return position_bias(copy_in(table, self.tp), q_len, k_len,
                             bidirectional, self.config)

    def _embed(self, ids: torch.Tensor, generator) -> torch.Tensor:
        return dropout(self.shared(ids.long()).to(self.dtype),
                       self.config.dropout_rate, generator)

    def _encode(self, input_ids, attention_mask, table, layers, final_ln,
                generator):
        cfg = self.config
        S = input_ids.shape[1]
        bias = self._position_bias(table, S, S, True) + mask_bias(
            attention_mask)
        hidden = self._embed(input_ids, generator)
        for layer in layers:
            hidden = layer(hidden, bias, generator=generator)
        return dropout(final_ln(hidden), cfg.dropout_rate, generator)


class T5Encoder(_T5Stack):
    """Returns {"last_hidden_state": [B, S, d_model]} in ``dtype``."""

    def __init__(self, config: T5Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.rel_bias = nn.Parameter(
            torch.zeros(cfg.relative_attention_num_buckets, cfg.num_heads))
        self.layers = nn.ModuleList(T5Block(cfg)
                                    for _ in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                generator: Optional[torch.Generator] = None) -> dict:
        """``token_type_ids`` is accepted and ignored (T5 has none);
        ``generator`` turns dropout on, in training mode only."""
        if not self.training:
            generator = None
        hidden = self._encode(input_ids, attention_mask, self.rel_bias,
                              self.layers, self.final_ln, generator)
        return {"last_hidden_state": hidden}


class T5EncoderDecoderStep(_T5Stack):
    """Encode, then one decoder step fed ``decoder_start_token_id``.
    Returns {"decoder_hidden": [B, 1, d], "logits": [B, 1, V],
    "last_hidden_state": [B, S, d]}."""

    def __init__(self, config: T5Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        buckets = (cfg.relative_attention_num_buckets, cfg.num_heads)
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.enc_rel_bias = nn.Parameter(torch.zeros(buckets))
        self.dec_rel_bias = nn.Parameter(torch.zeros(buckets))
        self.enc_layers = nn.ModuleList(T5Block(cfg)
                                        for _ in range(cfg.num_layers))
        self.dec_layers = nn.ModuleList(
            T5Block(cfg, is_decoder=True)
            for _ in range(cfg.num_decoder_layers))
        self.enc_final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.dec_final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        nn.Linear(cfg.d_model, cfg.vocab_size, bias=False))
        # the tied head's d_model ** -0.5, rounded to ``dtype`` once and
        # kept as a host scalar: no copy to the card a call (which a CUDA
        # graph capture forbids)
        self.lm_scale = float(torch.tensor(cfg.d_model ** -0.5, dtype=dtype))

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                generator: Optional[torch.Generator] = None) -> dict:
        """``token_type_ids`` is accepted and ignored (T5 has none);
        ``generator`` turns dropout on, in training mode only."""
        cfg = self.config
        if not self.training:
            generator = None
        enc_hidden = self._encode(input_ids, attention_mask,
                                  self.enc_rel_bias, self.enc_layers,
                                  self.enc_final_ln, generator)
        B = input_ids.shape[0]
        dec_ids = torch.full((B, 1), cfg.decoder_start_token_id,
                             dtype=torch.long, device=input_ids.device)
        hidden = self._embed(dec_ids, generator)
        self_bias = self._position_bias(self.dec_rel_bias, 1, 1, False)
        cross_bias = mask_bias(attention_mask)  # no position bias
        for layer in self.dec_layers:
            hidden = layer(hidden, self_bias, enc_hidden, cross_bias,
                           generator)
        hidden = dropout(self.dec_final_ln(hidden), cfg.dropout_rate,
                         generator)
        return {"decoder_hidden": hidden, "logits": self._lm_logits(hidden),
                "last_hidden_state": enc_hidden}

    def _lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return F.linear(hidden * self.lm_scale,
                            self.shared.weight.to(self.dtype))
        return linear(hidden, self.lm_head)


class T5Seq2Seq(T5EncoderDecoderStep):
    """The encoder-decoder with teacher forcing over any decoder ids (JAX
    ``T5Seq2Seq``). Its parameters are ``T5EncoderDecoderStep``'s, so
    ``encdec_state_from_hf``, ``load_t5_encdec`` and
    ``jax_convert.t5_state_from_jax`` serve it.

    ``forward(input_ids, attention_mask, decoder_input_ids,
    decoder_attention_mask=None)`` returns {"logits": [B, T, V],
    "decoder_hidden", "last_hidden_state"}. The decoder's self-attention
    bias is the position bias plus the causal bias (``finfo(float32).min``
    above the diagonal), plus the decoder mask's bias when one is given,
    added in that order in fp32: where both masks apply the sum is
    ``-inf``, as in JAX. ``encode`` and ``decode`` split the two halves
    for ``greedy_generate``, which encodes once per batch."""

    def encode(self, input_ids, attention_mask, generator=None):
        return self._encode(input_ids, attention_mask, self.enc_rel_bias,
                            self.enc_layers, self.enc_final_ln, generator)

    def decode(self, enc_hidden, attention_mask, decoder_input_ids,
               decoder_attention_mask=None, generator=None):
        """(decoder_hidden [B, T, d], logits [B, T, V])."""
        cfg = self.config
        T = decoder_input_ids.shape[1]
        hidden = self._embed(decoder_input_ids, generator)
        pos = torch.arange(T, device=hidden.device)
        causal = torch.where(pos[None, :] <= pos[:, None], 0.0,
                             torch.finfo(torch.float32).min)[None, None]
        self_bias = self._position_bias(self.dec_rel_bias, T, T,
                                        False) + causal
        if decoder_attention_mask is not None:
            self_bias = self_bias + mask_bias(decoder_attention_mask)
        cross_bias = mask_bias(attention_mask)  # no position bias
        for layer in self.dec_layers:
            hidden = layer(hidden, self_bias, enc_hidden, cross_bias,
                           generator)
        hidden = dropout(self.dec_final_ln(hidden), cfg.dropout_rate,
                         generator)
        return hidden, self._lm_logits(hidden)

    def forward(self, input_ids, attention_mask, decoder_input_ids,
                decoder_attention_mask=None,
                generator: Optional[torch.Generator] = None) -> dict:
        """``generator`` turns dropout on, in training mode only."""
        if not self.training:
            generator = None
        enc_hidden = self.encode(input_ids, attention_mask, generator)
        hidden, logits = self.decode(enc_hidden, attention_mask,
                                     decoder_input_ids,
                                     decoder_attention_mask, generator)
        return {"logits": logits, "decoder_hidden": hidden,
                "last_hidden_state": enc_hidden}


def shift_right(ids: torch.Tensor, start_token_id: int,
                pad_token_id: int = 0) -> torch.Tensor:
    """Teacher-forcing decoder inputs: [start, y_0, ..., y_{T-2}], -100
    read as pad."""
    shifted = torch.roll(ids, 1, dims=-1)
    shifted[:, 0] = start_token_id
    return torch.where(shifted == -100, pad_token_id, shifted)


def seq2seq_loss(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Token-mean cross-entropy over labelled positions (mask 0 = pad); the
    labels are clamped at 0, as optax's integer-label loss is fed."""
    labels = torch.clamp(labels.long(), min=0)
    losses = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels[..., None])[..., 0]
    m = mask.to(torch.float32)
    return (losses * m).sum() / torch.clamp(m.sum(), min=1.0)


@torch.no_grad()
def greedy_generate(model: T5Seq2Seq, input_ids, attention_mask,
                    max_new_tokens: int = 32, eos_token_id: int = 1,
                    temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Autoregressive decode with no KV cache (JAX ``greedy_generate``):
    the encoder runs once, the decoder recomputes the whole prefix at each
    step (O(T^2) in the decoder length; fine for queries). Returns
    [B, max_new_tokens] ids; a row's tokens after its eos are eos.

    ``temperature > 0`` samples from softmax(logits / temperature) with
    Gumbel noise from ``generator`` (JAX gates sampling on a temperature
    and a key alike: without ``generator`` it decodes greedily)."""
    cfg = model.config
    B = input_ids.shape[0]
    device = input_ids.device
    dec = torch.full((B, max_new_tokens + 1), cfg.pad_token_id,
                     dtype=torch.long, device=device)
    dec[:, 0] = cfg.decoder_start_token_id
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    enc_hidden = model.encode(input_ids, attention_mask)
    for t in range(max_new_tokens):
        logits = model.decode(enc_hidden, attention_mask,
                              dec[:, : t + 1])[1][:, t, :]
        if temperature and generator is not None:
            nxt = categorical(logits / temperature, generator)
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(finished, eos_token_id, nxt)
        dec[:, t + 1] = nxt
        finished = finished | (nxt == eos_token_id)
    return dec[:, 1:]


# ---- HF checkpoints --------------------------------------------------------


def _block_state(sd, hf_prefix: str, prefix: str, cfg: T5Config,
                 is_decoder: bool) -> Dict[str, torch.Tensor]:
    out = {}

    def attn(hf, ours):
        for n in ("q", "k", "v", "o"):
            out[f"{prefix}.{ours}.{n}.weight"] = sd[
                f"{hf_prefix}.{hf}.{n}.weight"]

    attn("layer.0.SelfAttention", "self_attn")
    out[f"{prefix}.self_attn_ln.weight"] = sd[
        f"{hf_prefix}.layer.0.layer_norm.weight"]
    ff = 1
    if is_decoder:
        attn("layer.1.EncDecAttention", "cross_attn")
        out[f"{prefix}.cross_attn_ln.weight"] = sd[
            f"{hf_prefix}.layer.1.layer_norm.weight"]
        ff = 2
    names = ("wi_0", "wi_1", "wo") if cfg.is_gated else ("wi", "wo")
    for n in names:
        out[f"{prefix}.ff.{n}.weight"] = sd[
            f"{hf_prefix}.layer.{ff}.DenseReluDense.{n}.weight"]
    out[f"{prefix}.ff_ln.weight"] = sd[
        f"{hf_prefix}.layer.{ff}.layer_norm.weight"]
    return out


def _shared(sd) -> torch.Tensor:
    """``shared.weight``, or the encoder's tied copy when it was left out."""
    return sd["shared.weight"] if "shared.weight" in sd \
        else sd["encoder.embed_tokens.weight"]


def encoder_state_from_hf(sd, cfg: T5Config) -> Dict[str, torch.Tensor]:
    """An HF T5 state dict -> the port's ``T5Encoder`` state (fp32)."""
    sd = {k: v.float() for k, v in sd.items()}
    out = {"shared.weight": _shared(sd),
           "rel_bias": sd["encoder.block.0.layer.0.SelfAttention."
                          "relative_attention_bias.weight"],
           "final_ln.weight": sd["encoder.final_layer_norm.weight"]}
    for i in range(cfg.num_layers):
        out.update(_block_state(sd, f"encoder.block.{i}", f"layers.{i}", cfg,
                                False))
    return out


def encdec_state_from_hf(sd, cfg: T5Config) -> Dict[str, torch.Tensor]:
    """An HF T5 state dict -> the port's ``T5EncoderDecoderStep`` state
    (fp32). ``lm_head.weight`` is read only when the model is untied."""
    sd = {k: v.float() for k, v in sd.items()}
    bias = "layer.0.SelfAttention.relative_attention_bias.weight"
    out = {"shared.weight": _shared(sd),
           "enc_rel_bias": sd[f"encoder.block.0.{bias}"],
           "dec_rel_bias": sd[f"decoder.block.0.{bias}"],
           "enc_final_ln.weight": sd["encoder.final_layer_norm.weight"],
           "dec_final_ln.weight": sd["decoder.final_layer_norm.weight"]}
    for i in range(cfg.num_layers):
        out.update(_block_state(sd, f"encoder.block.{i}", f"enc_layers.{i}",
                                cfg, False))
    for i in range(cfg.num_decoder_layers):
        out.update(_block_state(sd, f"decoder.block.{i}", f"dec_layers.{i}",
                                cfg, True))
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = sd["lm_head.weight"]
    return out


def _read_hf(path: str) -> Tuple[T5Config, Dict[str, torch.Tensor]]:
    with open(os.path.join(path, "config.json")) as f:
        cfg = t5_config_from_hf(json.load(f))
    return cfg, read_hf_state_dict(path)


def load_t5_encoder(path: str) -> Tuple[T5Config, Dict[str, torch.Tensor]]:
    """An HF T5 directory -> (T5Config, ``T5Encoder`` state dict)."""
    cfg, sd = _read_hf(path)
    return cfg, encoder_state_from_hf(sd, cfg)


def load_t5_encdec(path: str) -> Tuple[T5Config, Dict[str, torch.Tensor]]:
    """An HF T5 directory -> (T5Config, ``T5EncoderDecoderStep`` state)."""
    cfg, sd = _read_hf(path)
    return cfg, encdec_state_from_hf(sd, cfg)
