"""Building blocks of the v1 neural rerankers (port of
``openmatch_tpu/v1/modules.py``).

- ``Embedder``: an N(0, 1) table whose row 0 (padding) is zeroed in the
  forward, as the JAX version does (``table.at[0].set(0)``): the stored row
  0 may be non-zero, as in a JAX checkpoint, and gets no gradient.
- ``Conv1DEncoder``: per-kernel-size VALID 1-D convolutions and ReLU,
  returning the max-pooled summary and the per-size sequences. A Flax
  ``nn.Conv`` kernel is [W, in, out] channels-last; ``conv1d`` takes
  [out, in, W] channels-first (both are cross-correlations, so no flip).
- ``TransformerEncoder``: sinusoidal positions and post-LN blocks with
  standard multi-head attention scaled by ``head_dim ** -0.5``; the mask
  bias is -1e32 in fp32, so an all-pad row stays uniform, not NaN.
  LayerNorms use Flax's epsilon, 1e-6.

Dense and conv weights start as Flax's defaults do (LeCun normal kernels,
zero biases); checkpoints cross with ``models/jax_convert.py``.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FLAX_LN_EPS = 1e-6


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """Flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def dense(in_dim: int, out_dim: int) -> nn.Linear:
    """``nn.Dense``: LeCun-normal kernel, zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    lecun_normal_(layer.weight, in_dim)
    nn.init.zeros_(layer.bias)
    return layer


class Embedder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(vocab_size, embed_dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        return F.embedding(ids, self.embedding) * (ids != 0)[..., None]


class Conv1DEncoder(nn.Module):
    def __init__(self, embed_dim: int, kernel_dim: int,
                 kernel_sizes: Sequence[int] = (2, 3, 4, 5)):
        super().__init__()
        self.kernel_sizes = tuple(kernel_sizes)
        self.kernel_dim = kernel_dim
        self.convs = nn.ModuleDict()
        for size in self.kernel_sizes:
            conv = nn.Conv1d(embed_dim, kernel_dim, size)
            lecun_normal_(conv.weight, embed_dim * size)
            nn.init.zeros_(conv.bias)
            self.convs[f"conv_{size}"] = conv

    @property
    def output_dim(self) -> int:
        return self.kernel_dim * len(self.kernel_sizes)

    def forward(self, embed: torch.Tensor, masks: torch.Tensor = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """embed [B, L, D] -> (summary [B, kernel_dim * n_sizes], one
        [B, L - size + 1, kernel_dim] sequence per size)."""
        if masks is not None:
            embed = embed * masks[..., None].to(embed.dtype)
        channels_first = embed.transpose(1, 2)
        seq_encs, pooled = [], []
        for size in self.kernel_sizes:
            conv = F.relu(self.convs[f"conv_{size}"](channels_first))
            conv = conv.transpose(1, 2)
            seq_encs.append(conv)
            pooled.append(conv.max(dim=1).values)
        summary = torch.cat(pooled, dim=1) if len(pooled) > 1 else pooled[0]
        return summary, seq_encs


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None]
    i = np.arange(dim)[None, :]
    angle = pos / np.power(1.0e4, 2.0 * (i // 2) / dim)
    table = np.zeros((max_len, dim), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class TransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, head_num: int = 8,
                 hidden_dim: int = 2048):
        super().__init__()
        self.head_num = head_num
        self.head_dim = embed_dim // head_num
        inner = head_num * self.head_dim
        # DenseGeneral D -> (H, hd) and (H, hd) -> D, flattened
        self.q = dense(embed_dim, inner)
        self.k = dense(embed_dim, inner)
        self.v = dense(embed_dim, inner)
        self.out = dense(inner, embed_dim)
        self.attn_ln = nn.LayerNorm(embed_dim, eps=FLAX_LN_EPS)
        self.fc1 = dense(embed_dim, hidden_dim)
        self.fc2 = dense(hidden_dim, embed_dim)
        self.ff_ln = nn.LayerNorm(embed_dim, eps=FLAX_LN_EPS)

    def forward(self, embed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, _ = embed.shape
        H, hd = self.head_num, self.head_dim

        def heads(layer):
            return layer(embed).view(B, L, H, hd).transpose(1, 2)

        q, k, v = heads(self.q), heads(self.k), heads(self.v)
        logits = (q @ k.transpose(-1, -2)) * (hd ** -0.5)  # [B, H, L, L]
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e32).to(
            torch.float32)
        probs = torch.softmax(logits.float() + bias, dim=-1).to(embed.dtype)
        ctx = (probs @ v).transpose(1, 2).reshape(B, L, H * hd)
        hidden = self.attn_ln(embed + self.out(ctx))
        ff = self.fc2(F.relu(self.fc1(hidden)))
        return self.ff_ln(hidden + ff)


class TransformerEncoder(nn.Module):
    def __init__(self, embed_dim: int, head_num: int = 8,
                 hidden_dim: int = 2048, layer_num: int = 6,
                 max_len: int = 512):
        super().__init__()
        self.register_buffer(
            "positions", torch.from_numpy(sinusoidal_positions(max_len,
                                                               embed_dim)),
            persistent=False)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, head_num, hidden_dim)
            for _ in range(layer_num))

    def forward(self, embed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        enc = embed + self.positions[: embed.shape[1]][None].to(embed.dtype)
        for layer in self.layers:
            enc = layer(enc, mask)
        return enc
