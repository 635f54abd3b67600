"""Representation pooling and the bias-free linear head
(port of ``openmatch_tpu/models/pooling.py``; ``last`` pooling, for the
causal ``deepseek_v3`` backbone, is the port's own)."""

from __future__ import annotations

import torch
from torch import nn

from .bert import linear


def mean_pooling(hidden: torch.Tensor,
                 attention_mask: torch.Tensor) -> torch.Tensor:
    """Mask-aware mean over the sequence. hidden [B, S, D], mask [B, S]."""
    mask = attention_mask[..., None].to(hidden.dtype)
    summed = (hidden * mask).sum(dim=1)
    counts = mask.sum(dim=1).clamp_min(1e-9)
    return summed / counts


def last_pooling(hidden: torch.Tensor,
                 attention_mask: torch.Tensor) -> torch.Tensor:
    """The hidden state at each row's last unmasked position (right
    padding); position 0's for a row with none."""
    last = (attention_mask.sum(dim=1) - 1).clamp_min(0)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]


def pool_hidden(hidden: torch.Tensor, attention_mask: torch.Tensor,
                pooling: str) -> torch.Tensor:
    if pooling == "first":
        return hidden[:, 0, :]
    if pooling == "mean":
        return mean_pooling(hidden, attention_mask)
    if pooling == "last":
        return last_pooling(hidden, attention_mask)
    raise ValueError(f"Unknown pooling type: {pooling}")


class LinearHead(nn.Module):
    """Bias-free projection ``input_dim -> output_dim``; fp32 weight,
    applied in the input's dtype."""

    def __init__(self, input_dim: int = 768, output_dim: int = 768):
        super().__init__()
        self.linear = nn.Linear(input_dim, output_dim, bias=False)

    def forward(self, reps: torch.Tensor) -> torch.Tensor:
        return linear(reps, self.linear)
