"""Gumbel draws and categorical sampling from an explicit
``torch.Generator``, under the laws of ``jax.random.gumbel`` and
``jax.random.categorical`` (which is ``argmax(logits + gumbel)``). The
callers take the noise as an argument too, so a test can feed the draws of
a JAX key and compare the results exactly."""

from __future__ import annotations

from typing import Optional

import torch


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` with u uniform on
    [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    u = torch.clamp(u, min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def categorical(logits: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One draw per row of ``logits`` [..., C] (unnormalised log
    probabilities): ``argmax(logits + noise)`` over the last axis, with
    Gumbel ``noise`` drawn from ``generator`` when not given."""
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device,
                             logits.dtype)
    return torch.argmax(logits + noise, dim=-1)
