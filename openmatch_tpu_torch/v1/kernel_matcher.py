"""RBF kernel-pooling matcher, the core of the KNRM family (port of
``openmatch_tpu/v1/kernel_matcher.py``).

- The kernel bank: mu = [1, 1 - b/2, 1 - 3b/2, ...] with b = 2 / (K - 1);
  sigma = [1e-3, 0.1, ..., 0.1]. The first kernel is a near-delta at
  cos = 1, the exact-match kernel.
- The masked cosine match matrix, an RBF per kernel, summed over the doc
  axis, ``log(clamp(sum, 1e-10)) * 0.01``, summed over the query axis:
  [B, K] features.

The match matrix is an IEEE fp32 product on every device, whatever
``torch.backends.cuda.matmul.allow_tf32`` says: with sigma = 1e-3, a TF32
cosine error of ~1e-3 moves the exact-match kernel's value by ~40%
(exp(-0.5)). ``ieee_bmm`` turns TF32 off around the forward product and
both backward products, and its backward is built from ``ieee_bmm`` itself,
so a gradient of a gradient stays fp32 too.

The normalisation keeps the JAX version's double ``where``: the norm's
square root is taken of 1 where a row is zero, so zero (pad) rows get a
zero gradient, not NaN, at any order of differentiation.

``KernelMatcher.cross`` matches every query encoding of a list against
every doc encoding of another (Conv-KNRM's 9 pairs, EDRM's 16) in one
batched computation; ``forward`` is its one-pair case. The JAX version
runs one XLA program; here one call in place of 9 or 16 cuts the launches
of a step or a scoring batch by as much.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def kernel_mus_sigmas(kernel_num: int) -> Tuple[np.ndarray, np.ndarray]:
    mus = [1.0]
    bin_size = 2.0 / (kernel_num - 1)
    mus.append(1 - bin_size / 2)
    for i in range(1, kernel_num - 1):
        mus.append(mus[i] - bin_size)
    sigmas = [0.001] + [0.1] * (kernel_num - 1)
    return np.asarray(mus, np.float32), np.asarray(sigmas, np.float32)


@contextlib.contextmanager
def _ieee_fp32():
    """TF32 off for the CUDA matmuls inside, restored after, through the
    flag API the process last used: reading the legacy ``allow_tf32``
    raises once ``fp32_precision`` has been set, and the two must not be
    mixed."""
    matmul = torch.backends.cuda.matmul
    try:
        old = matmul.allow_tf32
    except RuntimeError:  # the process sets fp32_precision: stay on it
        old = matmul.fp32_precision
        matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            matmul.fp32_precision = old
        return
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = old


class _IeeeBmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _ieee_fp32():
            return torch.bmm(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        return (ieee_bmm(grad, b.transpose(1, 2)),
                ieee_bmm(a.transpose(1, 2), grad))


def ieee_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` in IEEE fp32 (no TF32), differentiable to any
    order."""
    return _IeeeBmm.apply(a, b)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    sq = (x * x).sum(dim=-1, keepdim=True)
    nonzero = sq > 0
    norm = torch.sqrt(torch.where(nonzero, sq, torch.ones_like(sq)))
    return torch.where(nonzero, x / norm, torch.zeros_like(x))


class KernelMatcher(nn.Module):
    """The matcher as a module whose mus and sigmas are buffers (fixed, not
    trained, as in the reference)."""

    def __init__(self, kernel_num: int = 21):
        super().__init__()
        self.kernel_num = kernel_num
        mus, sigmas = kernel_mus_sigmas(kernel_num)
        self.register_buffer("mus", torch.from_numpy(mus), persistent=False)
        self.register_buffer("sigmas", torch.from_numpy(sigmas),
                             persistent=False)

    def forward(self, k_embed: torch.Tensor, k_mask: torch.Tensor,
                v_embed: torch.Tensor, v_mask: torch.Tensor) -> torch.Tensor:
        """k_embed [B, Lq, D], k_mask [B, Lq], v_embed [B, Lv, D],
        v_mask [B, Lv] -> [B, K]."""
        return self.cross([k_embed], [k_mask], [v_embed], [v_mask])

    def cross(self, k_embeds, k_masks, v_embeds, v_masks) -> torch.Tensor:
        """The matcher for each (query encoding, doc encoding) pair of the
        lists, each mask cut to its encoding's length, concatenated
        query-major: [B, len(k_embeds) * len(v_embeds) * K].

        The encodings are padded to the longest of their side. A padded doc
        position is left out of the doc sums and a padded query row out of
        the query sum; masked positions inside an encoding's length count,
        as in the reference (their match value is 0, not excluded)."""
        def stack(xs, masks, length):
            x = torch.stack([F.pad(t, (0, 0, 0, length - t.shape[1]))
                             for t in xs])  # [n, B, L, D]
            m = torch.stack([F.pad(mk[:, : t.shape[1]].to(t.dtype),
                                   (0, length - t.shape[1]))
                             for t, mk in zip(xs, masks)])  # [n, B, L]
            inside = torch.stack([
                torch.arange(length, device=x.device) < t.shape[1]
                for t in xs]).to(x.dtype)  # [n, L]
            return _normalize(x * m[..., None]), m, inside

        nk, nv = len(k_embeds), len(v_embeds)
        B = k_embeds[0].shape[0]
        lk = max(t.shape[1] for t in k_embeds)
        lv = max(t.shape[1] for t in v_embeds)
        k_norm, k_mask, k_in = stack(k_embeds, k_masks, lk)
        v_norm, v_mask, v_in = stack(v_embeds, v_masks, lv)
        D = k_norm.shape[-1]
        a = k_norm.float()[:, None].expand(nk, nv, B, lk, D).reshape(-1, lk, D)
        b = v_norm.float()[None].expand(nk, nv, B, lv, D).reshape(-1, lv, D)
        inter = ieee_bmm(a, b.transpose(1, 2)).view(nk, nv, B, lk, lv)
        inter = inter * (k_mask[:, None, :, :, None]
                         * v_mask[None, :, :, None, :])
        diff = inter[..., None] - self.mus  # [nk, nv, B, Lk, Lv, K]
        kernels = torch.exp(-(diff ** 2) / (self.sigmas ** 2) / 2)
        kernels = kernels * v_in[None, :, None, None, :, None]
        pooled = torch.log(torch.clamp(kernels.sum(dim=4), min=1e-10)) * 1e-2
        pooled = (pooled * k_in[:, None, None, :, None]).sum(dim=3)
        return pooled.permute(2, 0, 1, 3).reshape(B, -1)  # k-major, then v
