"""Precision of the plain references: float32 with TF32 off, and the
control's lower precision.

The configurations state bf16 compute, so the control is the reference
one step below it: computed in fp8 where the program computes in bf16.
Every matrix product's two operands and every activation the encoder
carries from one sublayer to the next (the residual stream, the reps) are
rounded to fp8 (e4m3, each tensor scaled so its largest magnitude is
fp8's largest, 448); products accumulate and norms and softmax run in
float32, as the program's do. The rounding passes gradients straight
through, so a control can also train."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """float32 matrix products without TF32 (restored on exit)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to scaled fp8 e4m3 and back to float32; the gradient
    passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def activation(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """An activation carried on in the reference's ``precision``."""
    return x if precision is None else fp8_round(x)


def operands(a: torch.Tensor, b: torch.Tensor,
             precision: Optional[str]) -> tuple:
    """The two operands of a product in the reference's ``precision``:
    None (float32) or "fp8"."""
    a, b = a.float(), b.float()
    if precision is None:
        return a, b
    if precision == "fp8":
        return fp8_round(a), fp8_round(b)
    raise ValueError(f"unknown precision {precision!r}")


def matmul(a, b, precision: Optional[str] = None) -> torch.Tensor:
    a, b = operands(a, b, precision)
    return a @ b


def linear(x, w, b=None, precision: Optional[str] = None) -> torch.Tensor:
    """``x @ w.T + b`` (an HF linear: ``w`` is [out, in])."""
    x, w = operands(x, w, precision)
    y = x @ w.T
    return y if b is None else y + b.float()
