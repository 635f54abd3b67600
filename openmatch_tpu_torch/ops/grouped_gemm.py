"""The grouped expert GEMM of the mixture-of-experts layers: one product
per expert over the rows routed to it, with each expert's rows known only
on the device.

``grouped_gemm(x, w, offsets)``: ``x`` [M, K] holds routed rows sorted by
expert, ``w`` [E, N, K] one ``nn.Linear`` weight per expert, ``offsets``
[E + 1] int32 the first row of each expert and the end of the last
(``offsets[e]`` .. ``offsets[e + 1] - 1`` are expert e's rows). Returns
``out`` [M, N] with ``out[r] = x[r] @ w[e].T`` in fp32 sums rounded once to
``x``'s dtype. Rows at or past ``offsets[E]`` are left unset: the routing
puts its unrouted slots there.

A CUDA tensor launches ``csrc/grouped_gemm.cu`` (bf16, ``N % 8 == 0``,
``K % 8 == 0``; one launch of one persistent block per SM, which derive
their work tiles from the offsets on the card, so nothing is read back and
the call can be captured in a CUDA graph), counted in
``_build.launches``. A CPU tensor takes ``grouped_gemm_plain``,
the same contract as a loop over experts with the offsets read on the
host. Nothing falls back from one to the other. The kernel replaces no TPU
kernel; its source says why it was added and what bounds it.
"""

from __future__ import annotations

import torch

from ._build import check, load_library


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """``grouped_gemm`` as a loop over experts (the offsets read on the
    host): the plain version the CPU takes and the card's kernel is
    compared with."""
    out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                      device=x.device)
    bounds = offsets.tolist()
    for e in range(w.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            out[lo:hi] = (x[lo:hi].float() @ w[e].float().T).to(x.dtype)
    return out


def _check(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor):
    if x.dim() != 2 or w.dim() != 3 or w.shape[2] != x.shape[1] \
            or offsets.shape != (w.shape[0] + 1,):
        raise ValueError(
            f"grouped_gemm: x {tuple(x.shape)}, w {tuple(w.shape)} and "
            f"offsets {tuple(offsets.shape)} must be [M, K], [E, N, K] and "
            "[E + 1]")
    if x.device.type == "cpu":
        return
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 \
            or offsets.dtype != torch.int32:
        raise ValueError(f"grouped_gemm takes bf16 x and w and int32 "
                         f"offsets, got {x.dtype}, {w.dtype}, "
                         f"{offsets.dtype}")
    if w.shape[1] % 8 or w.shape[2] % 8:
        raise ValueError(f"grouped_gemm needs N % 8 == 0 and K % 8 == 0, "
                         f"got w {tuple(w.shape)}")
    for t in (x, w, offsets):
        if t.device != x.device:
            raise ValueError(f"grouped_gemm: tensors on {t.device} and "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("grouped_gemm: operands must be contiguous and "
                             "16-byte aligned")


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    _check(x, w, offsets)
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, offsets)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    check(load_library().grouped_gemm_launch(
        x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        w.shape[0], x.shape[0], w.shape[1], w.shape[2],
        torch.cuda.current_stream(x.device).cuda_stream), "grouped_gemm")
    return out
