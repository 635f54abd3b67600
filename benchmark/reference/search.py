"""Plain exact top-k over a row-major index, in float32 blocks.

Scores are float32 products of the queries with the index rows (read in
the index's stored type and widened), taken ``block_rows`` rows at a time
so the float32 copy of a block is the only transient; the running top-k
keeps the best ``k`` of every block seen. ``precision="fp8"`` rounds the
queries and each block to fp8 first (the control)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .quant import operands


def topk(queries: torch.Tensor, index: torch.Tensor, k: int,
         block_rows: int = 1 << 20, precision: Optional[str] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] descending, row ids [Q, k]) over all of ``index``."""
    best_s = best_i = None
    for lo in range(0, index.shape[0], block_rows):
        block = index[lo:lo + block_rows]
        q, b = operands(queries, block, precision)
        s = q @ b.T
        kk = min(k, s.shape[1])
        s, i = torch.topk(s, kk, dim=1)
        i = i + lo
        if best_s is not None:
            s, j = torch.topk(torch.cat([best_s, s], 1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], 1), 1, j)
        best_s, best_i = s, i
    return best_s, best_i


def scores_of(queries: torch.Tensor, index: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """float32 scores [Q, n] of each query against its rows ``ids`` [Q, n]."""
    rows = index[ids.reshape(-1).long()].float().view(*ids.shape, -1)
    return torch.einsum("qd,qnd->qn", queries.float(), rows)
