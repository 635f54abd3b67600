"""Exact top-k search over the doc-major corpus with hand-written kernels.

Port of the production path of ``openmatch_tpu/ops/pallas_mips.py``
(``pallas_plain_topk_prepared``), single buffer, one corpus copy:

  A. ``fused_plain_gmax`` streams the corpus once and emits the score
     maximum of every 8-doc block, plus the first pyramid level (maxima of
     8 consecutive blocks). Kernel: ``csrc/plain_gmax.cu``.
  B. ``_select_groups`` (``ops/mips.py``): exact max-pyramid top-k of
     blocks.
  C. ``gather_rescore`` scores the 8 docs of every selected block exactly.
     Kernel: ``csrc/gather_rescore.cu``.

Then the ragged ``N % 8`` tail is scored densely and one ``torch.topk``
picks the final k.

Each kernel wrapper dispatches on where its tensors lie: a CPU tensor
goes to the plain PyTorch version beside it, a CUDA tensor launches the
kernel or raises; nothing falls back from one to the other. Each wrapper
counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ._build import check, load_library
from .mips import FANOUT, NEG, _select_groups, exact_search, pyramid_fanouts

GROUP = 8
MAX_SMEM_D = 12288  # gather_rescore stages the query row (fp32) in 48 KB
GMAX_CHUNK_BLOCKS = 8192  # plain gmax: fp32 staging of 64k corpus rows
RESCORE_Q_CHUNK = 16  # plain rescore: [16, k, 8, D] fp32 rows at a time


class BlockCorpus(NamedTuple):
    """The prepared doc-major layout: one corpus copy serves both kernels."""

    tail: torch.Tensor  # [N % 8, D] the ragged tail docs
    n_docs: int         # true N
    plain: torch.Tensor  # [NB * 8, D] the first NB * 8 docs (a view)


def prepare_plain_corpus(corpus: torch.Tensor) -> BlockCorpus:
    """Split [N, D] into the 8-doc-block body and the ragged tail. Both are
    views of ``corpus``: nothing is copied or padded."""
    if corpus.dim() != 2:
        raise ValueError(f"corpus must be [N, D], got {tuple(corpus.shape)}")
    N = corpus.shape[0]
    nb_rows = (N // GROUP) * GROUP
    return BlockCorpus(tail=corpus[nb_rows:], n_docs=N,
                       plain=corpus[:nb_rows])


def _check_cuda_operands(name: str, *tensors: torch.Tensor):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


# ---------------------------------------------------------------------------
# K1/K2: block maxima (+ level 1, + masking)
# ---------------------------------------------------------------------------


def plain_gmax_reference(
    queries: torch.Tensor, plain: torch.Tensor, blk_lo: int = 0,
    n_blk: Optional[int] = None, emit_l1: int = 0,
    nb_valid: Optional[int] = None,
):
    """Plain PyTorch version of the gmax kernel (same arguments and
    outputs as ``fused_plain_gmax``): fp32 products chunked over the
    corpus, 8-row maxima, masking, then the level-1 maxima."""
    Q = queries.shape[0]
    NB = plain.shape[0] // GROUP
    if n_blk is None:
        n_blk = NB - blk_lo
    q = queries.float()
    gmax = torch.empty((Q, n_blk), dtype=torch.float32, device=queries.device)
    for lo in range(0, n_blk, GMAX_CHUNK_BLOCKS):
        hi = min(lo + GMAX_CHUNK_BLOCKS, n_blk)
        rows = plain[(blk_lo + lo) * GROUP:(blk_lo + hi) * GROUP].float()
        gmax[:, lo:hi] = (q @ rows.T).view(Q, hi - lo, GROUP).amax(-1)
    if nb_valid is not None:
        gmax[:, max(nb_valid - blk_lo, 0):] = NEG
    if not emit_l1:
        return gmax
    pad = (-n_blk) % emit_l1
    padded = torch.nn.functional.pad(gmax, (0, pad), value=NEG) if pad else gmax
    return gmax, padded.view(Q, -1, emit_l1).amax(-1)


def fused_plain_gmax(
    queries: torch.Tensor, plain: torch.Tensor, blk_lo: int = 0,
    n_blk: Optional[int] = None, emit_l1: int = 0,
    nb_valid: Optional[int] = None,
):
    """Per-block score maxima over corpus blocks [blk_lo, blk_lo + n_blk).

    queries [Q, D], plain [NB * 8, D] doc-major. Returns gmax [Q, n_blk]
    fp32; with ``emit_l1`` = f > 0 returns (gmax, l1) with l1
    [Q, ceil(n_blk / f)] the maxima of f consecutive blocks of the window.
    ``nb_valid`` sets blocks with global id >= nb_valid to
    finfo(float32).min in both outputs.

    CPU tensors run ``plain_gmax_reference``; CUDA tensors (bf16) launch
    ``csrc/plain_gmax.cu``."""
    if queries.dim() != 2 or plain.dim() != 2 \
            or queries.shape[1] != plain.shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} and corpus "
                         f"{tuple(plain.shape)} must be [Q, D] and [N, D]")
    if plain.shape[0] % GROUP:
        raise ValueError(f"corpus rows {plain.shape[0]} % {GROUP} != 0")
    NB = plain.shape[0] // GROUP
    if n_blk is None:
        n_blk = NB - blk_lo
    if not (0 <= blk_lo and 0 <= n_blk and blk_lo + n_blk <= NB):
        raise ValueError(f"window [{blk_lo}, {blk_lo + n_blk}) outside "
                         f"{NB} blocks")
    if emit_l1 and 16 % emit_l1:
        raise ValueError(f"emit_l1={emit_l1} must divide 16")
    if not queries.is_cuda:
        return plain_gmax_reference(queries, plain, blk_lo, n_blk, emit_l1,
                                    nb_valid)

    Q, D = queries.shape
    if queries.dtype != torch.bfloat16 or plain.dtype != torch.bfloat16:
        raise ValueError("the gmax kernel takes bf16 queries and corpus, got "
                         f"{queries.dtype} and {plain.dtype}")
    if D % 8:
        raise ValueError(f"the gmax kernel needs D % 8 == 0, got D={D}")
    _check_cuda_operands("fused_plain_gmax", queries, plain)
    gmax = torch.empty((Q, n_blk), dtype=torch.float32, device=queries.device)
    l1 = torch.empty((Q, -(-n_blk // emit_l1)), dtype=torch.float32,
                     device=queries.device) if emit_l1 else None
    if Q and n_blk:
        lib = load_library()
        rc = lib.plain_gmax_launch(
            queries.data_ptr(), plain.data_ptr(), gmax.data_ptr(),
            l1.data_ptr() if l1 is not None else None, Q, D, blk_lo, n_blk,
            nb_valid if nb_valid is not None else blk_lo + n_blk, emit_l1,
            torch.cuda.current_stream(queries.device).cuda_stream)
        check(rc, "plain_gmax")
        fused_plain_gmax.launches += 1
    return (gmax, l1) if emit_l1 else gmax


fused_plain_gmax.launches = 0


# ---------------------------------------------------------------------------
# K3: gather-rescore of the selected blocks
# ---------------------------------------------------------------------------


def gather_rescore_reference(queries: torch.Tensor, plain: torch.Tensor,
                             bids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gather-rescore kernel: gather the
    [8, D] rows of every selected block, then an fp32 einsum."""
    Q, D = queries.shape
    NB = plain.shape[0] // GROUP
    k = bids.shape[1]
    blocks = plain.view(NB, GROUP, D)
    b = bids.long().clamp(0, NB - 1)
    out = torch.empty((Q, k * GROUP), dtype=torch.float32,
                      device=queries.device)
    for lo in range(0, Q, RESCORE_Q_CHUNK):
        hi = min(lo + RESCORE_Q_CHUNK, Q)
        rows = blocks[b[lo:hi]].float()  # [q, k, 8, D]
        out[lo:hi] = torch.einsum("qd,qkmd->qkm", queries[lo:hi].float(),
                                  rows).reshape(hi - lo, k * GROUP)
    return out


def gather_rescore(queries: torch.Tensor, plain: torch.Tensor,
                   bids: torch.Tensor) -> torch.Tensor:
    """out[q, j*8 + m] = <queries[q], plain[bids[q, j]*8 + m]>, fp32 [Q, k*8].

    Block ids outside [0, NB) are clamped. CPU tensors run
    ``gather_rescore_reference``; CUDA tensors (bf16 operands, int32 ids)
    launch ``csrc/gather_rescore.cu``."""
    if queries.dim() != 2 or plain.dim() != 2 or bids.dim() != 2 \
            or queries.shape[1] != plain.shape[1] \
            or bids.shape[0] != queries.shape[0]:
        raise ValueError(f"shapes queries {tuple(queries.shape)}, corpus "
                         f"{tuple(plain.shape)}, bids {tuple(bids.shape)}")
    if plain.shape[0] % GROUP or plain.shape[0] == 0:
        raise ValueError(f"corpus rows {plain.shape[0]} must be a positive "
                         f"multiple of {GROUP}")
    if not queries.is_cuda:
        return gather_rescore_reference(queries, plain, bids)

    Q, D = queries.shape
    k = bids.shape[1]
    if queries.dtype != torch.bfloat16 or plain.dtype != torch.bfloat16:
        raise ValueError("the rescore kernel takes bf16 queries and corpus, "
                         f"got {queries.dtype} and {plain.dtype}")
    if bids.dtype != torch.int32:
        raise ValueError(f"block ids must be int32, got {bids.dtype}")
    if D % 8 or D > MAX_SMEM_D:
        raise ValueError(f"the rescore kernel needs D % 8 == 0 and "
                         f"D <= {MAX_SMEM_D}, got D={D}")
    _check_cuda_operands("gather_rescore", queries, plain, bids)
    out = torch.empty((Q, k * GROUP), dtype=torch.float32,
                      device=queries.device)
    if Q and k:
        lib = load_library()
        rc = lib.gather_rescore_launch(
            queries.data_ptr(), plain.data_ptr(), bids.data_ptr(),
            out.data_ptr(), Q, D, k, plain.shape[0] // GROUP,
            torch.cuda.current_stream(queries.device).cuda_stream)
        check(rc, "gather_rescore")
        gather_rescore.launches += 1
    return out


gather_rescore.launches = 0


# ---------------------------------------------------------------------------
# The search pipeline
# ---------------------------------------------------------------------------


def _plain_topk_core(queries: torch.Tensor, plain: torch.Tensor,
                     tail_rows: torch.Tensor, n_docs: int,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """gmax kernel -> pyramid selection -> gather-rescore -> tail -> top-k.

    ``plain`` holds at least the first ``n_docs // 8 * 8`` docs; rows past
    them (zero padding from a caller) are masked out of selection and their
    candidates scored finfo(float32).min, so a pad row scoring 0 can never
    displace a real doc that scores below 0."""
    Q = queries.shape[0]
    NB = n_docs // GROUP
    NBp = plain.shape[0] // GROUP
    nb_valid = NB if NBp > NB else None
    fanouts = pyramid_fanouts(NBp, k)
    if fanouts:
        # the gmax kernel emits pyramid level 1 while the scores are on chip
        gmax, l1 = fused_plain_gmax(queries, plain, emit_l1=FANOUT,
                                    nb_valid=nb_valid)
        bid = _select_groups(gmax, k, l1=l1)
    else:
        gmax = fused_plain_gmax(queries, plain, nb_valid=nb_valid)
        bid = _select_groups(gmax, k)
    cand = gather_rescore(queries, plain, bid.to(torch.int32))
    ids = (bid[:, :, None] * GROUP
           + torch.arange(GROUP, device=bid.device)).reshape(Q, -1)
    if NBp > NB:
        cand = cand.masked_fill(ids >= NB * GROUP, NEG)
    tail = n_docs - NB * GROUP
    if tail:
        tail_scores = queries.float() @ tail_rows.float().T
        tail_ids = NB * GROUP + torch.arange(tail, device=ids.device)
        cand = torch.cat([cand, tail_scores], dim=1)
        ids = torch.cat([ids, tail_ids.expand(Q, tail)], dim=1)
    s, pos = torch.topk(cand, k, dim=1)
    return s, torch.gather(ids, 1, pos)


def plain_topk_prepared(queries: torch.Tensor, prep: BlockCorpus,
                        k: int = 1000) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a ``prepare_plain_corpus`` layout.

    Returns (scores [Q, min(k, N)] fp32 descending, doc indices int64).
    A corpus with ``NB // 2 <= k`` blocks is searched by ``exact_search``:
    the pyramid would select every block and repeat ids to fill k."""
    k = min(k, prep.n_docs)
    NB = prep.n_docs // GROUP
    if NB // 2 <= k:
        corpus = torch.cat([prep.plain[:NB * GROUP], prep.tail]) \
            if prep.tail.shape[0] else prep.plain[:NB * GROUP]
        return exact_search(queries, corpus, k=k)
    return _plain_topk_core(queries, prep.plain, prep.tail, prep.n_docs, k)
