"""Exact top-k search over the doc-major corpus with hand-written kernels.

Port of the plain-layout path of ``openmatch_tpu/ops/pallas_mips.py``
(``pallas_plain_topk_prepared``), one corpus copy:

  A. ``fused_plain_gmax`` streams the corpus once and emits the score
     maximum of every 8-doc block, plus the first pyramid level (maxima of
     8 consecutive blocks). Kernel: ``csrc/plain_gmax.cu``.
  B. ``_select_groups`` (``ops/mips.py``): exact max-pyramid top-k of
     blocks.
  C. ``gather_rescore`` scores the 8 docs of every selected block exactly.
     Kernel: ``csrc/gather_rescore.cu``, or with ``pipeline=True``
     ``csrc/gather_rescore_pipelined.cu``.

Then the ragged ``N % 8`` tail is scored densely and one ``torch.topk``
picks the final k.

The corpus body is one buffer or, from ``prepare_plain_corpus(n_segs=n)``,
a tuple of segment tensors, each its own allocation (no single allocation
holds the whole index). A segmented body feeds one global selection:
``fused_plain_gmax_segs`` writes one shared gmax over all segments and
``gather_rescore`` routes each selected block to its segment; block ids
stay global. ``c_split`` instead searches a single buffer in sequential
windows, each with its own selection, which shrinks the [Q, NB] gmax.

Each kernel wrapper dispatches on where its tensors lie: a CPU tensor
goes to the plain PyTorch version beside it, a CUDA tensor launches the
kernel or raises; nothing falls back from one to the other. Each wrapper
counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ._build import check, load_library
from .mips import FANOUT, NEG, _select_groups, exact_search, pyramid_fanouts

GROUP = 8
MAX_SMEM_D = 12288  # gather_rescore stages the query row (fp32) in 48 KB
MAX_PIPELINED_D = 6144  # the pipelined rescore holds 34 * D bytes of smem
GMAX_CHUNK_BLOCKS = 8192  # plain gmax: fp32 staging of 64k corpus rows
RESCORE_Q_CHUNK = 16  # plain rescore: [16, k, 8, D] fp32 rows at a time
SEG_TILE_BLOCKS = 256  # segments and c_split windows cut at JAX's tile_g
GMAX_TILE_BLOCKS = 16  # blocks of one plain_gmax.cu tile
MAX_SEGS = 64  # csrc/segments.cuh: the by-value segment table's capacity

Body = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class BlockCorpus(NamedTuple):
    """The prepared doc-major layout: one corpus copy serves both kernels."""

    tail: torch.Tensor  # [N % 8, D] the ragged tail docs
    n_docs: int         # true N
    plain: Body  # [NB * 8, D] the first NB * 8 docs, or its segments


def split_tiles(total_tiles: int, n_segs: int) -> list:
    """Tile counts per corpus segment: ceil-split into ``n_segs``
    near-equal parts (the first total % n segments get one extra tile),
    clamped to at most one segment per tile. The JAX package's
    ``split_tiles``: both packages cut segments and windows alike."""
    n_segs = max(1, min(n_segs, total_tiles))
    seg_tiles = [total_tiles // n_segs] * n_segs
    for i in range(total_tiles % n_segs):
        seg_tiles[i] += 1
    return seg_tiles


def prepare_plain_corpus(corpus: torch.Tensor, n_segs: int = 1) -> BlockCorpus:
    """Split [N, D] into the 8-doc-block body and the ragged tail.

    With ``n_segs`` = 1 both are views of ``corpus``: nothing is copied or
    padded. With ``n_segs`` > 1 the body becomes a tuple of segments cut
    where the JAX package cuts them (``split_tiles`` over ceil(NB / 256)
    tiles of 256 blocks); the last segment holds the remainder unpadded.
    Every segment and the tail are copies, each its own allocation, so the
    caller's ``corpus`` can be freed."""
    if corpus.dim() != 2:
        raise ValueError(f"corpus must be [N, D], got {tuple(corpus.shape)}")
    if not 1 <= n_segs <= MAX_SEGS:
        raise ValueError(f"n_segs={n_segs} outside [1, {MAX_SEGS}]")
    N = corpus.shape[0]
    NB = N // GROUP
    body, tail = corpus[:NB * GROUP], corpus[NB * GROUP:]
    if n_segs == 1:
        return BlockCorpus(tail=tail, n_docs=N, plain=body)
    segs, lo = [], 0
    for nt in split_tiles(-(-NB // SEG_TILE_BLOCKS), n_segs):
        hi = min(lo + nt * SEG_TILE_BLOCKS, NB)
        segs.append(body[lo * GROUP:hi * GROUP].clone())
        lo = hi
    return BlockCorpus(tail=tail.clone(), n_docs=N, plain=tuple(segs))


def _segments(body: Body) -> Tuple[torch.Tensor, ...]:
    return body if isinstance(body, tuple) else (body,)


def _check_body(queries: torch.Tensor, segs) -> int:
    """Validate [Q, D] queries against [rows, D] segments; return NB."""
    if queries.dim() != 2 or not segs or any(
            s.dim() != 2 or s.shape[1] != queries.shape[1] for s in segs):
        raise ValueError(f"queries {tuple(queries.shape)} and corpus "
                         f"{[tuple(s.shape) for s in segs]} must be [Q, D] "
                         "and [N, D]")
    for s in segs:
        if s.shape[0] % GROUP:
            raise ValueError(f"corpus rows {s.shape[0]} % {GROUP} != 0")
    if len(segs) > MAX_SEGS:
        raise ValueError(f"{len(segs)} segments, at most {MAX_SEGS}")
    return sum(s.shape[0] for s in segs) // GROUP


def _seg_table(segs):
    """Host arrays of the segments' base pointers and cumulative first
    blocks, for the kernels' by-value segment table. The caller keeps them
    alive across the call."""
    blk0 = [0]
    for s in segs:
        blk0.append(blk0[-1] + s.shape[0] // GROUP)
    return ((ctypes.c_void_p * len(segs))(*(s.data_ptr() for s in segs)),
            (ctypes.c_longlong * len(blk0))(*blk0))


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
# K1/K2/K4: block maxima (+ level 1, + masking)
# ---------------------------------------------------------------------------


def _level1(gmax: torch.Tensor, f: int) -> torch.Tensor:
    """Maxima of f consecutive columns; a ragged last group takes the
    columns that exist."""
    pad = (-gmax.shape[1]) % f
    padded = torch.nn.functional.pad(gmax, (0, pad), value=NEG) if pad else gmax
    return padded.view(gmax.shape[0], -1, f).amax(-1)


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
    return (gmax, _level1(gmax, emit_l1)) if emit_l1 else gmax


def _gmax_launch(wrapper, queries: torch.Tensor, segs, blk_lo: int,
                 n_blk: int, emit_l1: int, nb_valid: Optional[int]):
    """Launch ``csrc/plain_gmax.cu`` over the window [blk_lo, blk_lo +
    n_blk) of the segments' global blocks, counted in ``wrapper.launches``;
    returns gmax or (gmax, l1)."""
    name = wrapper.__name__
    Q, D = queries.shape
    if queries.dtype != torch.bfloat16 or any(
            s.dtype != torch.bfloat16 for s in segs):
        raise ValueError("the gmax kernel takes bf16 queries and corpus, got "
                         f"{queries.dtype} and {segs[0].dtype}")
    if D % 8:
        raise ValueError(f"the gmax kernel needs D % 8 == 0, got D={D}")
    _check_cuda_operands(name, queries, *segs)
    gmax = torch.empty((Q, n_blk), dtype=torch.float32, device=queries.device)
    l1 = torch.empty((Q, -(-n_blk // emit_l1)), dtype=torch.float32,
                     device=queries.device) if emit_l1 else None
    if Q and n_blk:
        lib = load_library()
        base, blk0 = _seg_table(segs)
        rc = lib.plain_gmax_launch(
            queries.data_ptr(), base, blk0, len(segs), gmax.data_ptr(),
            l1.data_ptr() if l1 is not None else None, Q, D, blk_lo, n_blk,
            nb_valid if nb_valid is not None else blk_lo + n_blk, emit_l1,
            torch.cuda.current_stream(queries.device).cuda_stream)
        check(rc, name)
        wrapper.launches += 1
    return (gmax, l1) if emit_l1 else gmax


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
    NB = _check_body(queries, (plain,))
    if n_blk is None:
        n_blk = NB - blk_lo
    if not (0 <= blk_lo and 0 <= n_blk and blk_lo + n_blk <= NB):
        raise ValueError(f"window [{blk_lo}, {blk_lo + n_blk}) outside "
                         f"{NB} blocks")
    if emit_l1 and GMAX_TILE_BLOCKS % emit_l1:
        raise ValueError(f"emit_l1={emit_l1} must divide {GMAX_TILE_BLOCKS}")
    if not queries.is_cuda:
        return plain_gmax_reference(queries, plain, blk_lo, n_blk, emit_l1,
                                    nb_valid)
    return _gmax_launch(fused_plain_gmax, queries, (plain,), blk_lo, n_blk,
                        emit_l1, nb_valid)


fused_plain_gmax.launches = 0


def plain_gmax_segs_reference(queries: torch.Tensor, segs, emit_l1: int = 0,
                              nb_valid: Optional[int] = None):
    """Plain PyTorch version of ``fused_plain_gmax_segs``: each segment's
    maxima written into its window of one [Q, NB] output, then the
    masking and the level-1 maxima over the whole."""
    NB = sum(s.shape[0] for s in segs) // GROUP
    gmax = torch.empty((queries.shape[0], NB), dtype=torch.float32,
                       device=queries.device)
    lo = 0
    for s in segs:
        nb = s.shape[0] // GROUP
        gmax[:, lo:lo + nb] = plain_gmax_reference(queries, s)
        lo += nb
    if nb_valid is not None:
        gmax[:, max(nb_valid, 0):] = NEG
    return (gmax, _level1(gmax, emit_l1)) if emit_l1 else gmax


def fused_plain_gmax_segs(queries: torch.Tensor, segs, emit_l1: int = 0,
                          nb_valid: Optional[int] = None):
    """``fused_plain_gmax`` over a corpus held as a tuple of segments,
    writing one shared gmax [Q, NB] (and l1) by GLOBAL block id, NB the
    segments' total; ``nb_valid`` masks global ids. Every segment but the
    last must hold a multiple of 16 blocks (``prepare_plain_corpus`` cuts
    at 256), so no kernel tile and no level-1 group spans two segments.

    CPU tensors run ``plain_gmax_segs_reference``; CUDA tensors (bf16)
    launch ``csrc/plain_gmax.cu`` once over the segment table."""
    segs = tuple(segs)
    NB = _check_body(queries, segs)
    if any((s.shape[0] // GROUP) % GMAX_TILE_BLOCKS for s in segs[:-1]):
        raise ValueError("every segment but the last must hold a multiple "
                         f"of {GMAX_TILE_BLOCKS} blocks, got "
                         f"{[s.shape[0] // GROUP for s in segs]}")
    if emit_l1 and GMAX_TILE_BLOCKS % emit_l1:
        raise ValueError(f"emit_l1={emit_l1} must divide {GMAX_TILE_BLOCKS}")
    if not queries.is_cuda:
        return plain_gmax_segs_reference(queries, segs, emit_l1, nb_valid)
    return _gmax_launch(fused_plain_gmax_segs, queries, segs, 0, NB, emit_l1,
                        nb_valid)


fused_plain_gmax_segs.launches = 0


# ---------------------------------------------------------------------------
# K3/K5/K6: gather-rescore of the selected blocks
# ---------------------------------------------------------------------------


def _gather_blocks(segs, b: torch.Tensor) -> torch.Tensor:
    """The [8, D] rows of global blocks b [q, k] (in range) -> [q, k, 8, D],
    each block read from its segment."""
    D = segs[0].shape[1]
    if len(segs) == 1:
        return segs[0].view(-1, GROUP, D)[b]
    rows = torch.empty(b.shape + (GROUP, D), dtype=segs[0].dtype,
                       device=segs[0].device)
    lo = 0
    for s in segs:
        nb = s.shape[0] // GROUP
        here = (b >= lo) & (b < lo + nb)
        rows[here] = s.view(nb, GROUP, D)[b[here] - lo]
        lo += nb
    return rows


def gather_rescore_reference(queries: torch.Tensor, plain: Body,
                             bids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gather-rescore kernels: gather the
    [8, D] rows of every selected block (from its segment), then an fp32
    einsum."""
    segs = _segments(plain)
    Q = queries.shape[0]
    NB = sum(s.shape[0] for s in segs) // GROUP
    k = bids.shape[1]
    b = bids.long().clamp(0, NB - 1)
    out = torch.empty((Q, k * GROUP), dtype=torch.float32,
                      device=queries.device)
    for lo in range(0, Q, RESCORE_Q_CHUNK):
        hi = min(lo + RESCORE_Q_CHUNK, Q)
        rows = _gather_blocks(segs, b[lo:hi]).float()  # [q, k, 8, D]
        out[lo:hi] = torch.einsum("qd,qkmd->qkm", queries[lo:hi].float(),
                                  rows).reshape(hi - lo, k * GROUP)
    return out


def gather_rescore(queries: torch.Tensor, plain: Body, bids: torch.Tensor,
                   pipeline: bool = False) -> torch.Tensor:
    """out[q, j*8 + m] = <queries[q], doc bids[q, j]*8 + m>, fp32 [Q, k*8].

    ``plain`` is the doc-major body or its tuple of segments; block ids
    are global, and ids outside [0, NB) are clamped. ``pipeline=True``
    selects the software-pipelined kernel, which takes a single buffer
    only (as in the JAX package).

    CPU tensors run ``gather_rescore_reference``; CUDA tensors (bf16
    operands, int32 ids) launch ``csrc/gather_rescore.cu`` (counted in
    ``launches``, or ``seg_launches`` over more than one segment) or
    ``csrc/gather_rescore_pipelined.cu`` (``pipelined_launches``)."""
    segs = _segments(plain)
    NB = _check_body(queries, segs)
    if bids.dim() != 2 or bids.shape[0] != queries.shape[0]:
        raise ValueError(f"shapes queries {tuple(queries.shape)}, bids "
                         f"{tuple(bids.shape)}")
    if NB == 0:
        raise ValueError("the corpus holds no block of 8 docs")
    if pipeline and len(segs) > 1:
        raise ValueError("a segmented corpus takes the drain rescore only "
                         "(pipeline=False)")
    if not queries.is_cuda:
        return gather_rescore_reference(queries, plain, bids)

    Q, D = queries.shape
    k = bids.shape[1]
    if queries.dtype != torch.bfloat16 or any(
            s.dtype != torch.bfloat16 for s in segs):
        raise ValueError("the rescore kernel takes bf16 queries and corpus, "
                         f"got {queries.dtype} and {segs[0].dtype}")
    if bids.dtype != torch.int32:
        raise ValueError(f"block ids must be int32, got {bids.dtype}")
    max_d = MAX_PIPELINED_D if pipeline else MAX_SMEM_D
    if D % 8 or D > max_d:
        raise ValueError(f"the rescore kernel needs D % 8 == 0 and "
                         f"D <= {max_d}, got D={D}")
    _check_cuda_operands("gather_rescore", queries, bids, *segs)
    out = torch.empty((Q, k * GROUP), dtype=torch.float32,
                      device=queries.device)
    if Q and k:
        lib = load_library()
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        if pipeline:
            rc = lib.gather_rescore_pipelined_launch(
                queries.data_ptr(), segs[0].data_ptr(), bids.data_ptr(),
                out.data_ptr(), Q, D, k, NB, stream)
            check(rc, "gather_rescore_pipelined")
            gather_rescore.pipelined_launches += 1
        else:
            base, blk0 = _seg_table(segs)
            rc = lib.gather_rescore_launch(
                queries.data_ptr(), base, blk0, len(segs), bids.data_ptr(),
                out.data_ptr(), Q, D, k, stream)
            check(rc, "gather_rescore")
            if len(segs) > 1:
                gather_rescore.seg_launches += 1
            else:
                gather_rescore.launches += 1
    return out


gather_rescore.launches = 0
gather_rescore.seg_launches = 0
gather_rescore.pipelined_launches = 0


# ---------------------------------------------------------------------------
# The search pipeline
# ---------------------------------------------------------------------------


def _select_blocks(queries: torch.Tensor, plain: Body, k: int,
                   nb_valid: Optional[int], blk_lo: int,
                   n_blk: int) -> torch.Tensor:
    """gmax kernel over the window [blk_lo, blk_lo + n_blk) (a segmented
    body: over all of it) -> pyramid selection -> global block ids [Q, k]."""
    emit_l1 = FANOUT if pyramid_fanouts(n_blk, k) else 0
    if isinstance(plain, tuple):
        out = fused_plain_gmax_segs(queries, plain, emit_l1=emit_l1,
                                    nb_valid=nb_valid)
    else:
        out = fused_plain_gmax(queries, plain, blk_lo, n_blk,
                               emit_l1=emit_l1, nb_valid=nb_valid)
    if emit_l1:  # the gmax kernel emits pyramid level 1 from the score tile
        gmax, l1 = out
        return _select_groups(gmax, k, l1=l1) + blk_lo
    return _select_groups(out, k) + blk_lo


def _plain_topk_core(queries: torch.Tensor, plain: Body,
                     tail_rows: torch.Tensor, n_docs: int, k: int,
                     pipeline: bool = False,
                     c_split: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """gmax kernel -> pyramid selection -> gather-rescore -> tail -> top-k.

    ``plain`` holds at least the first ``n_docs // 8 * 8`` docs; rows past
    them (zero padding from a caller) are masked out of selection and their
    candidates scored finfo(float32).min, so a pad row scoring 0 can never
    displace a real doc that scores below 0.

    ``plain`` may be a tuple of segments: one global selection over the
    shared gmax, then a segment-routed rescore. ``c_split`` > 1 (single
    buffer only) runs gmax -> selection -> rescore over that many
    sequential windows of 256-block tiles and merges the candidates: exact,
    since a global top-k doc is top-k within its window, and the [Q, NB]
    gmax shrinks to one window's. Windows too small to select k blocks
    from fall back to one window, as in the JAX package."""
    if isinstance(plain, tuple) and c_split > 1:
        raise ValueError("a segmented corpus does one global selection; "
                         "c_split needs a single-buffer corpus")
    Q = queries.shape[0]
    NB = n_docs // GROUP
    NBp = sum(s.shape[0] for s in _segments(plain)) // GROUP
    nb_valid = NB if NBp > NB else None
    total_tiles = -(-NBp // SEG_TILE_BLOCKS)
    if c_split > 1 and (total_tiles < c_split or (NBp // c_split) // 2 <= k):
        c_split = 1
    cands, ids = [], []
    blk_lo = 0
    for nt in split_tiles(total_tiles, c_split):
        n_blk = min(nt * SEG_TILE_BLOCKS, NBp - blk_lo)
        bid = _select_blocks(queries, plain, min(k, n_blk), nb_valid, blk_lo,
                             n_blk)
        cands.append(gather_rescore(queries, plain, bid.to(torch.int32),
                                    pipeline=pipeline))
        ids.append((bid[:, :, None] * GROUP
                    + torch.arange(GROUP, device=bid.device)).reshape(Q, -1))
        blk_lo += n_blk
    cand, ids = torch.cat(cands, dim=1), torch.cat(ids, dim=1)
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
                        k: int = 1000, pipeline: bool = False,
                        c_split: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a ``prepare_plain_corpus`` layout.

    Returns (scores [Q, min(k, N)] fp32 descending, doc indices int64).
    ``pipeline`` selects the pipelined rescore kernel, ``c_split`` the
    sequential corpus windows (see ``_plain_topk_core``). A corpus with
    ``NB // 2 <= k`` blocks is searched by ``exact_search``: the pyramid
    would select every block and repeat ids to fill k."""
    k = min(k, prep.n_docs)
    NB = prep.n_docs // GROUP
    if NB // 2 <= k:
        body = torch.cat(prep.plain) if isinstance(prep.plain, tuple) \
            else prep.plain
        corpus = torch.cat([body[:NB * GROUP], prep.tail]) \
            if prep.tail.shape[0] else body[:NB * GROUP]
        return exact_search(queries, corpus, k=k)
    return _plain_topk_core(queries, prep.plain, prep.tail, prep.n_docs, k,
                            pipeline, c_split)
