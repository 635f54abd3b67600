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

Also here, the alternative exact-search layouts of ``pallas_mips.py``,
as library functions with the JAX package's contracts (no ``Searcher``
method reaches them there either):

- the block-row layout (``prepare_block_corpus``, ``block_topk``,
  ``block_topk_prepared``): block maxima from ``cb`` [NB, 8 * D]
  (``fused_block_gmax``, K7), pyramid selection, then the selected block
  rows rescored by framework ops (``rescore="xla"``) or by the
  gather-rescore kernel (``rescore="dma"``, K3);
- the score-materializing path (``block_score_topk_prepared``): K7 for
  selection plus every score stored doc-major (``fused_scores``, K8),
  the candidates read back as 8-score slices;
- the strided hier2 paths (``hier2_search``, ``hier2_rescore``): group
  maxima over strided groups of each ``tile`` of rows, with the scores
  (``fused_score_gmax``, K9) or without them (``fused_gmax_only``, K10,
  the candidates then rescored from their corpus rows).

K8 is ``csrc/scores.cu``, K9 and K10 ``csrc/score_tiles.cu``; K7 is
``csrc/plain_gmax.cu`` behind its own entry point, since on the card ``cb``
and the doc-major body are the same bytes. K1/K2/K4/K7, K8 and K11 run on
the Hopper mainloop of ``csrc/score_tile_sm90.cuh`` (TMA loads, ``wgmma``,
persistent blocks); K9 and K10 on the older ``csrc/score_tile.cuh``.

And the phase-ablation kernel of the perf scripts (``fused_gmax_phase``,
K11, ``csrc/gmax_phases.cu``): K2's block maxima with one of four
epilogues, so ``perf/score_path_phases.py`` can time each epilogue's share.

Each kernel wrapper dispatches on where its tensors lie: a CPU tensor
goes to the plain PyTorch version beside it, a CUDA tensor launches the
kernel or raises; nothing falls back from one to the other. Each launch
is counted in ``_build.launches`` under its kernel-table name.
"""

from __future__ import annotations

import ctypes
import logging
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ._build import check, load_library
from .mips import (FANOUT, NEG, _hier_topk, _select_groups, exact_search,
                   gather_row_slices, pyramid_fanouts)

logger = logging.getLogger(__name__)

GROUP = 8
MAX_PIPELINED_D = 6144  # the deepest D the pipelined rescore is held to on
# the card (csrc/gather_rescore_pipelined.cu takes the depth in 768 pieces)
GMAX_CHUNK_BLOCKS = 8192  # plain gmax: fp32 staging of 64k corpus rows
RESCORE_Q_CHUNK = 16  # plain rescore: [16, k, 8, D] fp32 rows at a time
DEDUP_Q_CHUNK = 64  # gather_rescore.cu: one bit of a uint64 mask per query
SEG_TILE_BLOCKS = 256  # segments and c_split windows cut at JAX's tile_g
GMAX_TILE_BLOCKS = 16  # blocks of one plain_gmax.cu tile
MAX_SEGS = 64  # csrc/segments.cuh: the by-value segment table's capacity
HIER2_Q_CHUNK = 32  # hier2_rescore: [32, k * 8, D] candidate rows at a time

Body = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class BlockCorpus(NamedTuple):
    """The prepared doc-major layout: one corpus copy serves every kernel.
    ``cb`` is set by ``prepare_block_corpus`` only: the same rows viewed as
    block rows."""

    tail: torch.Tensor  # [N % 8, D] the ragged tail docs
    n_docs: int         # true N
    plain: Optional[Body]  # [NB * 8, D] the first NB * 8 docs, its segments,
    # or None (prepare_block_corpus with_plain=False)
    cb: Optional[torch.Tensor] = None  # [NB, 8 * D] block rows


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


def prepare_plain_corpus(corpus: torch.Tensor, n_segs: int = 1,
                         device=None) -> BlockCorpus:
    """Split [N, D] into the 8-doc-block body and the ragged tail.

    With ``n_segs`` = 1 both are views of ``corpus``: nothing is copied or
    padded. With ``n_segs`` > 1 the body becomes a tuple of segments cut
    where the JAX package cuts them (``split_tiles`` over ceil(NB / 256)
    tiles of 256 blocks, so at most one segment per tile); the last
    segment holds the remainder unpadded. A count still above
    ``MAX_SEGS`` (the kernels' segment table) is cut to ``MAX_SEGS`` with
    a warning: the search is exact at any cut, so the answers do not
    change. Every segment and the tail are copies, each its own
    allocation, so the caller's ``corpus`` can be freed.

    ``device`` (default: the corpus's) holds the layout; from another
    device (a host corpus) each part is copied over on its own, so no
    second whole copy is made on either side."""
    if corpus.dim() != 2:
        raise ValueError(f"corpus must be [N, D], got {tuple(corpus.shape)}")
    if n_segs < 1:
        raise ValueError(f"n_segs={n_segs} must be >= 1")
    N = corpus.shape[0]
    NB = N // GROUP
    tiles = -(-NB // SEG_TILE_BLOCKS)
    if min(n_segs, tiles) > MAX_SEGS:
        logger.warning("n_segs=%d: holding the index as %d segments, the "
                       "most the kernels' segment table takes", n_segs,
                       MAX_SEGS)
        n_segs = MAX_SEGS
    device = corpus.device if device is None else torch.device(device)

    def copy(t):
        return t.clone() if t.device == device else t.to(device)

    body, tail = corpus[:NB * GROUP], corpus[NB * GROUP:]
    if n_segs == 1:
        if corpus.device != device:
            body, tail = body.to(device), tail.to(device)
        return BlockCorpus(tail=tail, n_docs=N, plain=body)
    segs, lo = [], 0
    for nt in split_tiles(tiles, n_segs):
        hi = min(lo + nt * SEG_TILE_BLOCKS, NB)
        segs.append(copy(body[lo * GROUP:hi * GROUP]))
        lo = hi
    return BlockCorpus(tail=copy(tail), n_docs=N, plain=tuple(segs))


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


def _gmax_launch(name: str, queries: torch.Tensor, segs, blk_lo: int,
                 n_blk: int, emit_l1: int, nb_valid: Optional[int]):
    """Launch ``csrc/plain_gmax.cu`` over the window [blk_lo, blk_lo +
    n_blk) of the segments' global blocks, counted under ``name``;
    returns gmax or (gmax, l1)."""
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
    return _gmax_launch("plain_gmax", queries, (plain,), blk_lo, n_blk,
                        emit_l1, nb_valid)


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
    return _gmax_launch("plain_gmax_segs", queries, segs, 0, NB, emit_l1,
                        nb_valid)


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


def gather_rescore_dedup_reference(queries: torch.Tensor, plain: Body,
                                   bids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/gather_rescore.cu``'s three stages,
    64 queries at a time: claim the distinct selected blocks
    (``torch.unique``, each (query, slot) pair's block by its inverse),
    score each distinct block once against every query of the chunk, then
    scatter each pair's 8 scores to its place. The same function as
    ``gather_rescore_reference``; the tests hold the index logic of the
    CUDA stages with it."""
    segs = _segments(plain)
    Q = queries.shape[0]
    NB = sum(s.shape[0] for s in segs) // GROUP
    k = bids.shape[1]
    b = bids.long().clamp(0, NB - 1)
    out = torch.empty((Q, k * GROUP), dtype=torch.float32,
                      device=queries.device)
    for lo in range(0, Q, DEDUP_Q_CHUNK):
        hi = min(lo + DEDUP_Q_CHUNK, Q)
        ulist, slot = torch.unique(b[lo:hi], return_inverse=True)
        rows = _gather_blocks(segs, ulist[None])[0].float()  # [U, 8, D]
        scores = torch.einsum("qd,umd->uqm", queries[lo:hi].float(), rows)
        mine = torch.arange(hi - lo, device=queries.device)[:, None]
        out[lo:hi] = scores[slot, mine].reshape(hi - lo, k * GROUP)
    return out


def _dedup_scratch(nb: int, q_chunk: int, k: int, device):
    """One allocation for the rescore kernels' scratch
    (``csrc/gather_rescore.cu`` and ``gather_rescore_pipelined.cu``): each
    block's uint64 query mask plus the distinct-block count ((NB + 1) * 8
    bytes), each block's slot (int32 [NB]), and for the U = min(NB,
    q_chunk * k) distinct blocks a chunk can name, their ids (int32 [U])
    and scores (fp32 [U, 64, 8], written only where a query selected the
    block). Returns the buffer and the four pointers."""
    slots = min(nb, q_chunk * k)
    sizes = (8 * (nb + 1), 4 * nb, 4 * slots,
             4 * slots * DEDUP_Q_CHUNK * GROUP)
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total)
        total += -(-size // 256) * 256
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    return buf, tuple(buf.data_ptr() + o for o in offsets)


def _rescore_scratch(Q: int, nb: int, k: int, device):
    """The scratch of one rescore call of Q queries: both kernels work in
    rounds of at most 64 queries and reuse it from round to round, so it
    is sized for one round (``_dedup_scratch``)."""
    return _dedup_scratch(nb, min(Q, DEDUP_Q_CHUNK), k, device)


def _check_rescore_operands(queries: torch.Tensor, segs: tuple,
                            bids: torch.Tensor, pipeline: bool):
    """What the rescore kernels take: bf16 queries and corpus, int32 ids,
    D % 8 == 0 (and D <= MAX_PIPELINED_D with ``pipeline``), one device,
    dense and 16-byte aligned."""
    D = queries.shape[1]
    if queries.dtype != torch.bfloat16 or any(
            s.dtype != torch.bfloat16 for s in segs):
        raise ValueError("the rescore kernel takes bf16 queries and corpus, "
                         f"got {queries.dtype} and {segs[0].dtype}")
    if bids.dtype != torch.int32:
        raise ValueError(f"block ids must be int32, got {bids.dtype}")
    if D % 8 or (pipeline and D > MAX_PIPELINED_D):
        raise ValueError(f"the rescore kernel needs D % 8 == 0 (and D <= "
                         f"{MAX_PIPELINED_D} with pipeline=True), got D={D}")
    _check_cuda_operands("gather_rescore", queries, bids, *segs)


def gather_rescore(queries: torch.Tensor, plain: Body, bids: torch.Tensor,
                   pipeline: bool = False) -> torch.Tensor:
    """out[q, j*8 + m] = <queries[q], doc bids[q, j]*8 + m>, fp32 [Q, k*8].

    ``plain`` is the doc-major body or its tuple of segments; block ids
    are global, and ids outside [0, NB) are clamped. ``pipeline=True``
    selects the pipelined kernel, which takes a single buffer only (as in
    the JAX package).

    CPU tensors run ``gather_rescore_reference``; CUDA tensors (bf16
    operands, int32 ids) launch ``csrc/gather_rescore.cu`` (counted as
    ``gather_rescore``, or ``gather_rescore_seg`` over more than one
    segment: a memset and four kernels per 64 queries) or
    ``csrc/gather_rescore_pipelined.cu`` (``gather_rescore_pipelined``: one
    cooperative kernel per call). Both read
    each distinct selected block once per 64 queries, with scratch from
    the caching allocator (``_rescore_scratch``)."""
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
    _check_rescore_operands(queries, segs, bids, pipeline)
    out = torch.empty((Q, k * GROUP), dtype=torch.float32,
                      device=queries.device)
    if Q and k:
        lib = load_library()
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        # freed on return: the caching allocator gives the block out again
        # only to work queued after this launch on this stream
        _scratch, (mask, slot, ulist, scores) = _rescore_scratch(
            Q, NB, k, queries.device)
        if pipeline:
            rc = lib.gather_rescore_pipelined_launch(
                queries.data_ptr(), segs[0].data_ptr(), bids.data_ptr(),
                out.data_ptr(), mask, slot, ulist, scores, Q, D, k, NB,
                stream)
            check(rc, "gather_rescore_pipelined")
        else:
            base, blk0 = _seg_table(segs)
            rc = lib.gather_rescore_launch(
                queries.data_ptr(), base, blk0, len(segs), bids.data_ptr(),
                out.data_ptr(), mask, slot, ulist, scores, Q, D, k, stream)
            check(rc, "gather_rescore_seg" if len(segs) > 1
                  else "gather_rescore")
    return out


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


# ---------------------------------------------------------------------------
# A shard's search: a tile-aligned corpus with a per-shard valid-row count
# ---------------------------------------------------------------------------


def pad_plain(corpus: torch.Tensor, tile_g: int = SEG_TILE_BLOCKS,
              device=None) -> torch.Tensor:
    """[N, D] rows zero-padded up to a multiple of ``tile_g`` blocks (the
    JAX package's ``pad_plain``): the operand of ``plain_topk_valid``, on
    ``device`` (default: the corpus's). The ragged tail stays in the
    array, so it is one buffer that a mesh Searcher replicates as it is.
    The rows are copied once, straight into the padded buffer; aligned
    rows already on ``device`` are returned as they are."""
    device = corpus.device if device is None else torch.device(device)
    N = corpus.shape[0]
    rows = N + (-N) % (tile_g * GROUP)
    if rows == N and corpus.device == device:
        return corpus
    out = torch.zeros((rows, corpus.shape[1]), dtype=corpus.dtype,
                      device=device)
    out[:N].copy_(corpus)
    return out


def plain_topk_valid_reference(queries: torch.Tensor, plain: torch.Tensor,
                               valid: int, k: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``plain_topk_valid``: an exact top-k over
    the first ``valid`` rows, -inf past them."""
    return exact_search(queries, plain, k=min(k, plain.shape[0]),
                        valid_rows=valid)


def plain_topk_valid(queries: torch.Tensor, plain: torch.Tensor, valid: int,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a tile-aligned corpus whose first ``valid`` rows are
    real and whose others are zero padding (JAX ``plain_topk_valid``): the
    body of a mesh Searcher's rank, whose valid count differs per shard.

    ``_plain_topk_core`` over the first ``valid`` rows: the gmax kernel
    (K1) masks every block from the partial one on out of selection, the
    rescore kernel (K3) scores the selected blocks, and the partial block's
    real rows are scored densely as the ragged tail. So a zero pad row can
    never displace a real doc with a negative score. Slots that no valid
    row fills (a shard with fewer than k valid rows, or none) score -inf,
    where JAX leaves finfo.min: a selected partial block's masked ids
    repeat the tail's, and must read as empty slots. A corpus with
    ``NB // 2 <= k`` blocks is scanned exactly instead.

    queries [Q, D]; plain [Np, D], Np a multiple of 256 blocks. Returns
    (scores [Q, min(k, Np)] fp32 descending, shard-local ids int64)."""
    Np = plain.shape[0]
    if Np % (SEG_TILE_BLOCKS * GROUP):
        raise ValueError(f"corpus rows {Np} are not a multiple of "
                         f"{SEG_TILE_BLOCKS * GROUP} (pad_plain)")
    if not 0 <= valid <= Np:
        raise ValueError(f"valid={valid} outside [0, {Np}]")
    k = min(k, Np)
    if Np // GROUP // 2 <= k:
        return plain_topk_valid_reference(queries, plain, valid, k)
    s, i = _plain_topk_core(queries, plain,
                            plain[valid // GROUP * GROUP:valid], valid, k)
    return s.masked_fill(s == NEG, float("-inf")), i


# ---------------------------------------------------------------------------
# The alternative layouts: shared checks
# ---------------------------------------------------------------------------


def _check_matrices(name: str, queries: torch.Tensor, corpus, width: int):
    """queries [Q, D] and a 2-D corpus tensor ``width`` wide."""
    if not isinstance(corpus, torch.Tensor) or queries.dim() != 2 \
            or corpus.dim() != 2 or corpus.shape[1] != width:
        shape = tuple(corpus.shape) if isinstance(corpus, torch.Tensor) \
            else type(corpus).__name__
        raise ValueError(f"{name}: queries {tuple(queries.shape)} and corpus "
                         f"{shape} must be [Q, D] and one [rows, {width}] "
                         "tensor")


def _check_kernel_operands(name: str, queries: torch.Tensor,
                           corpus: torch.Tensor):
    """What the CUDA kernels take: bf16, D % 8 == 0, one device, dense and
    16-byte aligned."""
    if queries.dtype != torch.bfloat16 or corpus.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16 queries and corpus, got "
                         f"{queries.dtype} and {corpus.dtype}")
    if queries.shape[1] % 8:
        raise ValueError(f"{name} needs D % 8 == 0, got D={queries.shape[1]}")
    _check_cuda_operands(name, queries, corpus)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _chunk_scores(queries: torch.Tensor, corpus: torch.Tensor, lo: int,
                  hi: int) -> torch.Tensor:
    """fp32 scores of corpus rows [lo, hi): the plain versions' product."""
    return queries.float() @ corpus[lo:hi].float().T


def _padded_scores(queries: torch.Tensor, corpus: torch.Tensor, lo: int,
                   width: int) -> torch.Tensor:
    """fp32 scores of corpus rows [lo, lo + width), a chunk of rows at a
    time; rows >= N score finfo(float32).min."""
    hi = min(lo + width, corpus.shape[0])
    out = torch.full((queries.shape[0], width), NEG, dtype=torch.float32,
                     device=queries.device)
    step = GMAX_CHUNK_BLOCKS * GROUP
    for a in range(lo, hi, step):
        b = min(a + step, hi)
        out[:, a - lo:b - lo] = _chunk_scores(queries, corpus, a, b)
    return out


# ---------------------------------------------------------------------------
# The block-row layout: K7, then the block paths
# ---------------------------------------------------------------------------


def prepare_block_corpus(corpus: torch.Tensor,
                         with_plain: Optional[bool] = None) -> BlockCorpus:
    """The block-row layout of [N, D]: ``cb`` [NB, 8 * D] holds the first
    NB * 8 docs (block b = docs 8b .. 8b + 7), ``tail`` the ragged N % 8.

    The block-row and the doc-major layout are the same bytes of a
    row-major tensor, so ``cb`` and ``plain`` are views of ``corpus``: no
    tile padding and no second copy, where the JAX package pads ``cb`` to
    its tile and keeps ``plain`` as a second copy. ``with_plain`` keeps
    JAX's rule all the same (by default ``plain`` is kept iff
    N * D * 2 <= 4 GiB), so ``plain`` is None, and the paths that need it
    refuse, in the same cases."""
    if corpus.dim() != 2:
        raise ValueError(f"corpus must be [N, D], got {tuple(corpus.shape)}")
    if not corpus.is_contiguous():
        raise ValueError("prepare_block_corpus takes a contiguous corpus: "
                         "its block rows are a view, never a copy")
    N, D = corpus.shape
    NB = N // GROUP
    body = corpus[:NB * GROUP]
    if with_plain is None:
        with_plain = N * D * 2 <= 4 * 2**30
    return BlockCorpus(tail=corpus[NB * GROUP:], n_docs=N,
                       plain=body if with_plain else None,
                       cb=body.view(NB, GROUP * D))


def block_gmax_reference(queries: torch.Tensor,
                         cb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``fused_block_gmax``, the TPU kernel's way:
    the maximum of the 8 slab products q @ cb[:, m*D:(m+1)*D].T in fp32,
    chunked over blocks."""
    Q, D = queries.shape
    NB = cb.shape[0]
    q = queries.float()
    gmax = torch.empty((Q, NB), dtype=torch.float32, device=queries.device)
    for lo in range(0, NB, GMAX_CHUNK_BLOCKS):
        rows = cb[lo:lo + GMAX_CHUNK_BLOCKS]
        g = q @ rows[:, :D].float().T
        for m in range(1, GROUP):
            g = torch.maximum(g, q @ rows[:, m * D:(m + 1) * D].float().T)
        gmax[:, lo:lo + rows.shape[0]] = g
    return gmax


def fused_block_gmax(queries: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Per-block score maxima [Q, NB] fp32 from block rows cb [NB, 8 * D].

    CPU tensors run ``block_gmax_reference``; CUDA tensors (bf16) launch
    ``csrc/plain_gmax.cu`` through ``block_gmax_launch``, over cb read as
    the [NB * 8, D] doc-major rows it is."""
    _check_matrices("fused_block_gmax", queries, cb,
                    GROUP * queries.shape[-1])
    if not queries.is_cuda:
        return block_gmax_reference(queries, cb)
    Q, D = queries.shape
    NB = cb.shape[0]
    _check_kernel_operands("fused_block_gmax", queries, cb)
    gmax = torch.empty((Q, NB), dtype=torch.float32, device=queries.device)
    if Q and NB:
        rc = load_library().block_gmax_launch(
            queries.data_ptr(), cb.data_ptr(), gmax.data_ptr(), Q, D, NB,
            _stream(queries))
        check(rc, "block_gmax")
    return gmax



def _block_ids(bid: torch.Tensor) -> torch.Tensor:
    """Doc ids [Q, k * 8] of the members of blocks bid [Q, k]."""
    return (bid[:, :, None] * GROUP
            + torch.arange(GROUP, device=bid.device)).reshape(bid.shape[0],
                                                              -1)


def _with_tail(cand: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
               tail_rows: torch.Tensor, first_id: int):
    """Append the dense scores and ids of the ragged tail docs."""
    n = tail_rows.shape[0]
    if not n:
        return cand, ids
    tail_ids = first_id + torch.arange(n, device=ids.device)
    return (torch.cat([cand, _chunk_scores(queries, tail_rows, 0, n)], 1),
            torch.cat([ids, tail_ids.expand(ids.shape[0], n)], 1))


def _block_topk_core(queries: torch.Tensor, cb: torch.Tensor,
                     tail_rows: torch.Tensor, n_docs: int, k: int,
                     qb: int = 0, rescore: str = "xla",
                     plain: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score-free block path: K7 block maxima -> pyramid selection -> the
    k selected blocks rescored exactly -> the ragged tail -> top-k.

    ``rescore="xla"`` gathers the selected [8 * D] block rows of ``cb``
    and takes an fp32 product, ``qb`` queries at a time (default 16; the
    answers do not depend on it); ``rescore="dma"`` runs the gather-rescore
    kernel over ``plain``."""
    if rescore not in ("xla", "dma"):
        raise ValueError(f"rescore must be 'xla' or 'dma', got {rescore!r}")
    Q, D = queries.shape
    NB = n_docs // GROUP
    bid = _select_groups(fused_block_gmax(queries, cb[:NB]), k)
    if rescore == "dma":
        if plain is None:
            raise ValueError("rescore='dma' needs the plain doc-major "
                             "corpus (prepare with with_plain=True)")
        cand = gather_rescore(queries, plain, bid.to(torch.int32))
        cand, ids = _with_tail(cand, _block_ids(bid), queries, tail_rows,
                               NB * GROUP)
        s, pos = torch.topk(cand, k, dim=1)
        return s, torch.gather(ids, 1, pos)

    qb = qb if qb > 0 else RESCORE_Q_CHUNK
    s_out = torch.empty((Q, k), dtype=torch.float32, device=queries.device)
    i_out = torch.empty((Q, k), dtype=torch.int64, device=queries.device)
    for lo in range(0, Q, qb):
        hi = min(lo + qb, Q)
        b = bid[lo:hi]
        # [qb * k, 8 * D] contiguous block rows, viewed as [qb, k * 8, D]
        rows = cb[b.reshape(-1)].view(hi - lo, k * GROUP, D)
        sc = torch.bmm(rows.float(),
                       queries[lo:hi].float()[:, :, None])[:, :, 0]
        sc, ids = _with_tail(sc, _block_ids(b), queries[lo:hi], tail_rows,
                             NB * GROUP)
        s_out[lo:hi], pos = torch.topk(sc, k, dim=1)
        i_out[lo:hi] = torch.gather(ids, 1, pos)
    return s_out, i_out


def _need_cb(prep: BlockCorpus):
    if prep.cb is None:
        raise ValueError("the block paths need the block-row layout of "
                         "prepare_block_corpus (cb is None)")


def block_topk_prepared(queries: torch.Tensor, prep: BlockCorpus,
                        k: int = 1000, qb: int = 0, rescore: str = "xla"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a ``prepare_block_corpus`` layout, score-free.

    Returns (scores [Q, min(k, N)] fp32 descending, doc indices int64).
    ``rescore="dma"`` rescores with the gather-rescore kernel and needs
    ``prep.plain``. A corpus with ``NB // 2 <= k`` blocks is searched by
    ``exact_search``."""
    _need_cb(prep)
    k = min(k, prep.n_docs)
    NB = prep.n_docs // GROUP
    if NB // 2 <= k:
        body = prep.cb[:NB].reshape(-1, queries.shape[1])
        corpus = torch.cat([body, prep.tail]) if prep.tail.shape[0] else body
        return exact_search(queries, corpus, k=k)
    return _block_topk_core(queries, prep.cb, prep.tail, prep.n_docs, k, qb,
                            rescore, prep.plain)


def block_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int = 1000,
               qb: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of [N, D] through the block-row layout, score-free: K7
    block maxima, pyramid selection of the top-k blocks, their rows
    rescored in fp32, the ragged N % 8 tail scored densely. The layout is
    a view of ``corpus`` (contiguous), so nothing is copied per call."""
    N = corpus.shape[0]
    k = min(k, N)
    if (N // GROUP) // 2 <= k:
        return exact_search(queries, corpus, k=k)
    prep = prepare_block_corpus(corpus, with_plain=False)
    return _block_topk_core(queries, prep.cb, prep.tail, N, k, qb)


# ---------------------------------------------------------------------------
# The score-materializing block path: K8
# ---------------------------------------------------------------------------


def scores_reference(queries: torch.Tensor,
                     plain: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``fused_scores``: fp32 products chunked
    over the corpus."""
    return _padded_scores(queries, plain, 0, plain.shape[0])


def fused_scores(queries: torch.Tensor, plain: torch.Tensor) -> torch.Tensor:
    """Every score, doc-major: [Q, N] fp32 for plain [N, D].

    CPU tensors run ``scores_reference``; CUDA tensors (bf16) launch
    ``csrc/scores.cu`` (``scores_launch``)."""
    _check_matrices("fused_scores", queries, plain, queries.shape[-1])
    if not queries.is_cuda:
        return scores_reference(queries, plain)
    Q, D = queries.shape
    N = plain.shape[0]
    _check_kernel_operands("fused_scores", queries, plain)
    out = torch.empty((Q, N), dtype=torch.float32, device=queries.device)
    if Q and N:
        rc = load_library().scores_launch(
            queries.data_ptr(), plain.data_ptr(), out.data_ptr(), Q, D, N,
            _stream(queries))
        check(rc, "scores")
    return out



def _block_score_topk_core(queries: torch.Tensor, cb: torch.Tensor,
                           plain: torch.Tensor, tail_rows: torch.Tensor,
                           n_docs: int, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score-materializing block path: K7 block maxima for the selection,
    K8 every score doc-major, so a selected block's 8 scores are one
    contiguous slice of its query's row; then the tail and top-k."""
    Q = queries.shape[0]
    NB = n_docs // GROUP
    bid = _select_groups(fused_block_gmax(queries, cb[:NB]), k)
    scores = fused_scores(queries, plain)  # [Q, NB * 8]
    cand = gather_row_slices(scores, bid * GROUP, GROUP).reshape(Q, -1)
    cand, ids = _with_tail(cand, _block_ids(bid), queries, tail_rows,
                           NB * GROUP)
    s, pos = torch.topk(cand, k, dim=1)
    return s, torch.gather(ids, 1, pos)


def block_score_topk_prepared(queries: torch.Tensor, prep: BlockCorpus,
                              k: int = 1000
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a ``prepare_block_corpus`` layout through the
    stored [Q, NB * 8] fp32 score matrix. Needs ``prep.plain``; a corpus
    with ``NB // 2 <= k`` blocks goes to ``block_topk_prepared``."""
    _need_cb(prep)
    k = min(k, prep.n_docs)
    if prep.plain is None:
        raise ValueError("BlockCorpus was prepared without the plain "
                         "doc-major copy (with_plain=False)")
    if (prep.n_docs // GROUP) // 2 <= k:
        return block_topk_prepared(queries, prep, k)
    return _block_score_topk_core(queries, prep.cb, prep.plain, prep.tail,
                                  prep.n_docs, k)


# ---------------------------------------------------------------------------
# The strided hier2 paths: K9 and K10
# ---------------------------------------------------------------------------


def _check_tile(tile: int):
    if tile <= 0 or tile % (GROUP * 128):
        raise ValueError(f"tile must be a positive multiple of "
                         f"{GROUP * 128}, got {tile}")


def _slab_gmax(scores: torch.Tensor, tile: Optional[int] = None
               ) -> torch.Tensor:
    """Strided group maxima of whole tiles of scores [Q, n * tile]: group
    t * gw + w is the max over m < 8 of column t * tile + m * gw + w,
    gw = tile / 8. ``tile`` None takes the width as one tile."""
    Q, W = scores.shape
    tile = W if tile is None else tile
    slabs = scores.reshape(Q, W // tile, GROUP, tile // GROUP)
    return slabs.amax(2).reshape(Q, W // GROUP)


def score_gmax_reference(queries: torch.Tensor, corpus: torch.Tensor,
                         tile: int = 2048
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``fused_score_gmax``: the masked scores
    [Q, Np], then their strided group maxima."""
    Np = -(-corpus.shape[0] // tile) * tile
    scores = _padded_scores(queries, corpus, 0, Np)
    return scores, _slab_gmax(scores, tile)


def fused_score_gmax(queries: torch.Tensor, corpus: torch.Tensor,
                     tile: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, Np], gmax [Q, Np / 8]) fp32 with strided groups per
    ``tile`` of rows, Np = ceil(N / tile) * tile: group t * gw + w
    (gw = tile / 8) holds docs t * tile + m * gw + w, m < 8. Rows >= N
    score finfo(float32).min in both outputs, so any N is taken; when
    N % tile == 0 this is the JAX package's ``fused_score_gmax``.

    CPU tensors run ``score_gmax_reference``; CUDA tensors (bf16) launch
    ``csrc/score_tiles.cu`` (``score_gmax_launch``)."""
    _check_tile(tile)
    _check_matrices("fused_score_gmax", queries, corpus, queries.shape[-1])
    if not queries.is_cuda:
        return score_gmax_reference(queries, corpus, tile)
    Q, D = queries.shape
    N = corpus.shape[0]
    _check_kernel_operands("fused_score_gmax", queries, corpus)
    Np = -(-N // tile) * tile
    scores = torch.empty((Q, Np), dtype=torch.float32, device=queries.device)
    gmax = torch.empty((Q, Np // GROUP), dtype=torch.float32,
                       device=queries.device)
    if Q and N:
        rc = load_library().score_gmax_launch(
            queries.data_ptr(), corpus.data_ptr(), scores.data_ptr(),
            gmax.data_ptr(), Q, D, N, tile, _stream(queries))
        check(rc, "score_gmax")
    return scores, gmax



def gmax_only_reference(queries: torch.Tensor, corpus: torch.Tensor,
                        tile: int = 2048) -> torch.Tensor:
    """Plain PyTorch version of ``fused_gmax_only``: ``score_gmax_
    reference``'s gmax, a few tiles of scores at a time."""
    n_tiles = -(-corpus.shape[0] // tile)
    per = max(1, GMAX_CHUNK_BLOCKS * GROUP // tile)
    gw = tile // GROUP
    gmax = torch.empty((queries.shape[0], n_tiles * gw), dtype=torch.float32,
                       device=queries.device)
    for t in range(0, n_tiles, per):
        nt = min(per, n_tiles - t)
        gmax[:, t * gw:(t + nt) * gw] = _slab_gmax(
            _padded_scores(queries, corpus, t * tile, nt * tile), tile)
    return gmax


def fused_gmax_only(queries: torch.Tensor, corpus: torch.Tensor,
                    tile: int = 2048) -> torch.Tensor:
    """``fused_score_gmax``'s gmax [Q, Np / 8] alone: the scores never
    leave the kernel.

    CPU tensors run ``gmax_only_reference``; CUDA tensors (bf16) launch
    ``csrc/score_tiles.cu`` (``gmax_only_launch``)."""
    _check_tile(tile)
    _check_matrices("fused_gmax_only", queries, corpus, queries.shape[-1])
    if not queries.is_cuda:
        return gmax_only_reference(queries, corpus, tile)
    Q, D = queries.shape
    N = corpus.shape[0]
    _check_kernel_operands("fused_gmax_only", queries, corpus)
    gmax = torch.empty((Q, -(-N // tile) * tile // GROUP),
                       dtype=torch.float32, device=queries.device)
    if Q and N:
        rc = load_library().gmax_only_launch(
            queries.data_ptr(), corpus.data_ptr(), gmax.data_ptr(), Q, D, N,
            tile, _stream(queries))
        check(rc, "gmax_only")
    return gmax



def _strided_members(gi: torch.Tensor, tile: int) -> torch.Tensor:
    """Doc ids [Q, k * 8] of the members of strided groups gi [Q, k]."""
    gw = tile // GROUP
    base = gi // gw * tile + gi % gw
    return (base[:, :, None] + torch.arange(GROUP, device=gi.device) * gw
            ).reshape(gi.shape[0], -1)


def hier2_search(queries: torch.Tensor, corpus: torch.Tensor, k: int = 1000,
                 tile: int = 2048, fanout: int = FANOUT
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k: K9 scores and strided group maxima, max-pyramid
    selection of k groups, then the top-k of their 8 k stored scores.

    ``tile`` defines the strided groups (so which doc ids form a group);
    ``fanout`` the pyramid. Returns (scores [Q, min(k, N)] fp32
    descending, doc indices int64). Small corpora (n_groups // 8 <= k)
    take ``_hier_topk`` over the stored scores."""
    _check_tile(tile)
    k = min(k, corpus.shape[0])
    scores, gmax = fused_score_gmax(queries, corpus, tile)
    n_groups = gmax.shape[1]
    if n_groups // 8 <= k or n_groups % 8:
        return _hier_topk(scores, k)
    cand_idx = _strided_members(_select_groups(gmax, k, fanout), tile)
    s, pos = torch.topk(torch.gather(scores, 1, cand_idx), k, dim=1)
    return s, torch.gather(cand_idx, 1, pos)


def hier2_rescore(queries: torch.Tensor, corpus: torch.Tensor, k: int = 1000,
                  tile: int = 2048, fanout: int = FANOUT
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k without the [Q, N] score matrix: K10 strided group
    maxima, max-pyramid selection of k groups, then the 8 k candidate rows
    per query gathered and rescored in fp32, 32 queries at a time.

    Candidate ids past N (the last tile's missing rows) are clamped for
    the gather and score finfo(float32).min, so the corpus is never padded.
    Corpora with ``n_groups // 8 <= k`` or less than one whole tile go to
    ``exact_search``."""
    _check_tile(tile)
    Q, D = queries.shape
    N = corpus.shape[0]
    k = min(k, N)
    n_groups = -(-N // tile) * tile // GROUP
    if n_groups // 8 <= k or N < tile:
        return exact_search(queries, corpus, k=k)
    gmax = fused_gmax_only(queries, corpus, tile)
    cand_idx = _strided_members(_select_groups(gmax, k, fanout), tile)
    s_out = torch.empty((Q, k), dtype=torch.float32, device=queries.device)
    i_out = torch.empty((Q, k), dtype=torch.int64, device=queries.device)
    for lo in range(0, Q, HIER2_Q_CHUNK):
        hi = min(lo + HIER2_Q_CHUNK, Q)
        cidx = cand_idx[lo:hi]
        rows = corpus[cidx.clamp(max=N - 1).reshape(-1)].view(hi - lo, -1, D)
        sc = torch.bmm(rows.float(),
                       queries[lo:hi].float()[:, :, None])[:, :, 0]
        sc = sc.masked_fill(cidx >= N, NEG)
        s_out[lo:hi], pos = torch.topk(sc, k, dim=1)
        i_out[lo:hi] = torch.gather(cidx, 1, pos)
    return s_out, i_out


# ---------------------------------------------------------------------------
# The phase-ablation kernel of the perf scripts: K11
# ---------------------------------------------------------------------------

# phase -> the entry point's phase id (csrc/gmax_phases.cu)
GMAX_PHASES = {"a3base": 0, "a3notr": 1, "a3mxutr": 2, "a3nomax": 3}


def _check_phase(phase: str):
    if phase not in GMAX_PHASES:
        raise ValueError(f"unknown gmax phase {phase!r} "
                         f"({' | '.join(GMAX_PHASES)})")


def gmax_phase_reference(queries: torch.Tensor, plain: torch.Tensor,
                         phase: str) -> torch.Tensor:
    """Plain PyTorch version of ``fused_gmax_phase``: fp32 products chunked
    over the corpus, then the phase's epilogue: the max over each block's
    8 docs ("a3base", "a3mxutr", and "a3notr" transposed to [NB, Q]) or
    the block's first doc alone ("a3nomax")."""
    _check_phase(phase)
    Q = queries.shape[0]
    NB = plain.shape[0] // GROUP
    q = queries.float()
    out = torch.empty((Q, NB), dtype=torch.float32, device=queries.device)
    for lo in range(0, NB, GMAX_CHUNK_BLOCKS):
        hi = min(lo + GMAX_CHUNK_BLOCKS, NB)
        s = (q @ plain[lo * GROUP:hi * GROUP].float().T).view(Q, hi - lo,
                                                             GROUP)
        out[:, lo:hi] = s[:, :, 0] if phase == "a3nomax" else s.amax(-1)
    return out.T.contiguous() if phase == "a3notr" else out


def fused_gmax_phase(queries: torch.Tensor, plain: torch.Tensor,
                     phase: str) -> torch.Tensor:
    """Block maxima of plain [NB * 8, D] for queries [Q, D] with the
    epilogue of one of ``score_path_phases``' ablation phases:

    - "a3base": gmax [Q, NB] fp32, the same values as ``fused_plain_gmax``;
    - "a3notr": the same maxima doc-major, [NB, Q];
    - "a3mxutr": a3base's values, moved through the tensor cores as a
      product with an identity before the store;
    - "a3nomax": [Q, NB], the score of each block's first doc (8b).

    CPU tensors run ``gmax_phase_reference``; CUDA tensors (bf16) launch
    ``csrc/gmax_phases.cu``."""
    _check_phase(phase)
    NB = _check_body(queries, (plain,))
    if not queries.is_cuda:
        return gmax_phase_reference(queries, plain, phase)
    Q, D = queries.shape
    _check_kernel_operands("fused_gmax_phase", queries, plain)
    shape = (NB, Q) if phase == "a3notr" else (Q, NB)
    out = torch.empty(shape, dtype=torch.float32, device=queries.device)
    if Q and NB:
        rc = load_library().gmax_phase_launch(
            queries.data_ptr(), plain.data_ptr(), out.data_ptr(), Q, D, NB,
            GMAX_PHASES[phase], _stream(queries))
        check(rc, "gmax_phase")
    return out

