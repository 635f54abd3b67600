"""A seeded corpus built straight into the prepared plain layout: the
port's own copy of ``bench.py``'s ``build_block_corpus``, for the search
twins (``corpus_scale``, ``qbatch_sweep``, ``rescore_compare``).

The result is what ``ops.cuda_mips.prepare_plain_corpus`` gives for an
``[N, 768]`` bf16 corpus, with the body zero-padded to whole 256-block
tiles as the JAX layout pads it: ``plain`` holds the first ``N // 8 * 8``
docs then zero rows (masked by the search), or that many tile-aligned
segments (``split_tiles``) when ``n_segs`` > 1, and ``tail`` the ``N % 8``
docs apart. The rows are N(0, 1) values drawn on the device, one chunk of
``CHUNK_ROWS`` after another from one seeded generator, so the corpus is
never resident twice (a chunk, 212 MB at D = 768, is the one transient) and
the rows are the same whatever the segment count.

Not ported: ``bench.py``'s ``default_segs``, ``N_SEGS``, ``PROVEN_SEGS``
and ``bench_state.json``, the TPU's fragmentation ladder. The twins take
one buffer unless ``--segs`` asks for more.
"""

from __future__ import annotations

import torch

from ..ops.cuda_mips import (GROUP, SEG_TILE_BLOCKS, BlockCorpus,
                             split_tiles)

D = 768
CHUNK_ROWS = 17_269 * GROUP  # doc rows per fill step, bench.py's


def build_corpus(n_docs: int, device: torch.device, seed: int = 0,
                 n_segs: int = 1, dim: int = D) -> BlockCorpus:
    """The seeded ``n_docs x dim`` bf16 corpus in the padded plain layout
    on ``device`` (see the module's docstring)."""
    nb = n_docs // GROUP
    tiles = max(-(-nb // SEG_TILE_BLOCKS), 1)
    segs = [torch.zeros((nt * SEG_TILE_BLOCKS * GROUP, dim),
                        dtype=torch.bfloat16, device=device)
            for nt in split_tiles(tiles, n_segs)]
    starts = [0]
    for seg in segs:
        starts.append(starts[-1] + seg.shape[0])
    # only the valid doc rows are filled (pad rows past NB * 8 stay 0), a
    # chunk at a time from one generator, so the rows do not depend on the
    # segments; a chunk that spans two segments is copied into both parts
    g = torch.Generator(device=device).manual_seed(seed)
    for lo in range(0, nb * GROUP, CHUNK_ROWS):
        hi = min(lo + CHUNK_ROWS, nb * GROUP)
        rows = torch.empty((hi - lo, dim), dtype=torch.bfloat16,
                           device=device).normal_(generator=g)
        for seg, a, b in zip(segs, starts, starts[1:]):
            x, y = max(lo, a), min(hi, b)
            if x < y:
                seg[x - a:y - a] = rows[x - lo:y - lo]
        del rows
    tail = torch.empty((n_docs - nb * GROUP, dim), dtype=torch.bfloat16,
                       device=device).normal_(
        generator=torch.Generator(device=device).manual_seed(seed + 7))
    return BlockCorpus(tail=tail, n_docs=n_docs,
                       plain=tuple(segs) if n_segs > 1 else segs[0])


def corpus_rows(prep: BlockCorpus) -> torch.Tensor:
    """The ``[N, dim]`` docs of a ``build_corpus`` layout in order (a copy:
    for tests and small audits)."""
    segs = prep.plain if isinstance(prep.plain, tuple) else (prep.plain,)
    body = torch.cat(segs)[:prep.n_docs // GROUP * GROUP]
    return torch.cat([body, prep.tail])
