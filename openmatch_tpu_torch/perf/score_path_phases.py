"""Time one phase of the exact-search paths in isolation.

Twin of ``scripts/perf/score_path_phases.py``:

    python -m openmatch_tpu_torch.perf.score_path_phases PHASE [N] [Q] [K] [ARG5] [--device cpu]

N (default 2,210,456 docs), Q (512 queries), K (1000) and D = 768 are the
TPU script's. The corpus is NBp * 8 rows, NBp = ceil(N / 8 / 256) * 256,
of seeded N(0, 1) bf16 values made on the device. Each phase runs its
piece once to warm up, then prints the median of a few timed runs (CUDA
events on the card). PHASE:

  a1          K7: fused_block_gmax over the block-row corpus
  a2          K8: fused_scores, every score doc-major
  a3, a3l1    K2 / K1: fused_plain_gmax, without / with the level-1 maxima
              and pad-block masking (emit_l1=8, nb_valid)
  a3base, a3notr, a3mxutr, a3nomax
              K11: fused_gmax_phase, K2's maxima with the ablated epilogues
              (the plain store, a doc-major store, the store through an
              identity product on the tensor cores, no member max)
  a3tile      K1 as a3l1, with the corpus stream's rate against HBM peak
  sel, sell1  _select_groups over synthetic gmax [Q, NBp], with or without
              a precomputed level 1; ARG5 forces a finest-first fanout
              plan, e.g. "8,8" (default: the port's uniform fanout 8)
  cand        gather_row_slices candidate fetch + final top-k over
              synthetic scores [Q, NBp * 8]
  resc, resc0 K6 / K3: gather_rescore of K random blocks, pipelined /
              drain-then-compute
  plain       plain_topk_prepared end to end; ARG5 = segment count
  rescseg     K5: gather_rescore over a segmented corpus; ARG5 = segments
  a3seg       K4: fused_plain_gmax_segs over the segments in one launch;
              ARG5 = segments

ARG5 values that set only a TPU tiling (a3tile's ``tile_g``, resc's
``kt``) are refused: the CUDA kernels have one fixed tile.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..ops import cuda_mips as cm
from ..ops.mips import _select_groups, gather_row_slices, pyramid_fanouts
from . import (HBM_BYTES_PER_S, add_device_arg, device_of, normal, randint,
               time_ms)

D = 768
GROUP = 8
TILE_BLOCKS = cm.SEG_TILE_BLOCKS  # the TPU script's tile_g: NBp's multiple
PHASES = ("a1", "a2", "a3", "a3l1", "a3base", "a3notr", "a3mxutr",
          "a3nomax", "a3tile", "sel", "sell1", "cand", "resc", "resc0",
          "plain", "rescseg", "a3seg")
# ARG5 on these phases sets a TPU tiling only: refused, with the reason
TPU_TILING_ARG5 = {
    "a3tile": "tile_g (corpus blocks per TPU grid step); the CUDA kernel's "
              "tile is fixed at 16 blocks x 64 or 256 queries",
    "resc": "kt (selected blocks per TPU grid step); the CUDA kernel takes "
            "one block per warp",
    "resc0": "kt (selected blocks per TPU grid step); the CUDA kernel takes "
             "one block per warp",
}


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(
        prog="python -m openmatch_tpu_torch.perf.score_path_phases",
        description=__doc__.splitlines()[0])
    ap.add_argument("phase", choices=PHASES)
    ap.add_argument("N", type=int, nargs="?", default=2_210_456)
    ap.add_argument("Q", type=int, nargs="?", default=512)
    ap.add_argument("K", type=int, nargs="?", default=1000)
    ap.add_argument("arg5", nargs="?", default=None,
                    help="sel/sell1: fanout plan 'f1,f2,...'; plain, "
                         "rescseg, a3seg: segment count")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.arg5 is not None and args.phase in TPU_TILING_ARG5:
        raise SystemExit(f"{args.phase}: ARG5 {args.arg5!r} would set "
                         f"{TPU_TILING_ARG5[args.phase]}; refused")
    return args


def _report(line: str, ms: float, **extra) -> dict:
    print(line, flush=True)
    return {"line": line, "ms": ms, **extra}


def _segments(dev, NBp: int, n_segs: int):
    """The corpus as ``n_segs`` segment allocations cut at 256-block tiles
    (prepare_plain_corpus); the one-buffer source is freed."""
    prep = cm.prepare_plain_corpus(normal((NBp * GROUP, D), 0, dev),
                                   n_segs=n_segs)
    return prep.plain if isinstance(prep.plain, tuple) else (prep.plain,)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse(argv)
    dev = device_of(args)
    phase, N, Q, K = args.phase, args.N, args.Q, args.K
    NB = N // GROUP
    NBp = -(-NB // TILE_BLOCKS) * TILE_BLOCKS
    q = normal((Q, D), 1, dev)

    with torch.inference_mode():
        if phase == "a1":
            cb = normal((NBp, GROUP * D), 0, dev)
            ms = time_ms(lambda: cm.fused_block_gmax(q, cb), dev)
            return _report(f"a1 fused_block_gmax: {ms:.3f} ms", ms)
        if phase == "a2":
            plain = normal((NBp * GROUP, D), 0, dev)
            ms = time_ms(lambda: cm.fused_scores(q, plain), dev)
            return _report(f"a2 fused_scores: {ms:.3f} ms", ms)
        if phase in ("a3", "a3l1", "a3tile"):
            plain = normal((NBp * GROUP, D), 0, dev)
            emit = 0 if phase == "a3" else 8
            nbv = None if phase == "a3" else NB
            ms = time_ms(lambda: cm.fused_plain_gmax(
                q, plain, emit_l1=emit, nb_valid=nbv), dev)
            if phase != "a3tile":
                return _report(f"{phase} fused_plain_gmax(emit_l1={emit}): "
                               f"{ms:.3f} ms", ms)
            rate = plain.numel() * 2 / (ms / 1000)
            return _report(
                f"a3tile (CUDA tile 16 blocks x {64 if Q <= 64 else 256} "
                f"queries): {ms:.3f} ms, "
                f"corpus stream {rate / 1e9:.0f} GB/s "
                f"({rate / HBM_BYTES_PER_S * 100:.0f}% of the H100's "
                f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s HBM peak)", ms,
                stream_bytes_per_s=rate)
        if phase in cm.GMAX_PHASES:
            plain = normal((NBp * GROUP, D), 0, dev)
            ms = time_ms(lambda: cm.fused_gmax_phase(q, plain, phase), dev)
            rate = plain.numel() * 2 / (ms / 1000)
            return _report(
                f"{phase}: {ms:.3f} ms, stream {rate / 1e9:.0f} GB/s "
                f"({rate / HBM_BYTES_PER_S * 100:.0f}% of the H100's "
                f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s HBM peak)", ms,
                stream_bytes_per_s=rate)
        if phase in ("sel", "sell1"):
            g = normal((Q, NBp), 0, dev, torch.float32)
            if args.arg5 is not None:
                plan = tuple(int(f) for f in args.arg5.split(","))
                label = f"plan={plan}"
            else:
                plan = pyramid_fanouts(NBp, K)
                label = f"plan={plan} (uniform fanout 8)"
            l1 = None
            if phase == "sell1":
                if not plan or NBp % plan[0]:
                    raise SystemExit(f"sell1 needs a plan whose first fanout "
                                     f"divides {NBp}, got {plan}")
                l1 = g.view(Q, NBp // plan[0], plan[0]).amax(-1)
            ms = time_ms(lambda: _select_groups(g, K, fanout=plan, l1=l1),
                         dev)
            return _report(f"{phase} _select_groups {label}: {ms:.3f} ms",
                           ms)
        if phase == "cand":
            scores = normal((Q, NBp * GROUP), 0, dev, torch.float32)
            bid = randint(NB, (Q, K), 1, dev)

            def cand_rank():
                cand = gather_row_slices(scores, bid * GROUP,
                                         GROUP).reshape(Q, K * GROUP)
                ids = (bid[:, :, None] * GROUP
                       + torch.arange(GROUP, device=dev)).reshape(Q, -1)
                s, pos = torch.topk(cand, K, dim=1)
                return s, torch.gather(ids, 1, pos)

            ms = time_ms(cand_rank, dev)
            return _report(f"cand gather+rank: {ms:.3f} ms", ms)
        if phase in ("resc", "resc0"):
            plain = normal((NBp * GROUP, D), 0, dev)
            bid = randint(NB, (Q, K), 2, dev, torch.int32)
            pipe = phase == "resc"
            ms = time_ms(lambda: cm.gather_rescore(q, plain, bid,
                                                   pipeline=pipe), dev)
            return _report(f"{phase} gather_rescore(pipeline={pipe}): "
                           f"{ms:.3f} ms", ms)
        n_segs = int(args.arg5) if args.arg5 is not None else (
            1 if phase == "plain" else 8)
        segs = _segments(dev, NBp, n_segs)
        if phase == "plain":
            prep = cm.BlockCorpus(tail=segs[0][:0], n_docs=NBp * GROUP,
                                  plain=segs if len(segs) > 1 else segs[0])
            ms = time_ms(lambda: cm.plain_topk_prepared(q, prep, K), dev)
            return _report(f"plain: {ms:.3f} ms (N={NBp * GROUP}, Q={Q}, "
                           f"K={K}, segs={len(segs)})", ms)
        if phase == "rescseg":
            bid = randint(NB, (Q, K), 2, dev, torch.int32)
            ms = time_ms(lambda: cm.gather_rescore(q, segs, bid), dev)
            return _report(f"rescseg gather_rescore(segs={len(segs)}): "
                           f"{ms:.3f} ms", ms)
        # a3seg: the TPU ran one gmax kernel per segment, then concatenated
        ms = time_ms(lambda: cm.fused_plain_gmax_segs(q, segs, emit_l1=8),
                     dev)
        return _report(
            f"a3seg fused_plain_gmax_segs(segs={len(segs)}): {ms:.3f} ms "
            "(one K4 launch over the segment table: no per-segment launches "
            "and no concat)", ms)


if __name__ == "__main__":
    main()
