"""The candidate-rescore strategies of the exact search, side by side.

Twin of ``scripts/perf/rescore_compare.py``:

    python -m openmatch_tpu_torch.perf.rescore_compare [N] [Q] [K]
        [--paths xla,dma,plain,pipelined] [--device cpu]

N (default 2,210,456), Q (128) and K (1000) are the TPU script's, D = 768.
One seeded corpus (``build_corpus``) serves every path: its padded plain
body, and the block-row view of the same bytes (``prepare_block_corpus``:
a view, no copy, where the TPU script made a relayout copy). The paths:

  xla        ``block_topk_prepared(rescore="xla")``: the block-row gmax
             kernel K7, the selected block rows gathered, an fp32 product;
  dma        ``block_topk_prepared(rescore="dma")``: K7, then the
             gather-rescore kernel K3;
  plain      ``plain_topk_prepared(pipeline=False)``: the gmax kernel K1
             and K3 (the production default);
  pipelined  ``plain_topk_prepared(pipeline=True)``: K1 and the pipelined
             rescore kernel K6.

Each is timed (CUDA events on the card, the median of a few calls after a
warm-up, in place of the TPU script's ``fori_loop``), and every answer must
equal the first path's above the k-th score's tie band.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..ops import cuda_mips as cm
from . import add_device_arg, agree_above_band, device_of, normal, time_ms
from .build_corpus import D, build_corpus

PATHS = {
    "xla": ("block path, rescore=xla",
            lambda q, prep, blocks, k: cm.block_topk_prepared(
                q, blocks, k, rescore="xla")),
    "dma": ("block path, rescore=dma",
            lambda q, prep, blocks, k: cm.block_topk_prepared(
                q, blocks, k, rescore="dma")),
    "plain": ("plain path, rescore drain (production default)",
              lambda q, prep, blocks, k: cm.plain_topk_prepared(
                  q, prep, k, pipeline=False)),
    "pipelined": ("plain path, rescore pipelined",
                  lambda q, prep, blocks, k: cm.plain_topk_prepared(
                      q, prep, k, pipeline=True)),
}


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(
        prog="python -m openmatch_tpu_torch.perf.rescore_compare",
        description=__doc__.splitlines()[0])
    ap.add_argument("N", type=int, nargs="?", default=2_210_456)
    ap.add_argument("Q", type=int, nargs="?", default=128)
    ap.add_argument("K", type=int, nargs="?", default=1000)
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated subset of " + ",".join(PATHS))
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse(argv)
    paths = args.paths.split(",")
    unknown = set(paths) - set(PATHS)
    if unknown:
        raise SystemExit(f"unknown paths {sorted(unknown)}: "
                         + ",".join(PATHS))
    dev = device_of(args)
    N, Q, K = args.N, args.Q, args.K
    out = {"N": N, "Q": Q, "K": K, "paths": {}}
    with torch.inference_mode():
        prep = build_corpus(N, dev)
        # the block rows are the plain body's bytes: a view
        blocks = cm.prepare_block_corpus(prep.plain, with_plain=True)._replace(
            tail=prep.tail, n_docs=N)
        q = normal((Q, D), 1, dev)
        first = None
        for name in paths:
            label, fn = PATHS[name]
            s, i = fn(q, prep, blocks, K)
            ms = time_ms(lambda: fn(q, prep, blocks, K), dev)
            err = 0.0
            if first is None:
                first = (name, s, i)
            else:
                err = agree_above_band(f"rescore_compare {name} vs "
                                       f"{first[0]}", s, i, first[1],
                                       first[2])
            print(f"{label}: {ms:.3f} ms/batch (Q={Q}, N={N})", flush=True)
            out["paths"][name] = {"ms": ms, "max_score_err": err,
                                  "scores": s.cpu(), "ids": i.cpu()}
    out["queries"] = q.cpu()
    return out


if __name__ == "__main__":
    main()
