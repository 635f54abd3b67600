"""Per-card query-batch sweep of the exact search over one corpus.

Twin of ``scripts/perf/qbatch_sweep.py``:

    python -m openmatch_tpu_torch.perf.qbatch_sweep N_DOCS Q [Q ...]
        [--segs K] [--device cpu]

The gmax kernel reads the whole corpus once per batch, whatever Q, while
selection and the rescore grow with Q, so queries/s per card rise with the
batch until the compute overtakes the corpus read. For each Q (default 128
and 256) it times ``plain_topk_prepared`` over one seeded corpus
(``build_corpus``, D = 768 bf16, ``--segs`` segments, one buffer by
default) and prints ms and QPS per card: CUDA events on the card, the
median of a few calls after a warm-up. The corpus is built once for every
Q: the TPU script rebuilt it per Q for a fresh HBM heap per compile, which
a card's allocator does not need.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..ops import cuda_mips as cm
from . import add_device_arg, device_of, normal, time_ms
from .build_corpus import D, build_corpus

K = 1000  # bench.py's k: selection and the rescore grow with it


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(
        prog="python -m openmatch_tpu_torch.perf.qbatch_sweep",
        description=__doc__.splitlines()[0])
    ap.add_argument("n_docs", type=int)
    ap.add_argument("qs", type=int, nargs="*", default=[128, 256])
    ap.add_argument("--segs", type=int, default=1,
                    help="corpus segments (one buffer by default)")
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse(argv)
    dev = device_of(args)
    rows = []
    with torch.inference_mode():
        prep = build_corpus(args.n_docs, dev, n_segs=args.segs)
        for Q in args.qs:
            q = normal((Q, D), 1, dev)
            ms = time_ms(lambda: cm.plain_topk_prepared(q, prep, K), dev)
            rows.append({"Q": Q, "ms": ms, "qps": Q / ms * 1000})
            print(f"Q={Q} N={args.n_docs}: t_slice={ms:.3f} ms -> "
                  f"{Q / ms * 1000:,.0f} qps/{dev.type} device", flush=True)
            del q
    return {"n_docs": args.n_docs, "segs": args.segs, "rows": rows}


if __name__ == "__main__":
    main()
