"""The exact top-k over one card's MS MARCO-sized corpus, timed and
audited.

Twin of ``scripts/perf/corpus_scale.py``:

    python -m openmatch_tpu_torch.perf.corpus_scale [N] [Q] [K] [--device cpu]

N (default 8,841,823), Q (128) and K (1000) are the TPU script's, D = 768.
The corpus is built straight into the prepared plain layout
(``build_corpus``: seeded N(0, 1) bf16 rows, 12.65 GiB at the default N,
never resident twice), the queries are seeded N(0, 1) bf16 rows. It times
``plain_topk_prepared`` (the gmax kernel K1, the pyramid selection, the
gather-rescore kernel K3 and the ragged tail): CUDA events on the card,
the median of a few calls after a warm-up (``perf.time_ms``), in place of
the TPU script's ``fori_loop``. Then it audits the first ``AUDIT_Q``
queries against an independent chunked fp32 ``torch.matmul`` and
``torch.topk`` over every doc: the scores within rtol 1e-5 and atol 1e-4
(the JAX script's), and a recall of at least 0.999 of the docs the audit
scores above its k-th score's band (ties at the k-th score may go either
way). A failed audit raises.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from ..ops import cuda_mips as cm
from . import add_device_arg, device_of, normal, sync, time_ms
from .build_corpus import D, build_corpus

AUDIT_Q = 4
AUDIT_ROWS = 1 << 18  # corpus rows per fp32 audit product
RTOL, ATOL = 1e-5, 1e-4  # the JAX script's score tolerance
MIN_RECALL = 0.999


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(
        prog="python -m openmatch_tpu_torch.perf.corpus_scale",
        description=__doc__.splitlines()[0])
    ap.add_argument("N", type=int, nargs="?", default=8_841_823)
    ap.add_argument("Q", type=int, nargs="?", default=128)
    ap.add_argument("K", type=int, nargs="?", default=1000)
    add_device_arg(ap)
    return ap.parse_args(argv)


def audit_topk(q: torch.Tensor, prep, k: int):
    """fp32 scores of ``q`` against every doc of ``prep``, chunk by chunk,
    and their top ``k`` (scores, ids), independent of the search path."""
    rows, qf = prep.plain[:prep.n_docs // 8 * 8], q.float()
    parts = [torch.matmul(qf, rows[a:a + AUDIT_ROWS].float().T)
             for a in range(0, rows.shape[0], AUDIT_ROWS)]
    parts.append(torch.matmul(qf, prep.tail.float().T))
    return torch.topk(torch.cat(parts, dim=1), k, dim=1)


def audit(s: torch.Tensor, i: torch.Tensor, ref_s: torch.Tensor,
          ref_i: torch.Tensor) -> list:
    """Raise unless the answer's scores are within RTOL / ATOL of the
    audit's and holds at least MIN_RECALL of the docs the audit scores
    above its k-th score plus that tolerance; returns the recalls."""
    s, i, ref_s, ref_i = (t.cpu() for t in (s, i, ref_s, ref_i))
    np.testing.assert_allclose(s.numpy(), ref_s.numpy(), rtol=RTOL,
                               atol=ATOL)
    recalls = []
    for r in range(ref_s.shape[0]):
        band = ref_s[r, -1].item() + ATOL + RTOL * abs(ref_s[r, -1].item())
        above = set(ref_i[r][ref_s[r] > band].tolist())
        recalls.append(len(above & set(i[r].tolist())) / max(len(above), 1))
    if min(recalls) < MIN_RECALL:
        raise AssertionError(f"corpus_scale audit: recall {recalls} of the "
                             f"docs above the tie band < {MIN_RECALL}")
    return recalls


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse(argv)
    dev = device_of(args)
    N, Q, K = args.N, args.Q, args.K
    with torch.inference_mode():
        sync(dev)
        t0 = time.perf_counter()
        prep = build_corpus(N, dev)
        sync(dev)
        build_s = time.perf_counter() - t0
        print(f"plain corpus [{prep.plain.shape[0]}, {D}] bf16 ({N} docs) "
              f"built in {build_s:.1f} s", flush=True)
        q = normal((Q, D), 1, dev)
        s, i = cm.plain_topk_prepared(q, prep, K)
        ms = time_ms(lambda: cm.plain_topk_prepared(q, prep, K), dev)
        print(f"exact top-{K} @ {N} docs: {ms:.3f} ms/batch of {Q} -> "
              f"{Q / ms * 1000:,.0f} QPS on one {dev.type} device",
              flush=True)
        ref_s, ref_i = audit_topk(q[:AUDIT_Q], prep, K)
        recalls = audit(s[:AUDIT_Q], i[:AUDIT_Q], ref_s, ref_i)
        err = (s[:AUDIT_Q] - ref_s).abs().max().item()
        print(f"audit: recall vs independent top-k above the tie band = "
              f"{recalls}; max |score diff| {err:.3e}", flush=True)
    return {"N": N, "Q": Q, "K": K, "build_s": build_s,
            "ms": ms, "qps": Q / ms * 1000, "recalls": recalls,
            "max_score_err": err, "scores": s.cpu(), "ids": i.cpu(),
            "queries": q.cpu()}


if __name__ == "__main__":
    main()
