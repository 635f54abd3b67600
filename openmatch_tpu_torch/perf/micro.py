"""Microbenchmarks for the exact-MIPS pipeline pieces.

Twin of ``scripts/perf/micro.py``:

    python -m openmatch_tpu_torch.perf.micro MODE [Q] [N] [K] [--device cpu]

Q (default 512), N (1,000,000) and K (1000) and D = 768 are the TPU
script's; the corpus and queries are seeded N(0, 1) bf16 values made on
the device. The line printed keeps the TPU script's fields: ms per call
(the median of a few runs after the first, CUDA events on the card), QPS,
and the first call's seconds. MODE:

- library yardsticks: ``matmul_f32`` (one ``torch.mm`` with fp32 output
  where the installed torch takes ``out_dtype``, else bf16 output, as the
  line says), ``matmul_bf16``, ``gmax_xla`` (the product, then the max of
  8 consecutive columns: two calls);
- kernels: ``gmax_pallas``, ``gmax_pallas_t<tile>``, ``gp_<tile>_<tq>``
  (K10), ``sgp_<tile>_<tq>``, ``score_gmax_pallas`` (K9),
  ``block_gmax[_<tg>_<tq>]`` (K7), ``scores_kernel`` (K8);
- whole paths: ``pallas_full_<tile>_<tq>`` (hier2_search, K9),
  ``rescore_full[_<tile>_<tq>]`` (hier2_rescore, K10),
  ``block_full[_<tg>_<tq>]`` (block_topk, K7), ``score_full``
  (block_score_topk_prepared, K7 + K8), ``block_prep_full``
  (block_topk_prepared, K7), ``hier2_full`` and ``xla_full_pyramid``
  (exact_search with method "hier2" / "pyramid");
- selection and gathers: ``topk_<W>``, ``sortval_<W>``, ``sortpair_<W>``,
  ``topkgather_<W>``, ``approxk_<W>`` (exact ``torch.topk``: the port has
  no approximate top-k), ``gather_minor_<W>``, ``slab_gather_<W>``,
  ``gather_rows``, ``select_groups`` and ``cand_slices``.

``tile_q``, ``tq`` and ``tg`` name TPU grid tilings; the CUDA kernels have
one fixed tile, which the line states. ``tile`` in the strided-group modes
defines which docs form a group, so it is honoured.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional, Tuple

import torch

from ..ops import cuda_mips as cm
from ..ops.mips import _select_groups, exact_search, gather_row_slices
from . import (add_device_arg, device_of, first_call_s, normal, randint,
               time_ms)

D = 768
GATHER_COLS = 8000  # gather_minor_ / gather_rows: columns per query
ROWS_QB = 32        # gather_rows: queries per block
CUDA_TILE = "CUDA tile 64 queries x 128 rows"  # K9, K10: wmma mainloop
HOPPER_TILE = ("CUDA tile 128 rows x 64 or 256 queries, "  # K7, K8: wgmma
               "persistent blocks")


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(prog="python -m openmatch_tpu_torch.perf.micro",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("mode")
    ap.add_argument("Q", type=int, nargs="?", default=512)
    ap.add_argument("N", type=int, nargs="?", default=1_000_000)
    ap.add_argument("K", type=int, nargs="?", default=1000)
    add_device_arg(ap)
    return ap.parse_args(argv)


def mm_f32(dev: torch.device) -> Tuple[Callable, str]:
    """(mm, note): mm(q, c) is q @ c.T in one ``torch.mm`` call, with fp32
    output where the installed torch takes ``out_dtype`` on ``dev`` (probed
    once, here), else with bf16 output; the note says which."""
    a = torch.zeros((1, 8), dtype=torch.bfloat16, device=dev)
    try:
        torch.mm(a, a.T, out_dtype=torch.float32)
    except (TypeError, NotImplementedError, RuntimeError):
        return ((lambda x, y: torch.mm(x, y.T)),
                "bf16 out: torch.mm takes no out_dtype here")
    return (lambda x, y: torch.mm(x, y.T, out_dtype=torch.float32)), "fp32 out"


def _ints(mode: str, n: int) -> List[int]:
    """The last n '_'-separated integers of a mode name."""
    parts = mode.split("_")[-n:]
    try:
        return [int(p) for p in parts]
    except ValueError:
        raise SystemExit(f"unknown mode {mode}") from None


def build(mode: str, q: torch.Tensor, corpus: torch.Tensor, K: int,
          dev: torch.device) -> Tuple[Callable, str]:
    """(the function to time, a note for the line) for ``mode``."""
    Q, N = q.shape[0], corpus.shape[0]

    def scalar():  # the TPU loop's carry: one value of q added each call
        return q[0, 0].float()

    if mode == "matmul_f32":
        mm, note = mm_f32(dev)
        return (lambda: mm(q, corpus)), note
    if mode == "matmul_bf16":
        return (lambda: torch.mm(q, corpus.T)), "bf16 out"
    if mode == "gmax_xla":
        mm, note = mm_f32(dev)
        body = corpus[:N // 8 * 8]
        return (lambda: mm(q, body).view(Q, N // 8, 8).amax(-1)), \
            f"two calls: torch.mm ({note}), then amax over 8 columns"
    if mode == "gmax_pallas" or mode.startswith("gmax_pallas_t"):
        tile = 2048 if mode == "gmax_pallas" else int(mode.split("t")[-1])
        return (lambda: cm.fused_gmax_only(q, corpus, tile)), \
            f"K10, tile={tile}, {CUDA_TILE}"
    if mode.startswith("gp_") or mode.startswith("sgp_"):
        tile, tq = _ints(mode, 2)
        if mode.startswith("gp_"):
            return (lambda: cm.fused_gmax_only(q, corpus, tile)), \
                f"K10, tile={tile}, tile_q={tq} not used: {CUDA_TILE}"
        return (lambda: cm.fused_score_gmax(q, corpus, tile)[1]), \
            f"K9, tile={tile}, tile_q={tq} not used: {CUDA_TILE}"
    if mode.startswith("pallas_full_"):
        tile, tq = _ints(mode, 2)
        return (lambda: cm.hier2_search(q, corpus, K, tile)[0]), \
            f"hier2_search (K9), tile={tile}, tile_q={tq} not used: {CUDA_TILE}"
    if mode == "rescore_full" or mode.startswith("rescore_full_"):
        tile, tq = _ints(mode, 2) if mode != "rescore_full" else (2048, None)
        note = "" if tq is None else f", tile_q={tq} not used: {CUDA_TILE}"
        return (lambda: cm.hier2_rescore(q, corpus, K, tile)[0]), \
            f"hier2_rescore (K10), tile={tile}{note}"
    if mode == "score_gmax_pallas":
        return (lambda: cm.fused_score_gmax(q, corpus, 2048)[1]), \
            f"K9, tile=2048, {CUDA_TILE}"
    if mode.split("_")[0] in ("topk", "sortval", "sortpair", "topkgather",
                              "approxk"):
        kind, W = mode.split("_")[0], _ints(mode, 1)[0]
        g = normal((Q, W), 3, dev, torch.float32)
        ids = torch.arange(W, device=dev).expand(Q, W)
        if kind in ("topk", "approxk"):
            note = ("exact torch.topk: the port has no approximate top-k"
                    if kind == "approxk" else "torch.topk")
            return (lambda: torch.topk(g + scalar(), K, dim=1)[0]), note
        if kind == "sortval":
            return (lambda: torch.sort(g + scalar(), dim=-1)[0]), "torch.sort"

        if kind == "sortpair":
            def sortpair():
                neg_s, order = torch.sort(-(g + scalar()), dim=1)
                torch.gather(ids, 1, order)  # the id payload
                return neg_s[:, :K]

            return sortpair, "torch.sort + id gather"

        def topkgather():
            s, pos = torch.topk(g + scalar(), K, dim=1)
            return torch.gather(ids, 1, pos) + s[:, :1].long()

        return topkgather, "torch.topk + id gather"
    if mode.startswith("gather_minor_"):
        W = _ints(mode, 1)[0]
        src = normal((Q, W), 3, dev, torch.float32)
        idx = randint(W, (Q, GATHER_COLS), 4, dev)
        return (lambda: torch.gather(src + scalar(), 1, idx)), "torch.gather"
    if mode.startswith("slab_gather_"):
        W = _ints(mode, 1)[0]
        src = normal((Q, W), 3, dev, torch.float32)
        idx = randint(W // 8, (Q, K), 4, dev)

        def slab_gather():
            s3 = (src + scalar()).view(Q, W // 8, 8)
            return torch.gather(s3, 1, idx[:, :, None].expand(-1, -1, 8))

        return slab_gather, "torch.gather of 8-column slabs"
    if mode == "gather_rows":
        idx = randint(N, (Q, GATHER_COLS), 4, dev)

        def gather_rows():
            out = torch.empty((Q, GATHER_COLS), dtype=torch.float32,
                              device=dev)
            for lo in range(0, Q, ROWS_QB):
                hi = min(lo + ROWS_QB, Q)
                rows = corpus[idx[lo:hi].reshape(-1)].view(hi - lo,
                                                           GATHER_COLS, D)
                out[lo:hi] = torch.bmm(rows.float(),
                                       q[lo:hi].float()[:, :, None])[:, :, 0]
            return out

        return gather_rows, f"row gather + fp32 bmm, {ROWS_QB} queries a block"
    if mode == "select_groups":
        g = normal((Q, N // 8), 3, dev, torch.float32)
        return (lambda: _select_groups(g + scalar(), K)), \
            "uniform fanout 8"
    if mode.startswith("block_full") or mode.startswith("block_gmax"):
        parts = mode.split("_")
        if len(parts) not in (2, 4):
            raise SystemExit(f"unknown mode {mode}")
        tiling = (f", tile_g={parts[2]}, tile_q={parts[3]} not used: "
                  f"{HOPPER_TILE}") if len(parts) == 4 else f", {HOPPER_TILE}"
        if parts[1] == "full":
            return (lambda: cm.block_topk(q, corpus, K)[0]), \
                "block_topk (K7)" + tiling
        NB = N // 8
        cb = corpus[:NB * 8].view(NB, 8 * D)  # a view: no padded copy
        return (lambda: cm.fused_block_gmax(q, cb)), "K7" + tiling
    if mode == "scores_kernel":
        return (lambda: cm.fused_scores(q, corpus)), f"K8, {HOPPER_TILE}"
    if mode in ("score_full", "block_prep_full"):
        with_plain = mode == "score_full"
        prep = cm.prepare_block_corpus(corpus, with_plain=with_plain)
        if with_plain:
            return (lambda: cm.block_score_topk_prepared(q, prep, K)[0]), \
                "block_score_topk_prepared (K7 + K8)"
        return (lambda: cm.block_topk_prepared(q, prep, K)[0]), \
            "block_topk_prepared (K7)"
    if mode == "cand_slices":
        scores = normal((Q, N), 3, dev, torch.float32)
        bid = randint(N // 8, (Q, K), 4, dev)

        def cand_slices():
            cand = gather_row_slices(scores + scalar(), bid * 8,
                                     8).reshape(Q, K * 8)
            return torch.topk(cand, K, dim=1)[0]

        return cand_slices, "gather_row_slices + torch.topk"
    if mode in ("hier2_full", "xla_full_pyramid"):
        method = "hier2" if mode == "hier2_full" else "pyramid"
        return (lambda: exact_search(q, corpus, K, 0, method=method)[0]), \
            f"exact_search(method={method!r})"
    raise SystemExit(f"unknown mode {mode}")


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse(argv)
    dev = device_of(args)
    Q, N, K = args.Q, args.N, args.K
    with torch.inference_mode():
        corpus = normal((N, D), 0, dev)
        q = normal((Q, D), 1, dev)
        fn, note = build(args.mode, q, corpus, K, dev)
        first = first_call_s(fn, dev)
        ms = time_ms(fn, dev, warmup=0)
    line = (f"{args.mode}: Q={Q} N={N} K={K}: {ms:.2f} ms/iter "
            f"({Q / (ms / 1000):,.0f} QPS) [first call {first:.2f}s] "
            f"({note})")
    print(line, flush=True)
    return {"line": line, "ms": ms, "first_call_s": first, "note": note}


if __name__ == "__main__":
    main()
