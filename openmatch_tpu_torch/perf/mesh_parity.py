"""Mesh-Searcher kernel-path parity: the mesh path's cost over the direct one.

Twin of ``scripts/perf/mesh_parity.py``:

    python -m openmatch_tpu_torch.perf.mesh_parity [N] [Q] [K] [--device cpu]

N (default 2,210,456, a multiple of 8 so the padded plain array is the
``pad_plain`` layout the mesh path reads), Q (128) and K (1000) are the TPU
script's, D = 768; the corpus and queries are seeded N(0, 1) bf16 values
made on the device. It times what ``Searcher(mesh=, partition="queries",
method="kernel")`` runs on a 1-rank mesh (``query_sharded_search`` over
the ``pad_plain`` corpus: ``plain_topk_valid``, K1 + K3) against the direct
prepared path (``plain_topk_prepared``), each the median of a few calls
timed by CUDA events on the card. Done is the mesh path within ~5% of the
direct one. The two answers' max score difference is printed too.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..ops import cuda_mips as cm
from ..ops.mips import Searcher
from ..parallel.mesh import make_mesh
from . import add_device_arg, device_of, normal, time_ms

D = 768
DONE_RATIO = 1.05


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(
        prog="python -m openmatch_tpu_torch.perf.mesh_parity",
        description=__doc__.splitlines()[0])
    ap.add_argument("N", type=int, nargs="?", default=2_210_456)
    ap.add_argument("Q", type=int, nargs="?", default=128)
    ap.add_argument("K", type=int, nargs="?", default=1000)
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse(argv)
    dev = device_of(args)
    N, Q, K = args.N, args.Q, args.K
    if N % 8:
        raise ValueError(f"N={N}: use a multiple of 8 so the padded plain "
                         "array is the pad_plain layout the mesh path reads")
    with torch.inference_mode():
        corpus = normal((N, D), 0, dev)
        q = normal((Q, D), 1, dev)
        prep = cm.prepare_plain_corpus(corpus)
        searcher = Searcher(corpus, k=K, mesh=make_mesh(1, 1, dev),
                            method="kernel", partition="queries")
        s_d, _ = cm.plain_topk_prepared(q, prep, K)
        s_m, _ = searcher.search(q)
        diff = float((s_d - s_m).abs().max())
        t_direct = time_ms(lambda: cm.plain_topk_prepared(q, prep, K), dev)
        t_mesh = time_ms(lambda: searcher.search(q), dev)
    ratio = t_mesh / t_direct
    lines = [f"direct prepared kernel path: {t_direct:.3f} ms/batch "
             f"(Q={Q}, N={N})",
             f"mesh Searcher queries-partition path ({searcher.last_dispatch}"
             f"): {t_mesh:.3f} ms/batch (Q={Q}, N={N})",
             f"ratio mesh/direct = {ratio:.3f} "
             f"({'OK <= 1.05' if ratio <= DONE_RATIO else 'ABOVE 5%'}); "
             f"max |score diff| {diff:.3e}"]
    for line in lines:
        print(line, flush=True)
    return {"direct_ms": t_direct, "mesh_ms": t_mesh, "ratio": ratio,
            "done": ratio <= DONE_RATIO, "max_score_diff": diff,
            "dispatch": searcher.last_dispatch}


if __name__ == "__main__":
    main()
