"""Time this checkout against another checkout on one card, in turns in one
process.

    python -m openmatch_tpu_torch.perf.parent_vs_change PARENT [--rounds R]

PARENT is a directory holding another checkout's ``openmatch_tpu_torch``
(for example ``git archive <commit> openmatch_tpu_torch | tar -x -C
build/parent``, a git-ignored directory). That tree's package is imported
under another name, so each tree builds its own kernel library from its own
sources and runs its own wrappers; every case runs parent, change, change,
parent in every round. Separate processes differ by about 0.05 ms at 6.8
ms; turns in one process on one card cancel that drift.

The cases are the main path's shapes, made from a seed on the card:

- the kernels' raw C entry points: Q=64 over the 8-doc body of 8,841,823
  x 768 bf16 rows for K1 (l1 at fanout 8), K4 (the same rows as 6
  segments), K7 and K8; K9 and K10 at tile 2048; K3 and K5 at k=1000 at
  three selections: "serving" (the shape of the serving index's selection,
  ``SERVING_QUERIES_PER_BLOCK``, replayed over seeded blocks by
  ``replay_selection``), "uniform" (each query draws 1,000 of one seeded
  pool of 5,010 blocks, so every block has about 13 queries) and
  "all-distinct" (64,000 blocks of a seeded permutation); K6, the
  pipelined rescore, at the same three selections; K3 and K6 at the perf
  twins' ``resc0``/``resc`` shape (Q=512, k=1000 seeded ids over 276,307
  blocks); K1 and K11's four phases at Q=512 over 276,480 blocks. Each
  tree's rescore entry points are called with their own signatures, as
  its ``_build.SIGNATURES`` declares them.
- the whole search through each tree's own code: ``Searcher.search`` and
  ``plain_topk_prepared`` at Q=64, k=1000, over the single buffer and over
  6 segments. The rows are a seeded mean vector plus N(0, 1) noise and the
  queries the same mean plus ``QUERY_SPREAD`` times N(0, 1) noise, so that
  the 64 queries pick overlapping blocks, as they do on the serving
  index; the script prints the shape of that selection.

Each kernel case is timed two ways (``perf.event_ms``): behind an untimed
call ("call": where the host takes longer to enqueue the call than the
card to run the one before, that time counts, as it does for calls made
back to back) and behind a device spin ("spin": the card's work alone).
The searches, which queue their kernels behind a 4.6 ms gmax pass, are
timed behind an untimed call. Prints one line per case (the median device
ms of parent and change and their ratio under each timer, and the median
host microseconds of one call), then one JSON object.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import event_ms, spin_ms
from ..ops import _build, cuda_mips as cm
from ..ops.mips import Searcher

N_DOCS = 8_841_823
D = 768
PERF_BLOCKS = 276_480  # score_path_phases' 2,210,456 docs padded to 256
PERF_NB = 2_210_456 // 8  # the blocks its resc0 phase draws ids from
K = 1000
N_SEGS = 6
UNIFORM_POOL = 5_010  # the serving selection's distinct count
# Blocks of the serving index's selection by the number of queries that
# picked them (entry c - 1: blocks picked by c of the 64 queries), as
# chip_smoke.py's serve phase logs it: 5,010 distinct blocks, 64,000 picks.
SERVING_QUERIES_PER_BLOCK = (
    1359, 559, 343, 244, 212, 162, 147, 112, 121, 84, 80, 78, 67, 63, 65, 49,
    61, 46, 33, 41, 41, 39, 32, 39, 32, 35, 26, 31, 19, 23, 27, 24, 31, 21,
    22, 22, 28, 21, 17, 20, 17, 19, 26, 23, 17, 13, 25, 16, 18, 16, 14, 23,
    21, 22, 10, 23, 24, 15, 21, 22, 17, 22, 21, 89)
# query noise against the shared mean: 1 / (1 + 0.22^2) = 0.954 of a
# doc's score variance is common to all queries
QUERY_SPREAD = 0.22


def replay_selection(hist, n_q: int, k: int, nb: int,
                     seed: int) -> torch.Tensor:
    """[n_q, k] int32 block ids in which ``hist[c - 1]`` distinct blocks
    are picked by exactly c queries each, and no query repeats an id. The
    blocks come from a seeded permutation of ``nb``; each, the most picked
    first, goes to the c queries with the most room left (Ryser's
    construction, which fills every row whenever the shape allows it);
    then each row is shuffled."""
    rng = np.random.default_rng(seed)
    picks = np.repeat(np.arange(len(hist), 0, -1), np.asarray(hist)[::-1])
    if picks.sum() != n_q * k or len(hist) > n_q or len(picks) > nb:
        raise ValueError(f"a shape of {picks.sum()} picks of {len(picks)} "
                         f"blocks does not fill {n_q} x {k} from {nb}")
    room = np.full(n_q, k)
    rows = [[] for _ in range(n_q)]
    for block, c in zip(rng.permutation(nb)[:len(picks)], picks):
        to = np.lexsort((rng.random(n_q), -room))[:c]
        if room[to].min() == 0:
            raise ValueError("the shape does not fit the rows")
        room[to] -= 1
        for q in to:
            rows[q].append(block)
    return torch.from_numpy(np.stack([rng.permutation(r) for r in rows])
                            .astype(np.int32))


def load_tree(root: Path, name: str) -> tuple:
    """The ``ops._build``, ``ops.cuda_mips`` and ``ops.mips`` modules of
    the checkout at ``root``, its ``openmatch_tpu_torch`` package imported
    as ``name`` (its imports are relative, so its modules load from its
    own tree, and its ``_build`` builds that tree's kernel library)."""
    pkg = root / "openmatch_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.ops.{m}")
                 for m in ("_build", "cuda_mips", "mips"))


def shape_of(bid: torch.Tensor) -> str:
    """Distinct blocks of a selection and how many queries picked each."""
    _, per = torch.unique(torch.cat([r.unique() for r in bid]),
                          return_counts=True)
    h = torch.bincount(per, minlength=4)
    return (f"{per.numel()} distinct of {bid.numel()} ({int(h[1])} of 1 "
            f"query, {int(h[2])} of 2, {int(h[3:].sum())} of 3 to "
            f"{int(per.max())})")


def kernel_cases(dev: torch.device, corpus: torch.Tensor, q64, segs):
    """({name: fn(lib)}, tensors): each fn launches its case's kernel once
    on the current stream through lib's raw entry point and returns its
    code; the tensors must outlive the calls. ``segs``, the same rows as
    6 segments, may be None: then no K4 or K5 case."""
    g = torch.Generator(device=dev).manual_seed(1)
    body = corpus[:N_DOCS // 8 * 8]
    nb = body.shape[0] // 8
    q512 = torch.randn(512, D, generator=g, device=dev, dtype=torch.bfloat16)
    perf = torch.randn(PERF_BLOCKS * 8, D, generator=g, device=dev,
                       dtype=torch.bfloat16)
    f = 8
    gmax = torch.empty(64, nb, device=dev)
    l1 = torch.empty(64, -(-nb // f), device=dev)
    scores = torch.empty(64, nb * 8, device=dev)
    np2048 = -(-N_DOCS // 2048) * 2048
    s9 = torch.empty(64, np2048, device=dev)
    g9 = torch.empty(64, np2048 // 8, device=dev)
    g512 = torch.empty(512, PERF_BLOCKS, device=dev)
    l512 = torch.empty(512, PERF_BLOCKS // f, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    one = cm._seg_table((body,))
    six = cm._seg_table(segs) if segs else None
    big = cm._seg_table((perf,))
    perm = torch.randperm(nb, generator=g, device=dev)
    pick = torch.rand(64, UNIFORM_POOL, generator=g,
                      device=dev).argsort(1)[:, :K]
    selections = {
        "serving": replay_selection(SERVING_QUERIES_PER_BLOCK, 64, K, nb,
                                    2).to(dev),
        "uniform": perm[:UNIFORM_POOL][pick].int(),
        "all-distinct": perm[:64 * K].view(64, K).int()}
    for sel, bids in selections.items():
        print(f"selection {sel}: {shape_of(bids)}", flush=True)
    resc0 = torch.randint(0, PERF_NB, (512, K), generator=g, device=dev,
                          dtype=torch.int32)
    rescored = torch.empty(512, K * 8, device=dev)
    scratch, dedup = cm._dedup_scratch(nb, 64, K, dev)
    keep = (body, perf, selections, resc0, scratch)

    def k1(lib, tab=one, n=1):
        return lib.plain_gmax_launch(q64.data_ptr(), tab[0], tab[1], n,
                                     gmax.data_ptr(), l1.data_ptr(), 64, D,
                                     0, nb, nb, f, stream)

    def scratch_args(fn, name):
        """The scratch pointers where the tree's entry point takes them
        (this tree's signature), else none (an older tree's)."""
        return dedup if len(fn.argtypes) == len(_build.SIGNATURES[name]) \
            else ()

    def k3(lib, bids, tab=one, n=1, q=q64):
        """The tree's own rescore signature: with the scratch pointers
        (14 arguments) or without them (10)."""
        fn = lib.gather_rescore_launch
        return fn(q.data_ptr(), tab[0], tab[1], n, bids.data_ptr(),
                  rescored.data_ptr(),
                  *scratch_args(fn, "gather_rescore_launch"), q.shape[0], D,
                  K, stream)

    def k6(lib, bids, rows=body, q=q64):
        """The tree's own pipelined-rescore signature: with the scratch
        pointers (13 arguments) or without them (9)."""
        fn = lib.gather_rescore_pipelined_launch
        return fn(q.data_ptr(), rows.data_ptr(), bids.data_ptr(),
                  rescored.data_ptr(),
                  *scratch_args(fn, "gather_rescore_pipelined_launch"),
                  q.shape[0], D, K, rows.shape[0] // 8, stream)

    rescore_cases = {}
    for sel, bids in selections.items():
        rescore_cases[f"K3 Q=64 8.8M {sel}"] = \
            lambda lib, b=bids: k3(lib, b)
        if six:
            rescore_cases[f"K5 Q=64 8.8M 6 segments {sel}"] = \
                lambda lib, b=bids: k3(lib, b, six, N_SEGS)
        rescore_cases[f"K6 Q=64 8.8M {sel}"] = \
            lambda lib, b=bids: k6(lib, b)
    k4 = {"K4 Q=64 8.8M 6 segments": lambda lib: k1(lib, six, N_SEGS)} \
        if six else {}

    return {
        "K1 Q=64 8.8M": k1,
        **k4,
        "K7 Q=64 8.8M": lambda lib: lib.block_gmax_launch(
            q64.data_ptr(), body.data_ptr(), gmax.data_ptr(), 64, D, nb,
            stream),
        "K8 Q=64 8.8M": lambda lib: lib.scores_launch(
            q64.data_ptr(), body.data_ptr(), scores.data_ptr(), 64, D,
            nb * 8, stream),
        "K9 Q=64 8.8M tile 2048": lambda lib: lib.score_gmax_launch(
            q64.data_ptr(), corpus.data_ptr(), s9.data_ptr(), g9.data_ptr(),
            64, D, N_DOCS, 2048, stream),
        "K10 Q=64 8.8M tile 2048": lambda lib: lib.gmax_only_launch(
            q64.data_ptr(), corpus.data_ptr(), g9.data_ptr(), 64, D, N_DOCS,
            2048, stream),
        **rescore_cases,
        "K3 Q=512 2.2M resc0": lambda lib: k3(lib, resc0, big, 1, q512),
        "K6 Q=512 2.2M resc": lambda lib: k6(lib, resc0, perf, q512),
        "K1 Q=512 2.2M": lambda lib: lib.plain_gmax_launch(
            q512.data_ptr(), big[0], big[1], 1, g512.data_ptr(),
            l512.data_ptr(), 512, D, 0, PERF_BLOCKS, PERF_BLOCKS, f, stream),
        **{f"K11 {phase} Q=512 2.2M": (
            lambda lib, i=i: lib.gmax_phase_launch(
                q512.data_ptr(), perf.data_ptr(), g512.data_ptr(), 512, D,
                PERF_BLOCKS, i, stream))
           for phase, i in cm.GMAX_PHASES.items()},
    }, keep


def mean_rows(dev: torch.device) -> tuple:
    """(rows [N_DOCS, D] bf16, queries [64, D] bf16): a seeded mean vector
    plus N(0, 1) noise, and the same mean plus QUERY_SPREAD x N(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(0)
    mean = torch.randn(D, generator=g, device=dev)
    rows = torch.empty(N_DOCS, D, device=dev, dtype=torch.bfloat16)
    for lo in range(0, N_DOCS, 1 << 20):
        hi = min(lo + (1 << 20), N_DOCS)
        rows[lo:hi] = torch.randn(hi - lo, D, generator=g, device=dev) + mean
    q = mean + QUERY_SPREAD * torch.randn(64, D, generator=g, device=dev)
    return rows, q.to(torch.bfloat16)


def in_turns(run, rounds: int, queues) -> dict:
    """run(who) in turns, parent, change, change, parent, under each
    ``event_ms`` queue; {queue: {who: median ms}} and {who: median host
    us of one call}."""
    ms = {qu: {"parent": [], "change": []} for qu in queues}
    host = {"parent": [], "change": []}

    def call(who):
        t0 = time.perf_counter()
        run(who)
        host[who].append((time.perf_counter() - t0) * 1e6)

    for who in ("parent", "change"):  # warm up
        for qu in queues:
            event_ms(lambda: call(who), qu)
    for _ in range(rounds):
        for who in ("parent", "change", "change", "parent"):
            for qu in queues:
                ms[qu][who].append(event_ms(lambda: call(who), qu))
    return ({qu: {w: statistics.median(v) for w, v in t.items()}
             for qu, t in ms.items()},
            {w: statistics.median(v) for w, v in host.items()})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="directory holding the other checkout's "
                    "openmatch_tpu_torch")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("parent_vs_change: needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    trees = {"parent": load_tree(Path(args.parent), "parent_tree"),
             "change": (_build, cm, sys.modules[Searcher.__module__])}
    libs = {who: t[0].load_library() for who, t in trees.items()}
    out = {}

    def report(name, ms, host):
        out[name] = {"host_us": host}
        parts = []
        for qu, m in ms.items():
            ratio = m["change"] / m["parent"]
            out[name][qu or "plain"] = {**m, "ratio": ratio}
            parts.append(f"behind {qu or 'nothing'}: parent "
                         f"{m['parent']:.4f} ms, change {m['change']:.4f} ms"
                         f", change/parent {ratio:.4f}")
        print(f"{name}: " + "; ".join(parts) + f"; host per call parent "
              f"{host['parent']:.1f} us, change {host['change']:.1f} us",
              flush=True)

    with torch.inference_mode():
        rows, q64 = mean_rows(dev)
        searchers = {who: (t[2].Searcher(rows, k=K),
                           t[2].Searcher(rows, k=K, n_segs=N_SEGS))
                     for who, t in trees.items()}
        segs = searchers["change"][1]._prep.plain
        runs, keep = kernel_cases(dev, rows, q64, segs)
        print("spin before a timed call: %d cycles, %.4f ms" % spin_ms(),
              flush=True)
        for name, fn in runs.items():
            report(name, *in_turns(
                lambda who: _build.check(fn(libs[who]), name), args.rounds,
                ("call", "spin")))
        del keep
        torch.cuda.empty_cache()
        g1, l1 = cm.fused_plain_gmax(q64, rows[:N_DOCS // 8 * 8], emit_l1=8)
        bid = sys.modules[Searcher.__module__]._select_groups(g1, K, l1=l1)
        print(f"search selection: {shape_of(bid)}", flush=True)
        del g1, l1, bid
        for i, label in enumerate(("single buffer", f"{N_SEGS} segments")):
            report(f"Searcher.search Q=64 8.8M {label}", *in_turns(
                lambda who: searchers[who][i].search(q64), args.rounds,
                ("call",)))
            report(f"plain_topk_prepared Q=64 8.8M {label}", *in_turns(
                lambda who: trees[who][1].plain_topk_prepared(
                    q64, searchers[who][i]._prep, K), args.rounds,
                ("call",)))
    print("spin at the end: %d cycles, %.4f ms" % spin_ms(), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "rounds": args.rounds, "cases": out}))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
