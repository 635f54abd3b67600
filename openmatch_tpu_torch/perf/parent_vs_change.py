"""Time this checkout's kernels against another checkout's on one card, in
turns in one process.

    python -m openmatch_tpu_torch.perf.parent_vs_change PARENT [--rounds R]

PARENT is a directory holding another checkout's ``openmatch_tpu_torch``
(for example ``git archive <commit> openmatch_tpu_torch | tar -x -C
build/parent``, a git-ignored directory). Both trees' ``ops/_build.py`` are
loaded by path, each builds its own kernel library from its own sources,
and the raw C entry points are called in turns, parent, change, change,
parent in every round, each launch timed by its own CUDA event pair.
Separate processes differ by about 0.05 ms at 6.8 ms; turns in one process
on one card cancel that drift.

The cases are the main path's shapes, made from a seed on the card: Q=64
over 8,841,816 x 768 bf16 (the 8-doc body of the 8,841,823-row index) for
K1 (l1 at fanout 8), K4 (the same rows as 6 segments), K7 and K8; K9 and
K10 at tile 2048 over 8,841,823 rows; and Q=512 over 276,480 blocks
(2,211,840 rows, the perf scripts' default) for K1 and K11 (a3base).
Prints one line per case: the median device ms of parent and change and
their ratio, and the median host microseconds of one call of the entry
point (the enqueue, tensor-map encodes included), then one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from ..ops import _build, cuda_mips as cm

N_DOCS = 8_841_823
D = 768
PERF_BLOCKS = 276_480  # score_path_phases' 2,210,456 docs padded to 256


def load_build(root: Path):
    """The ``ops/_build`` module of the checkout at ``root``."""
    path = root / "openmatch_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location("parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(dev: torch.device):
    """({name: fn(lib)}, tensors): each fn launches its case's kernel once
    on the current stream through lib's raw entry point; the tensors must
    outlive the calls."""
    g = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn(N_DOCS, D, generator=g, device=dev,
                         dtype=torch.bfloat16)
    body = corpus[:N_DOCS // 8 * 8]
    nb = body.shape[0] // 8
    segs = cm.prepare_plain_corpus(corpus, n_segs=6).plain
    q64 = torch.randn(64, D, generator=g, device=dev, dtype=torch.bfloat16)
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
    six = cm._seg_table(segs)
    big = cm._seg_table((perf,))
    keep = (corpus, body, segs, perf)  # alive as long as the closures

    def k1(lib, tab=one, n=1):
        return lib.plain_gmax_launch(q64.data_ptr(), tab[0], tab[1], n,
                                     gmax.data_ptr(), l1.data_ptr(), 64, D,
                                     0, nb, nb, f, stream)

    return {
        "K1 Q=64 8.8M": k1,
        "K4 Q=64 8.8M 6 segments": lambda lib: k1(lib, six, 6),
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
        "K1 Q=512 2.2M": lambda lib: lib.plain_gmax_launch(
            q512.data_ptr(), big[0], big[1], 1, g512.data_ptr(),
            l512.data_ptr(), 512, D, 0, PERF_BLOCKS, PERF_BLOCKS, f, stream),
        "K11 a3base Q=512 2.2M": lambda lib: lib.gmax_phase_launch(
            q512.data_ptr(), perf.data_ptr(), g512.data_ptr(), 512, D,
            PERF_BLOCKS, cm.GMAX_PHASES["a3base"], stream),
    }, keep


def timed(fn, lib, name: str):
    """(device ms, host us) of one launch. A launch just before it keeps
    the card busy while the timed one is enqueued, so the host's time does
    not enter the device time."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    _build.check(fn(lib), name)
    a.record()
    t0 = time.perf_counter()
    rc = fn(lib)
    host = (time.perf_counter() - t0) * 1e6
    b.record()
    _build.check(rc, name)
    b.synchronize()
    return a.elapsed_time(b), host


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="directory holding the other checkout's "
                    "openmatch_tpu_torch")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("parent_vs_change: needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    libs = {"parent": load_build(Path(args.parent)).load_library(),
            "change": _build.load_library()}
    runs, keep = cases(dev)
    out = {}
    with torch.inference_mode():
        for name, fn in runs.items():
            for who in ("parent", "change"):  # warm up
                timed(fn, libs[who], name)
            t = {"parent": [], "change": []}
            for _ in range(args.rounds):
                for who in ("parent", "change", "change", "parent"):
                    t[who].append(timed(fn, libs[who], name))
            med = {who: (statistics.median(x[0] for x in v),
                         statistics.median(x[1] for x in v))
                   for who, v in t.items()}
            out[name] = {"parent_ms": med["parent"][0],
                         "change_ms": med["change"][0],
                         "ratio": med["change"][0] / med["parent"][0],
                         "parent_host_us": med["parent"][1],
                         "change_host_us": med["change"][1]}
            print(f"{name}: parent {med['parent'][0]:.4f} ms, change "
                  f"{med['change'][0]:.4f} ms, change/parent "
                  f"{out[name]['ratio']:.4f}; host per call parent "
                  f"{med['parent'][1]:.1f} us, change {med['change'][1]:.1f}"
                  " us", flush=True)
    del keep
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "rounds": args.rounds, "cases": out}))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
