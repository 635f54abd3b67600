"""Time variants of a kernel, made from this checkout's sources by text
edits, in turns in one process on one card.

    python -m openmatch_tpu_torch.perf.ablate [--kernel gmax|pipelined]
                                              [--rounds R] [--out DIR]

Each variant is a copy of the package under DIR/<kernel>/<name> (default
``build/ablate``, git-ignored) with its edits applied, and builds its own
kernel library; the raw entry points are then called in turns, one launch
per variant per round, the order reversed every other round, each launch
timed by its own CUDA event pair behind an untimed call
(``perf.event_ms``). An edit whose text is not in the source raises, so the
variants follow the source. The cases are ``parent_vs_change``'s inputs
and cases.

``--kernel gmax`` (``ops/csrc/plain_gmax.cu``; K7 and K1 at Q=64 over
8,841,816 x 768, K1 at Q=512 over 2,211,840 rows):

- ``as_is``: the source as it is.
- ``no_stores``: the storer warps take each staged run and store nothing.
- ``no_epilogue``: the consumers stage nothing and the storers store
  nothing: the mainloop alone.
- ``run1``, ``run4``, ``run8``: 1, 4 or 8 tiles per run of stores at
  QN = 64 instead of 16.

``--kernel pipelined`` (``ops/csrc/gather_rescore_pipelined.cu``, K6 at
Q=64, k=1000 over the 8.8M body at the serving shape and all-distinct, and
at the ``resc`` shape, Q=512 over 276,480 blocks); the variants other than
``as_is`` and ``stages8`` compute wrong scores and are for timing only:

- ``row_copies``: one bulk copy a row (8 a block) instead of one a slab.
- ``stages8``: a ring of 8 stages instead of 16.
- ``no_mma``: the consumers wait for each block and free its stage but
  score nothing: the copy pipeline alone.
- ``no_score``: no block is scored or copied: the clear, claim and scatter
  phases, the grid barriers and the launch.

Prints one line per case and one JSON object.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
from pathlib import Path

import torch

from . import event_ms
from ..ops._build import check
from .parent_vs_change import kernel_cases, load_tree, mean_rows

PKG = Path(__file__).resolve().parents[1]
RUN16 = "constexpr int kRunTiles = QN == QN_NARROW ? 16 : 1;"
STAGED = "        mbar_wait(&hand.staged, i & 1);\n"
STORER_TOP = "        if (j + 1 < n) return;"
CONSUMER_STAGE = "      float* const gs = staging + j * NBT;\n"
WHOLE = "    const bool whole = d0 == 0 && D <= PIECE;"
STAGES16 = "constexpr int STAGES = 16;"
ACTIVE = "      const bool active = (m.bits >> (16 * tt)) & 0xffffull;"
MINE = "    const int mine = blocks_of(blockIdx.x, gridDim.x,  // 2. score"

# kernel -> (source, {variant: [(old, new), ...]}, cases)
KERNELS = {
    "gmax": ("ops/csrc/plain_gmax.cu", {
        "as_is": [],
        "no_stores": [(STAGED, STAGED + "        if (Q > 0) {\n"
                       "          __syncwarp();\n"
                       "          if (st % 32 == 0) mbar_arrive(&hand.freed);\n"
                       "          ++i;\n"
                       "          return;\n"
                       "        }\n")],
        "no_epilogue": [(STORER_TOP, "        if (Q > 0) return;\n"
                         + STORER_TOP),
                        (CONSUMER_STAGE, "      if (Q > 0) return;\n"
                         + CONSUMER_STAGE)],
        **{f"run{n}": [(RUN16, RUN16.replace("? 16 :", f"? {n} :"))]
           for n in (1, 4, 8)},
    }, ("K7 Q=64 8.8M", "K1 Q=64 8.8M", "K1 Q=512 2.2M")),
    "pipelined": ("ops/csrc/gather_rescore_pipelined.cu", {
        "as_is": [],
        "row_copies": [(WHOLE, "    const bool whole = false;")],
        "stages8": [(STAGES16, "constexpr int STAGES = 8;")],
        "no_mma": [(ACTIVE, ACTIVE.replace("= (m.bits", "= nq < 0 && (m.bits"))],
        "no_score": [(MINE, MINE.replace("= blocks_of", "= 0 * blocks_of"))],
    }, ("K6 Q=64 8.8M serving", "K6 Q=64 8.8M all-distinct",
        "K6 Q=512 2.2M resc")),
}


def make_variant(root: Path, src: str, edits) -> Path:
    """A copy of the package under ``root`` with ``edits`` applied to its
    ``src``."""
    dst = root / "openmatch_tpu_torch"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns("__pycache__"))
    path = dst / src
    text = path.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"ablate: edit not found in {src}: {old!r}")
        text = text.replace(old, new, 1)
    path.write_text(text)
    return root


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="gmax")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default=str(PKG.parent / "build" / "ablate"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate: needs an NVIDIA card")
    src, variants, cases = KERNELS[args.kernel]
    libs = {name: load_tree(make_variant(
        Path(args.out) / args.kernel / name, src, edits),
        f"ablate_{args.kernel}_{name}")[0].load_library()
        for name, edits in variants.items()}
    names = list(libs)
    out = {}
    with torch.inference_mode():
        dev = torch.device("cuda", 0)
        rows, q = mean_rows(dev)
        runs, keep = kernel_cases(dev, rows, q, None)

        def timed(fn, lib, case):
            return event_ms(lambda: check(fn(lib), case), "call")

        for case in cases:
            fn = runs[case]
            for n in names:  # warm up
                timed(fn, libs[n], case)
            t = {n: [] for n in names}
            for r in range(args.rounds):
                for n in names if r % 2 == 0 else names[::-1]:
                    t[n].append(timed(fn, libs[n], case))
            out[case] = {n: statistics.median(v) for n, v in t.items()}
            print(f"{case}: " + ", ".join(f"{n} {ms:.4f} ms"
                                         for n, ms in out[case].items()),
                  flush=True)
    del keep, rows, q
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "kernel": args.kernel, "rounds": args.rounds,
                      "cases": out}))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
