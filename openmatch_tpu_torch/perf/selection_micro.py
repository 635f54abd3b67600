"""The selection primitives of the exact search at the serving query count.

Twin of ``scripts/perf/selection_micro.py``:

    python -m openmatch_tpu_torch.perf.selection_micro topk   W [Q K]
    python -m openmatch_tpu_torch.perf.selection_micro gather W [Q K F]
    python -m openmatch_tpu_torch.perf.selection_micro idfix  W [Q K]
        [--device cpu]

``topk`` is ``torch.topk`` of K over [Q, W]; ``gather`` is
``ops.mips.gather_row_slices``, [Q, K] slabs of F (default 8) from
[Q, W] (W rounded up to a multiple of F); ``idfix`` is ``torch.gather`` of
[Q, K] columns of the first K: the counterparts of the JAX script's
``lax.top_k``, ``gather_row_slices`` and ``take_along_axis``. Q defaults
to 128 and K to 1000; the operand is seeded N(0, 1) fp32 values and the
indices seeded integers, made on the device. Each call is timed (CUDA
events on the card, the median of a few calls after a warm-up) with a
carry from the previous result added to the operand, as the TPU script's
loop adds it. It runs no hand-written kernel.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..ops.mips import gather_row_slices
from . import add_device_arg, device_of, normal, randint, time_ms

PRIMS = ("topk", "gather", "idfix")


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(
        prog="python -m openmatch_tpu_torch.perf.selection_micro",
        description=__doc__.splitlines()[0])
    ap.add_argument("prim", choices=PRIMS)
    ap.add_argument("W", type=int)
    ap.add_argument("Q", type=int, nargs="?", default=128)
    ap.add_argument("K", type=int, nargs="?", default=1000)
    ap.add_argument("F", type=int, nargs="?", default=8,
                    help="gather only: the slab width")
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse(argv)
    dev = device_of(args)
    Q, K, F = args.Q, args.K, args.F
    W = -(-args.W // F) * F  # gather's contract: W % slab == 0
    with torch.inference_mode():
        x = normal((Q, W), 0, dev, torch.float32)
        idx = randint(max(W // F, 1), (Q, K), 1, dev)
        if args.prim == "topk":
            def call(v):
                return torch.topk(v, min(K, W), dim=1).values
        elif args.prim == "gather":
            def call(v):
                return gather_row_slices(v, idx * F, F)
        else:
            def call(v):
                return torch.gather(v[:, :K], 1, idx % K)
        carry = torch.zeros((), device=dev)

        def step():
            out = call(x + carry)
            carry.copy_(out.reshape(-1)[0] * 1e-30)
            return out

        out = call(x)
        ms = time_ms(step, dev)
    f_note = f" F={F}" if args.prim == "gather" else ""
    print(f"{args.prim} W={W} Q={Q} K={K}{f_note}: {ms:.3f} ms", flush=True)
    return {"prim": args.prim, "W": W, "Q": Q, "K": K, "F": F, "ms": ms,
            "x": x, "idx": idx, "out": out}


if __name__ == "__main__":
    main()
