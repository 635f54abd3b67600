"""Merge overhead of the docs-partitioned search over ranks.

Twin of ``scripts/perf/sharded_merge.py``:

    python -m openmatch_tpu_torch.perf.sharded_merge [--world 2]
        [--shard_rows 32768] [--dim 128] [--qs 64,256] [--ks 100,1000]
        [--method kernel|plain] [--device cpu]

The corpus is ``world x shard_rows`` seeded N(0, 1) rows of ``dim`` (bf16
on the kernel path, fp32 on the plain one), the TPU script's sizes by
default. At equal total work, per (Q, k):

  t_full     the exact top-k over every row on rank 0's device alone
             (``plain_topk_prepared``, or ``exact_search`` chunked at
             ``shard_rows``);
  t_sharded  ``sharded_search`` over the ranks: each rank's shard, the
             all-gather of the [ranks, Q, k] candidates and their merge.

``overhead = t_sharded - t_full`` isolates the merge and the collectives.
The ranks are spawned (``parallel.mesh.spawn_ranks``; gloo when they share
a card, its collectives through host memory). Times are the host's clock
around a synced call (a collective syncs the host anyway), the median of
``REPS`` after a warm-up. On the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.mips import exact_search, shard_corpus, sharded_search
from ..parallel.mesh import make_mesh, spawn_ranks
from . import add_device_arg, sync

REPS = 5


def parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(
        prog="python -m openmatch_tpu_torch.perf.sharded_merge",
        description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--shard_rows", type=int, default=32_768)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--qs", default="64,256")
    ap.add_argument("--ks", default="100,1000")
    ap.add_argument("--method", default="kernel", choices=["kernel",
                                                            "plain"])
    add_device_arg(ap)
    return ap.parse_args(argv)


def wall_ms(fn: Callable, device: torch.device, reps: int = REPS) -> float:
    """Median host milliseconds of a synced call, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1000)
    return statistics.median(times)


def _rank(device, spec: dict) -> list:
    """One rank: the corpus from the shared seed, this rank's shard, then
    per (Q, k) rank 0's full scan (the others wait) and the sharded search
    on every rank. Returns rank 0's rows."""
    import torch.distributed as dist

    from ..ops import cuda_mips as cm

    world, rows, dim = spec["world"], spec["shard_rows"], spec["dim"]
    kernel = spec["method"] == "kernel"
    dtype = torch.bfloat16 if kernel else torch.float32
    mesh = make_mesh(world, 1, device)
    rng = np.random.RandomState(0)
    host = torch.from_numpy(rng.randn(world * rows, dim).astype(np.float32))
    host = host.to(dtype)
    shard = shard_corpus(host, mesh)
    full = prep = None
    if mesh.rank == 0:
        full = host.to(device)
        prep = cm.prepare_plain_corpus(full) if kernel else None
    out = []
    with torch.inference_mode():
        for Q in spec["qs"]:
            for k in spec["ks"]:
                q = torch.from_numpy(rng.randn(Q, dim).astype(
                    np.float32)).to(device=device, dtype=dtype)
                t_full = None
                if mesh.rank == 0:
                    t_full = wall_ms(
                        (lambda: cm.plain_topk_prepared(q, prep, k)) if kernel
                        else (lambda: exact_search(q, full, k,
                                                   chunk_size=rows)), device)
                dist.barrier()
                t_sharded = wall_ms(lambda: sharded_search(
                    q, shard, k, mesh, chunk_size=0 if kernel else rows,
                    method=spec["method"], n_valid=world * rows), device)
                out.append({"Q": Q, "k": k, "t_full_ms": t_full,
                            "t_sharded_ms": t_sharded})
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)  # raises without a card
    spec = {"world": args.world, "shard_rows": args.shard_rows,
            "dim": args.dim, "method": args.method,
            "qs": [int(x) for x in args.qs.split(",")],
            "ks": [int(x) for x in args.ks.split(",")]}
    print(f"ranks={args.world} shard_rows={args.shard_rows} D={args.dim} "
          f"method={args.method} device={device.type}", flush=True)
    rows = spawn_ranks(_rank, args.world, args=(spec,),
                       device=device.type)[0]
    for r in rows:
        over = r["t_sharded_ms"] - r["t_full_ms"]
        r["overhead_ms"] = over
        print(f"Q={r['Q']:4d} k={r['k']:5d}: full-1dev "
              f"{r['t_full_ms']:7.2f} ms, sharded {r['t_sharded_ms']:7.2f} "
              f"ms, merge overhead {over:6.2f} ms "
              f"({(r['t_sharded_ms'] / r['t_full_ms'] - 1) * 100:5.1f}%)",
              flush=True)
    return {"rows": rows, **spec}


if __name__ == "__main__":
    main()
