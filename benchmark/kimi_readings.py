"""Read the numbers the output check compares for the ``encode_kimi``
cells, over many seeds in one process: the program's (whole runs of the
driver), the control's (the plain reference in fp8, the precision below
the configuration's bf16) and, with ``--faults``, the program's with each
fault of ``benchmark/tests/faults_kimi`` planted. The readings each limit
is set from.

    python3 benchmark/kimi_readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--faults all|name,...] [--fault-seed 9] \
        [--seconds 10] [--fault-seconds 3] [--out file] [--tiny]

Prints one JSON line a run, then the largest program reading, the
smallest control reading and each fault's reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(cell, seed, device):
    """The control's ``rep_err`` and ``route_err`` over the cell's sample
    of a pool-ordered window: the reference in fp8, with its own routes,
    against the reference along them."""
    from benchmark.drivers import encode_kimi as ek
    from benchmark.drivers import encode_lm as lm
    from benchmark.reference.deepseek_v3 import Routes

    n = cell.traffic["check_sample"] * 8
    flat, starts = ek.passages(cell.traffic, seed)
    which = lm.sample(cell.traffic, seed, starts, list(range(n)))
    own = Routes()
    got = ek.reference_reps(cell.config, seed, flat, starts, which, device,
                            precision="fp8", routes=own)
    along = Routes(own.taken)
    want = ek.reference_reps(cell.config, seed, flat, starts, which, device,
                             routes=along)
    return dict(lm.compare(got, want, along), order=0.0)


def program(cell, seed, seconds, device):
    from benchmark.drivers import encode_kimi

    out = encode_kimi.run(cell, seed, seconds, False, time.time(),
                          device=device)
    return {"rate": out.metrics, "peak_gib": out.memory_peak_bytes / 2**30,
            "graphs": out.layer["graphs"],
            "numbers": {k: v for k, (v, _) in out.checks.items()}}


def main(argv=None):
    import pytest

    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="kimi-linear-48b-a3b.encode-doc")
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seed", type=int, default=9)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--fault-seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    p.add_argument("--tiny", action="store_true",
                   help="the cell at the CPU tests' tiny sizes")
    args = p.parse_args(argv)
    from benchmark.common import find_cell
    from benchmark.tests import faults_kimi

    if args.tiny:
        from benchmark.tests.tiny_kimi import tiny_kimi

        cell = tiny_kimi()
    else:
        cell = find_cell(args.workload)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        emit(dict(seed=seed, kind="program",
                  **program(cell, seed, args.seconds, args.device)))
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        emit({"seed": seed, "kind": "control",
              "numbers": control(cell, seed, args.device)})
    faults = (faults_kimi.FAULTS if args.faults == "all"
              else [f for f in args.faults.split(",") if f])
    for name in faults:
        patch = pytest.MonkeyPatch()
        try:
            getattr(faults_kimi, name)(patch)
            emit(dict(seed=args.fault_seed, kind="fault", fault=name,
                      **program(cell, args.fault_seed, args.fault_seconds,
                                args.device)))
        finally:
            patch.undo()
    summary = {}
    for kind, agg in (("program", max), ("control", min)):
        got = [r["numbers"] for r in rows if r["kind"] == kind]
        if got:
            summary[kind] = {n: agg(g[n] for g in got) for n in got[0]}
    summary["faults"] = {r["fault"]: r["numbers"] for r in rows
                         if r["kind"] == "fault"}
    print(json.dumps({"workload": cell.name, "summary": summary}),
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}))


if __name__ == "__main__":
    main()
