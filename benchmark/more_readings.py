"""Read the numbers the output check compares for the cells whose kind
``readings.py`` does not know (``encode_lm``), over many seeds in one
process: the program's (whole runs of the cell's driver) and the
control's (the plain reference in fp8, the precision below the
configuration's bf16). The readings each limit is set from.

    python3 benchmark/more_readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 10] [--out file]

Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def encode_lm_control(cell, seed, device):
    """The control's ``rep_err`` and ``route_err`` over the cell's sample
    of a pool-ordered window: the reference in fp8, with its own routes,
    against the reference along them."""
    from benchmark.drivers import encode_lm as lm
    from benchmark.reference.deepseek_v3 import Routes

    n = cell.traffic["check_sample"] * 8
    flat, starts = lm.passages(cell.traffic, seed)
    which = lm.sample(cell.traffic, seed, starts, list(range(n)))
    own = Routes()
    got = lm.reference_reps(cell.config, seed, flat, starts, which, device,
                            precision="fp8", routes=own)
    along = Routes(own.taken)
    want = lm.reference_reps(cell.config, seed, flat, starts, which, device,
                             routes=along)
    return dict(lm.compare(got, want, along), order=0.0)


def readings(cell, seeds, control_seeds, seconds, device):
    from benchmark.drivers import encode_lm

    rows = []
    for seed in seeds:
        out = encode_lm.run(cell, seed, seconds, False, time.time(),
                            device=device)
        row = {"seed": seed, "rate": out.metrics,
               "program": {k: v for k, (v, _) in out.checks.items()}}
        if seed in control_seeds:
            row["control"] = encode_lm_control(cell, seed, device)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    p.add_argument("--tiny", action="store_true",
                   help="the cell at the CPU tests' tiny sizes")
    args = p.parse_args(argv)
    from benchmark.common import find_cell

    if args.tiny:
        from benchmark.tests.tiny_lm import tiny_lm

        cell = tiny_lm(args.workload)
    else:
        cell = find_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = readings(cell, seeds, control, args.seconds, args.device)
    summary = {}
    for key in ("program", "control"):
        got = [r[key] for r in rows if key in r]
        if got:
            agg = max if key == "program" else min
            summary[key] = {n: agg(g[n] for g in got) for n in got[0]}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}))


if __name__ == "__main__":
    main()
