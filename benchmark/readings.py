"""Read the numbers the output check compares, over many seeds in one
process, for the program and for the control (the plain reference in
fp8, the precision below the configurations' bf16), and for training
also a fault planted in the reference (half of the batch left out): the
readings each limit is set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 2] [--out file]

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


def search_readings(cell, seeds, control_seeds, seconds, device):
    import torch

    from benchmark.drivers import search as so

    device = torch.device(device)
    rows = []
    for seed in seeds:
        state = so.setup(cell, seed, device)
        so.drive(state, cell.traffic["rate_per_s"], 0.5, seed, tag=1)
        w = so.drive(state, cell.traffic["rate_per_s"], seconds, seed)
        so.release_program(state)
        row = {"seed": seed, "program": so.check(state, w, seed)}
        if seed in control_seeds:
            picks = so.sample(w, cell.traffic, seed)
            row["control"] = so.control_numbers(
                state, [w.texts[i] for i in picks])
        rows.append(row)
        print(json.dumps(row), flush=True)
        del state, w
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def encode_readings(cell, seeds, control_seeds, seconds, device):
    from benchmark.drivers import encode as en

    rows = []
    for seed in seeds:
        out = en.run(cell, seed, seconds, False, time.time(), device=device)
        row = {"seed": seed, "program": {k: v for k, (v, _) in
                                         out.checks.items()}}
        if seed in control_seeds:
            row["control"] = encode_control(cell, seed, device)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def encode_control(cell, seed, device):
    import numpy as np

    from benchmark.common import TAG_WEIGHTS, derived_seed
    from benchmark.drivers import encode as en
    from benchmark.weights import hf_state

    tr, cfg = cell.traffic, cell.config
    weights = hf_state(cfg, derived_seed(seed, TAG_WEIGHTS), device)
    flat, starts = en.passages(tr, seed)
    n = tr["check_sample"] * 8
    lengths = np.diff(starts)[np.arange(n) % (len(starts) - 1)]
    which = en.pick(list(range(n)), lengths, tr["check_sample"], seed)
    p_len = cfg["dr"]["p_max_len"]
    want = en.reference_reps(cfg, weights, flat, starts, which, p_len,
                             device)
    got = en.reference_reps(cfg, weights, flat, starts, which, p_len,
                            device, precision="fp8")
    return {"rep_err": en.rep_err(got, want), "order": 0.0}


def train_readings(cell, seeds, control_seeds, device):
    import torch

    from benchmark.drivers import train as tr_drv

    dev = torch.device(device)
    rows = []
    for seed in seeds:
        trainer, batches = tr_drv.build(dev, cell, seed)
        with tr_drv.dropout_off(trainer.model):
            prog = tr_drv.first_steps(trainer, batches,
                                      cell.traffic["check_steps"],
                                      cell.config)
        batches.close()
        del trainer
        ref = tr_drv.reference_readings(cell, seed, dev)
        row = {"seed": seed, "losses": prog["losses"],
               "ref_losses": ref["losses"],
               "program": tr_drv.compare(prog, ref),
               "leaves": leaf_table(prog, ref)}
        if seed in control_seeds:
            for variant in ("fp8", "half"):
                row[variant] = tr_drv.compare(
                    tr_drv.reference_readings(cell, seed, dev, variant), ref)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def leaf_table(prog, ref):
    """The look at the leaves: the five widest gradient gaps and the five
    widest change gaps (name, program norm, reference norm), and the
    median leaf's gaps."""
    import numpy as np

    out = {}
    for key in ("grad_norms", "change_norms"):
        pg, rg = prog[key], ref[key]
        med = float(np.median(list(rg.values())))
        gap = {n: abs(pg[n] - rg[n]) / max(rg[n], med) for n in rg}
        worst = sorted(gap, key=lambda n: -gap[n])
        out[key] = [[n, pg[n], rg[n]] for n in worst[:5]]
        out[key + "_median_gap"] = float(np.median(list(gap.values())))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    p.add_argument("--tiny", action="store_true",
                   help="the cell at the CPU tests' tiny sizes")
    args = p.parse_args(argv)
    from benchmark.common import find_cell

    if args.tiny:
        from benchmark.tests.tiny import tiny

        cell = tiny(args.workload)
    else:
        cell = find_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    kind = cell.traffic["kind"]
    if kind == "train":
        rows = train_readings(cell, seeds, control, args.device)
    elif kind == "search":
        rows = search_readings(cell, seeds, control, args.seconds,
                               args.device)
    else:
        rows = encode_readings(cell, seeds, control, args.seconds,
                               args.device)
    summary = {}
    for key in ("program", "control", "fp8", "half"):
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
