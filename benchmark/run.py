"""Run one cell of the benchmark of ``openmatch_tpu_torch`` on the card(s)
of this machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json``; its traffic mix's
``kind`` names the driver. A run builds the cell from the seed on the
card, warms up, measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints the result as the last
line of standard output (the compared numbers also as the last lines of
standard error). Without the cards the cell asks for it exits non-zero
and prints no result.
"""

import time

T_START = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def driver(cell):
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.common import (card_description, find_cell,
                                  forbidden_loaded, require_cards,
                                  result_line)

    cell = find_cell(args.workload)
    require_cards(cell.chips)
    import torch

    print(card_description(), file=sys.stderr, flush=True)
    out = driver(cell).run(cell, args.seed, args.seconds, bool(args.trace),
                           T_START, device="cuda")
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: the reference package or JAX was loaded: "
              f"{', '.join(bad)}; no result", file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace),
                       torch.cuda.get_device_name(0))
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
