"""What every part of the harness shares: finding a cell and its data
files by name, seeds, the card checks, and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. It names a
configuration (``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``); the mix's ``kind`` names the
driver that runs it (``benchmark/drivers/<kind>.py``), the
configuration's ``model_type`` its plain reference
(``benchmark/reference/<model_type>.py``), and the cell's limits for the
output check live in ``benchmark/cells/<cell>.json``. Each per-layer
metric is read by ``benchmark/metrics/<metric>.py``. Adding any of these
is adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = ROOT / "BENCHMARK.json"

# the reference package and its libraries: none may be loaded where the
# result is printed (compared by whole top-level names: the port's
# ``openmatch_tpu_torch`` begins with ``openmatch_tpu``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "openmatch_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its data files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def find_cell(name: str, spec_path=SPEC, bench_dir=BENCH) -> Cell:
    """The cell ``name`` of ``spec_path`` with its configuration, traffic
    and limits; raises KeyError naming the cells there when it is not."""
    spec = load_json(spec_path)
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in {spec_path} (have: "
                       f"{', '.join(sorted(by_name))})")
    w = by_name[name]
    file = {c["name"]: c["file"] for c in spec["configs"]}[w["config"]]
    cell = make_cell(name, w["config"], w["traffic"], int(w["chips"]),
                     bench_dir, Path(spec_path).parent / file)
    cell.end_to_end = [m for m in spec["end_to_end"] if _applies(m, name)]
    cell.per_layer = [m for m in spec["per_layer"] if _applies(m, name)]
    return cell


def make_cell(name: str, config: str, traffic: str, chips: int,
              bench_dir=BENCH, config_file=None) -> Cell:
    """A cell from its data files alone (no metrics): the configuration
    (``config_file``, by default ``configs/<config>.json``), the mix
    ``traffic/<traffic>.json`` and the limits ``cells/<name>.json`` when
    there are any."""
    bench_dir = Path(bench_dir)
    limits_path = bench_dir / "cells" / f"{name}.json"
    config_file = config_file or bench_dir / "configs" / f"{config}.json"
    return Cell(name=name, chips=chips, config=load_json(config_file),
                traffic=load_json(bench_dir / "traffic" / f"{traffic}.json"),
                limits=(load_json(limits_path)["limits"]
                        if limits_path.exists() else {}))


def load_file_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name`` (metric readers
    are named after metrics, which may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, str(path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(metric_name: str, bench_dir=BENCH):
    path = Path(bench_dir) / "metrics" / f"{metric_name}.py"
    return load_file_module(path, "benchmark_metric_"
                            + metric_name.replace(".", "_").replace("-", "_"))


# ---- seeds ---------------------------------------------------------------

# fixed stream tags, so each use of the run's seed draws its own numbers
TAG_WEIGHTS, TAG_INDEX, TAG_TEXT, TAG_ORDER, TAG_SAMPLE = 1, 2, 3, 4, 5


def derived_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for ``torch.Generator`` from the run's ``seed`` (any
    whole number) and a stream ``tag``."""
    state = np.random.SeedSequence([int(seed) % 2**64, tag]).generate_state(
        2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1])) & (2**63 - 1)


def rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, tag])


# ---- statistics ------------------------------------------------------------


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linear between
    order statistics; ``inf`` entries sort last."""
    arr = np.sort(np.asarray(values, dtype=np.float64))
    if arr.size == 0:
        return math.nan
    pos = (arr.size - 1) * q / 100.0
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if arr[hi] == math.inf:
        return math.inf if pos > lo or arr[lo] == math.inf else arr[lo]
    return float(arr[lo] + (arr[hi] - arr[lo]) * (pos - lo))


# ---- the card --------------------------------------------------------------


def require_cards(chips: int) -> None:
    """Exit non-zero, printing no result, unless ``chips`` CUDA cards are
    visible: the benchmark measures the card and never falls back."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("benchmark: no CUDA card (torch.cuda.is_available() is "
                 "False); nothing measured")
    if torch.cuda.device_count() < chips:
        sys.exit(f"benchmark: the cell needs {chips} cards, "
                 f"{torch.cuda.device_count()} visible; nothing measured")


def card_description() -> str:
    """The cards' names and power limits, read by ``nvidia-smi`` (which
    sets nothing), and the visible count."""
    import subprocess

    import torch

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable ({type(e).__name__})"
    return (f"cards: {torch.cuda.device_count()} visible; name, "
            f"power.limit: {smi}")


def forbidden_loaded() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)


# ---- the result ------------------------------------------------------------


@dataclass
class Outcome:
    """What a driver hands back for the result line."""

    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, float]      # end-to-end, by name
    memory_peak_bytes: int
    chips: int
    checks: Dict[str, tuple]       # name -> (value, limit)
    layer: Dict[str, Any] = field(default_factory=dict)  # for the readers
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None


def judge(checks: Dict[str, tuple]) -> bool:
    """Every number at or under its limit (a missing limit fails)."""
    return all(limit is not None and value is not None
               and math.isfinite(value) and value <= limit
               for value, limit in checks.values())


def result_line(cell: Cell, out: Outcome, trace: bool,
                device_kind: str) -> dict:
    """The last line's object: per-layer metrics with ``--trace 1``, else
    the cell's end-to-end ones; the compared numbers last."""
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(out.layer)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.metrics[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": device_kind, "count": out.chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if trace:
        device.update(busy_s=float(out.busy_s), window_s=float(out.window_s))
    line = {"correct": bool(out.correct), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, (value, limit) in out.checks.items()}
    return line
