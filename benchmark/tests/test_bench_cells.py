"""``BENCHMARK.json`` against the contract's shape, and cells, traffic
mixes and per-layer metrics added as data: new files and entries only."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run as run_mod
from benchmark.common import (BENCH, SPEC, Outcome, find_cell, load_json,
                              metric_reader, result_line)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return load_json(SPEC)


def test_benchmark_json_has_the_contract_keys_and_names():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "benchmark/run.py"]
    assert s["paths"] == ["benchmark"]
    names = [c["name"] for c in s["configs"]] + [
        w["name"] for w in s["workloads"]] + [
        m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert Path(SPEC.parent / c["file"]).exists()
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= 1
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = next(x for x in s["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_every_cell_resolves_with_its_files(cell):
    c = find_cell(cell)
    assert (BENCH / "drivers" / f"{c.traffic['kind']}.py").exists()
    assert (BENCH / "reference" / f"{c.config['model_type']}.py").exists()
    assert c.limits, "each cell's limits live in benchmark/cells/<cell>.json"
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(metric_reader(m["name"]).read)


def test_parse_args():
    a = run_mod.parse_args(["--workload", "x", "--seed", str(2**31 + 9),
                            "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("x", 2**31 + 9,
                                                        10.0, 1)


def test_a_cell_a_mix_and_a_metric_added_as_files(tmp_path):
    """A new cell with a new traffic mix and a new per-layer metric, as
    new files and new entries only, is found by name."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    s = spec()
    s["workloads"].append({"name": "bert-base.search-burst",
                           "config": "bert-base", "traffic": "search-burst",
                           "chips": 1, "why": "bursts"})
    s["per_layer"].append({"name": "burst_rows.search", "unit": "rows",
                           "better": "higher", "source": "program_counter",
                           "layer": "coalescing queue",
                           "moves": "search_p95_ms",
                           "workloads": ["bert-base.search-burst"]})
    s["end_to_end"].insert(0, {"name": "search_p95_ms", "unit": "ms",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["bert-base.search-burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    mix = load_json(BENCH / "traffic" / "search-batch.json")
    mix["rate_per_s"] = 1234
    (bench / "traffic" / "search-burst.json").write_text(json.dumps(mix))
    (bench / "cells" / "bert-base.search-burst.json").write_text(
        json.dumps({"limits": {"rank_gap": 1.0}}))
    (bench / "metrics" / "burst_rows.search.py").write_text(
        "def read(layer):\n    return 7.0\n")
    cell = find_cell("bert-base.search-burst", tmp_path / "BENCHMARK.json",
                     bench)
    assert cell.traffic["rate_per_s"] == 1234
    assert cell.limits == {"rank_gap": 1.0}
    assert [m["name"] for m in cell.end_to_end] == ["search_p95_ms",
                                                    "setup_s"]
    assert "burst_rows.search" in [m["name"] for m in cell.per_layer]
    assert metric_reader("burst_rows.search", bench).read({}) == 7.0
    with pytest.raises(KeyError, match="search-burst"):
        find_cell("nope", tmp_path / "BENCHMARK.json", bench)


def test_result_line_puts_the_checks_last():
    cell = find_cell("t5-base.encode")
    out = Outcome(correct=True, attempted=10, failed=0,
                  metrics={"encode_passages_per_s": 5.0, "setup_s": 2.0},
                  memory_peak_bytes=7, chips=1,
                  checks={"rep_err": (0.01, 0.02), "order": (0.0, 0.0)})
    line = result_line(cell, out, False, "card")
    assert list(line)[-1] == "checks"
    assert line["metrics"] == {
        "encode_passages_per_s": {"value": 5.0, "unit": "passages/s"},
        "setup_s": {"value": 2.0, "unit": "s"}}
    assert line["device"] == {"platform": "gpu", "kind": "card", "count": 1,
                              "memory_peak_bytes": 7}


def test_without_a_card_no_result_and_a_nonzero_exit(tmp_path):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "t5-base.encode", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    try:
        import torch
        has_card = torch.cuda.is_available()
    except ImportError:
        has_card = False
    if has_card:
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
