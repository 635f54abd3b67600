"""The per-layer metrics read from the program's spans
(``benchmark.spans``): each tiny cell run traced on the CPU reads every
one finite; whole units only; a program without the recorder gives none
and raises nothing."""

import math
import sys
import time
import types

import pytest

from benchmark import spans
from benchmark.common import find_cell, metric_reader
from benchmark.drivers import encode, search, train
from benchmark.tests.test_bench_drive import (ENCODE_LIMITS, SEARCH_LIMITS,
                                              TRAIN_LIMITS, fp32_cell)
from openmatch_tpu_torch.utils import profiling

CELLS = {"bert-base.search-batch": (search, SEARCH_LIMITS, 0.5),
         "t5-base.encode": (encode, ENCODE_LIMITS, 0.3),
         "bert-base.train": (train, TRAIN_LIMITS, 0.3)}


def span_metrics(cell: str) -> list:
    """The cell's metrics read through ``benchmark.spans``."""
    return [m["name"] for m in find_cell(cell).per_layer
            if hasattr(metric_reader(m["name"]), "per_unit_ms")]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_tiny_cell_reads_every_span_metric(cell):
    driver, limits, seconds = CELLS[cell]
    profiling.clear()
    try:
        out = driver.run(fp32_cell(cell, limits), 11, seconds, True,
                         time.time(), "cpu")
        values = {name: metric_reader(name).read(out.layer)
                  for name in span_metrics(cell)}
    finally:
        profiling.clear()
    assert out.correct, out.checks
    assert len(values) >= 3
    for name, value in values.items():
        assert value is not None and math.isfinite(value) and value >= 0, (
            name, value)


def record(name, start, end, whole=True):
    return profiling.Record(name, float(start), float(end), None, 1, {},
                            whole)


def test_only_whole_units_count(monkeypatch):
    """Two whole units and one cut by the end of the traced part: the cut
    unit and the spans that began after the last whole one are left
    out."""
    kept = [record("wait", 0, 1), record("unit", 1, 3),
            record("wait", 3, 5), record("unit", 5, 6),
            record("wait", 6.5, 7), record("unit", 7, 9, whole=False)]
    monkeypatch.setattr(spans, "recorded", lambda: kept)
    assert spans.per_unit_ms("wait", "unit") == pytest.approx(3e-3 / 2)
    assert spans.per_unit_ms("unit", "unit") == pytest.approx(3e-3 / 2)
    monkeypatch.setattr(spans, "recorded", lambda: [])
    assert spans.per_unit_ms("wait", "unit") is None


def test_a_program_without_the_recorder_gives_no_metric(monkeypatch):
    monkeypatch.setitem(sys.modules, "openmatch_tpu_torch.utils.profiling",
                        types.ModuleType("profiling"))
    for cell in CELLS:
        for name in span_metrics(cell):
            assert metric_reader(name).read({}) is None
