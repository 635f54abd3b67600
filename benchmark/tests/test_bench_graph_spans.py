"""The two readers of the program's ``model.graph_replay`` spans
(``benchmark.span_counts``): nothing recorded gives no value, one replay
a whole unit reads 100, a unit cut by the end of the traced part does not
count, and a program without ``models.graphs`` gives no value."""

import pytest

from benchmark import span_counts, spans
from benchmark.common import metric_reader
from openmatch_tpu_torch.utils import profiling

UNITS = {"graph_replay_pct.encode": "encode.readback",
         "graph_replay_pct.search": "serve.dispatch"}


def record(name, start, end, whole=True):
    return profiling.Record(name, float(start), float(end), None, 1, {},
                            whole)


@pytest.mark.parametrize("metric", sorted(UNITS))
def test_no_spans_give_no_value(monkeypatch, metric):
    monkeypatch.setattr(spans, "recorded", lambda: [])
    assert metric_reader(metric).read({}) is None


@pytest.mark.parametrize("metric", sorted(UNITS))
def test_one_replay_a_whole_unit_reads_100(monkeypatch, metric):
    unit = UNITS[metric]
    kept = [record("model.graph_replay", 1, 2), record(unit, 0, 3),
            record("model.graph_replay", 4, 5), record(unit, 3, 6),
            record("model.graph_replay", 7, 8),
            record(unit, 6, 9, whole=False)]
    monkeypatch.setattr(spans, "recorded", lambda: kept)
    assert metric_reader(metric).read({}) == pytest.approx(100.0)
    monkeypatch.setattr(spans, "recorded", lambda: kept[1::2])
    assert metric_reader(metric).read({}) == 0.0


@pytest.mark.parametrize("metric", sorted(UNITS))
def test_a_program_without_graphs_gives_no_value(monkeypatch, metric):
    kept = [record("model.graph_replay", 1, 2), record(UNITS[metric], 0, 3)]
    monkeypatch.setattr(spans, "recorded", lambda: kept)
    monkeypatch.setattr(span_counts, "program_has", lambda module: False)
    assert metric_reader(metric).read({}) is None
    monkeypatch.undo()
    assert not span_counts.program_has("openmatch_tpu_torch.no_such_module")
    assert span_counts.program_has("openmatch_tpu_torch.models.graphs")
