"""The reader of ``packed_fill_pct.encode``: real tokens over packed
slots from the program's window counters, and nothing for a program
without them."""

import pytest

from benchmark.common import metric_reader


def test_packed_fill_reader():
    read = metric_reader("packed_fill_pct.encode").read
    graphs = {"captures": 0, "replays": 90, "eager": 1,
              "packed_tokens": 1_200_000, "packed_slots": 1_500_000,
              "packed_overflow": 1}
    assert read({"graphs": graphs}) == pytest.approx(80.0)
    assert read({"graphs": {"captures": 0, "replays": 91, "eager": 0}}) \
        is None  # the parent: no counters
    assert read({"graphs": dict(graphs, packed_slots=0)}) is None
    assert read({}) is None
