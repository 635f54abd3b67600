"""Share of the traced window with no kernel, copy or set running on the
card, in %: the profiler's device events."""

from benchmark.tracing import idle_pct


def read(layer: dict):
    return idle_pct(layer.get("trace"))
