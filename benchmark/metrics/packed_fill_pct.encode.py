"""Share of the packed stream's slots that held a real token, %: the
program's ``packed_tokens`` over its ``packed_slots`` counted over the
window (``DRModel.graph_stats``, handed over as ``layer["graphs"]``),
x 100. Left out for a program without the counters."""


def read(layer: dict):
    graphs = layer.get("graphs") or {}
    slots = graphs.get("packed_slots")
    if not slots or "packed_tokens" not in graphs:
        return None
    return 100.0 * graphs["packed_tokens"] / slots
