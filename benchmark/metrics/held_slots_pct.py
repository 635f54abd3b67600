"""Share of the routed slots of real tokens that went to an expert this
card holds, %: the program's ``held_slots`` over its ``routed_slots``
counted over the window (``DRModel.graph_stats``, handed over as
``layer["graphs"]``), x 100. Left out for a program without the
counters."""


def read(layer: dict):
    graphs = layer.get("graphs") or {}
    routed = graphs.get("routed_slots")
    if not routed or "held_slots" not in graphs:
        return None
    return 100.0 * graphs["held_slots"] / routed
