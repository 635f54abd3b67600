"""Kernel launches per training step on the card: the profiler's
kernel events over the steps of the traced part of the window."""


def read(layer: dict):
    trace, steps = layer.get("trace"), layer.get("traced_steps")
    if trace is None or not steps:
        return None
    return trace.launches / steps
