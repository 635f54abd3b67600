"""Time training waited on its prefetch thread for a batch, ms a step: the
program's ``loader.wait`` spans over its ``train.optimizer`` spans (one a
step) in the traced part (``benchmark.spans``)."""

from benchmark.spans import per_unit_ms


def read(layer: dict):
    return per_unit_ms("loader.wait", "train.optimizer")
