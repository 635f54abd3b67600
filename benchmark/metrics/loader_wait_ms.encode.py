"""Time corpus encoding waited on its prefetch thread for a batch, ms a
batch: the program's ``loader.wait`` spans over its ``encode.readback``
spans (one a batch) in the traced part (``benchmark.spans``)."""

from benchmark.spans import per_unit_ms


def read(layer: dict):
    return per_unit_ms("loader.wait", "encode.readback")
