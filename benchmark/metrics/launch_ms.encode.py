"""Host time corpus encoding spent issuing a batch's device work (the
upload and the encoder), ms a batch: the program's ``encode.launch``
spans over its ``encode.readback`` spans (one a batch) in the traced
part (``benchmark.spans``)."""

from benchmark.spans import per_unit_ms


def read(layer: dict):
    return per_unit_ms("encode.launch", "encode.readback")
