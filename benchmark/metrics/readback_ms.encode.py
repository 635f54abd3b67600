"""Host time corpus encoding spent reading a batch's reps back (waiting
on the card), ms a batch: the program's ``encode.readback`` spans in
the traced part (``benchmark.spans``)."""

from benchmark.spans import per_unit_ms


def read(layer: dict):
    return per_unit_ms("encode.readback", "encode.readback")
