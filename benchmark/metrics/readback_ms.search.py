"""Host time a /search dispatch spent reading back scores and indices
(waiting on the card), ms a dispatch: the program's ``serve.readback``
spans over its ``serve.dispatch`` spans in the traced part
(``benchmark.spans``)."""

from benchmark.spans import per_unit_ms


def read(layer: dict):
    return per_unit_ms("serve.readback", "serve.dispatch")
