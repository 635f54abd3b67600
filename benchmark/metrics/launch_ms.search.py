"""Host time a /search dispatch spent issuing device work (the upload, the
query encoder and the search), ms a dispatch: the program's
``serve.launch`` spans over its ``serve.dispatch`` spans in the traced
part (``benchmark.spans``)."""

from benchmark.spans import per_unit_ms


def read(layer: dict):
    return per_unit_ms("serve.launch", "serve.dispatch")
