"""Host time a /search dispatch spent building the answer dicts, ms a
dispatch: the program's ``serve.results`` spans over its
``serve.dispatch`` spans in the traced part (``benchmark.spans``)."""

from benchmark.spans import per_unit_ms


def read(layer: dict):
    return per_unit_ms("serve.results", "serve.dispatch")
