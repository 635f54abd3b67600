"""Host time a /search dispatch spent tokenizing and padding its queries,
ms a dispatch: the program's ``serve.tokenize`` spans over its
``serve.dispatch`` spans in the traced part (``benchmark.spans``)."""

from benchmark.spans import per_unit_ms


def read(layer: dict):
    return per_unit_ms("serve.tokenize", "serve.dispatch")
