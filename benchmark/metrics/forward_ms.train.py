"""Host time of a training step's forward (the upload, both encodes and
the loss), ms a step: the program's ``train.forward`` spans over its
``train.optimizer`` spans (one a step) in the traced part
(``benchmark.spans``)."""

from benchmark.spans import per_unit_ms


def read(layer: dict):
    return per_unit_ms("train.forward", "train.optimizer")
