"""Host time of a training step's backward, ms a step: the program's
``train.backward`` spans over its ``train.optimizer`` spans (one a step)
in the traced part (``benchmark.spans``)."""

from benchmark.spans import per_unit_ms


def read(layer: dict):
    return per_unit_ms("train.backward", "train.optimizer")
