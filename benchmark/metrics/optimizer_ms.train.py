"""Host time of a training step's optimizer (the reduction over ranks,
the update and the schedule), ms a step: the program's
``train.optimizer`` spans in the traced part (``benchmark.spans``)."""

from benchmark.spans import per_unit_ms


def read(layer: dict):
    return per_unit_ms("train.optimizer", "train.optimizer")
