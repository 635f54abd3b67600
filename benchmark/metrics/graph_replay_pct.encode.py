"""Share of corpus-encoding batches whose encode replayed a CUDA graph, %:
the program's ``model.graph_replay`` spans per whole ``encode.readback``
span (one a batch) in the traced part, x 100. Left out for a program
without ``models.graphs``."""

from benchmark.span_counts import per_unit_count, program_has


def read(layer: dict):
    if not program_has("openmatch_tpu_torch.models.graphs"):
        return None
    n = per_unit_count("model.graph_replay", "encode.readback")
    return None if n is None else 100.0 * n
