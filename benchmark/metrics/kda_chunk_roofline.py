"""K13, the chunked KDA forward (its two kernels,
``kda_chunk_prep_kernel`` and ``kda_chunk_kernel``), against its
roofline, in %: for every batch of the traced part, the bound of one KDA
layer at the batch's real tokens (``arith_kimi.kda_chunk_bound_s``: q, k,
v, g and beta read once, o written once, the recurrence's operations)
times the KDA layers, summed, over the kernels' summed device time in the
trace. Left out where the trace holds no such kernel."""

import numpy as np

from benchmark import arith_kimi

KERNEL = "kda_chunk"  # both kernels' names hold it


def read(layer: dict):
    trace = layer.get("trace")
    lengths = layer.get("traced_lengths")
    if trace is None or lengths is None or len(lengths) == 0:
        return None
    calls, seconds = trace.kernel_seconds(KERNEL)
    if calls == 0 or seconds <= 0:
        return None
    cfg = layer["config"]
    layers = len(cfg["linear_attn_config"]["kda_layers"])
    bs = layer["batch_size"]
    bound = sum(layers * arith_kimi.kda_chunk_bound_s(
        cfg, float(np.sum(lengths[i:i + bs])))[0]
        for i in range(0, len(lengths), bs))
    return 100.0 * bound / seconds
