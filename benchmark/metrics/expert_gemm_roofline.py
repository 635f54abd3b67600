"""The routed experts' grouped GEMM (``grouped_gemm_kernel``) against its
roofline, in %: for every batch of the traced part, the bound of its
routed-expert products at the batch's real tokens
(``arith_moe.expert_gemm_bound_s``: operations per routed slot, every
expert's weights read once a call, slot activations in and out), summed,
over the kernel's summed device time in the trace. Left out where the
trace holds no such kernel."""

import numpy as np

from benchmark import arith_moe

KERNEL = "grouped_gemm_kernel"


def read(layer: dict):
    trace = layer.get("trace")
    lengths = layer.get("traced_lengths")
    if trace is None or lengths is None or len(lengths) == 0:
        return None
    calls, seconds = trace.kernel_seconds(KERNEL)
    if calls == 0 or seconds <= 0:
        return None
    bs = layer["batch_size"]
    tokens = [int(np.sum(lengths[i:i + bs]))
              for i in range(0, len(lengths), bs)]
    bound = sum(arith_moe.expert_gemm_bound_s(layer["config"], t)[0]
                for t in tokens)
    return 100.0 * bound / seconds
