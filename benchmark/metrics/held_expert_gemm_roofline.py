"""The held experts' grouped GEMM (``grouped_gemm_kernel``) in a cell that
holds a share of the routed experts, against its roofline, in %: in each
MoE layer, the bound of one call at the mean slots the held experts
received a traced batch (the program's per-layer ``held_slots`` counter
read after the traced part, over its batches;
``arith_kimi.held_expert_gemm_bound_s``), times the batches, summed over
the layers, over the kernel's summed device time in the trace. Only the
slots the held experts received count, never every slot a token routes.
Left out without the counter or without the kernel in the trace."""

import numpy as np

from benchmark import arith_kimi

KERNEL = "grouped_gemm_kernel"


def read(layer: dict):
    trace = layer.get("trace")
    held = layer.get("traced_held_slots")
    batches = layer.get("traced_batches")
    if trace is None or held is None or not batches:
        return None
    calls, seconds = trace.kernel_seconds(KERNEL)
    if calls == 0 or seconds <= 0:
        return None
    cfg = layer["config"]
    bound = sum(batches * arith_kimi.held_expert_gemm_bound_s(
        cfg, float(h) / batches)[0] for h in np.asarray(held, np.float64))
    return 100.0 * bound / seconds
