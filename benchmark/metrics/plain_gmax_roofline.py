"""The exact-search scoring kernel (K1, ``plain_gmax_kernel``) against
its roofline, in %: the bound of each call (every corpus row read once,
the queries in, the block maxima and their first pyramid level out, at
the service's padded batch of ``max_batch`` queries; ``benchmark.arith``)
times the calls, over the kernel's summed device time in the trace."""

from benchmark import arith

KERNEL = "plain_gmax_kernel"


def read(layer: dict):
    trace = layer.get("trace")
    if trace is None:
        return None
    calls, seconds = trace.kernel_seconds(KERNEL)
    if calls == 0 or seconds <= 0:
        return None
    bound, _ = arith.plain_gmax_call_bound_s(layer["max_batch"],
                                             layer["n_docs"], layer["dim"])
    return 100.0 * calls * bound / seconds
