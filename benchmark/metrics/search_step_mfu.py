"""The serving step's share of the card's bf16 peak, in %: the FLOPs of
the query rows the window's dispatches carried (each row's encoder pass
at q_max_len and its scores against every document; ``benchmark.arith``)
over the dispatches' summed execution time."""

from benchmark import arith


def read(layer: dict):
    tl = layer.get("timeline") or []
    busy = sum(d["exec_s"] for d in tl)
    if not tl or busy <= 0:
        return None
    rows = sum(d["rows"] for d in tl)
    flops = rows * arith.search_query_flops(layer["config"],
                                            layer["q_max_len"],
                                            layer["n_docs"])
    return arith.mfu_pct(flops, busy)
