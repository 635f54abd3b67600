"""A training step's share of one card's bf16 peak, in %: forward and
backward FLOPs of the batch's queries and passages at their padded
lengths and of the loss (``benchmark.arith``), times the window's steps,
over the window's seconds."""

from benchmark import arith


def read(layer: dict):
    if not layer.get("steps"):
        return None
    cfg = layer["config"]
    q = layer["queries"]
    flops = arith.dr_train_step_flops(cfg, q, q * layer["passages_per_query"],
                                      cfg["dr"]["q_max_len"],
                                      cfg["dr"]["p_max_len"])
    return arith.mfu_pct(layer["steps"] * flops, layer["elapsed"])
