"""Corpus encoding's share of the card's bf16 peak, in %, for a
last-token LM retriever: the FLOPs of the real tokens of the passages
encoded after the traced part, each at its own length
(``arith_moe.passage_flops``: latent attention, the dense layer, router,
routed and shared experts, causal attention; pad positions count as no
work), over those seconds. Left out for a cell without the lengths."""

from benchmark import arith, arith_moe


def read(layer: dict):
    lengths = layer.get("rest_lengths")
    if lengths is None or len(lengths) == 0 or not layer.get("window_s"):
        return None
    flops = arith_moe.passage_flops(layer["config"], lengths)
    return arith.mfu_pct(flops, layer["window_s"])
