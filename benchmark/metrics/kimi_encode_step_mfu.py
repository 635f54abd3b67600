"""Corpus encoding's share of the card's bf16 peak, in %, for a
Kimi-Linear retriever: the FLOPs of the documents encoded after the
traced part, each at its own length (``arith_kimi.document_flops``: the
KDA layers with their recurrence, the latent attention with its causal
core, the dense layer, the router and shared expert, and the slots the
held experts received, by the program's counter), over those seconds.
Left out without the lengths or the counter."""

from benchmark import arith, arith_kimi


def read(layer: dict):
    lengths = layer.get("rest_lengths")
    held = layer.get("rest_held_slots")
    if lengths is None or len(lengths) == 0 or held is None \
            or not layer.get("window_s"):
        return None
    flops = arith_kimi.document_flops(layer["config"], lengths, held)
    return arith.mfu_pct(flops, layer["window_s"])
