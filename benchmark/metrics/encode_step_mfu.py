"""Corpus encoding's share of the card's bf16 peak, in %: the T5
encoder's and decoder step's FLOPs for every passage encoded, at the
padded p_max_len (``benchmark.arith``), over the window's seconds."""

from benchmark import arith


def read(layer: dict):
    if not layer.get("passages"):
        return None
    flops = layer["passages"] * arith.t5_encdec_step_flops(layer["config"],
                                                          layer["p_len"])
    return arith.mfu_pct(flops, layer["window_s"])
