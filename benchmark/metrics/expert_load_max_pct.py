"""The router's worst imbalance over the window, in %: in each MoE layer,
the routed slots of real tokens of its busiest expert over the mean per
expert (the program's per-expert counter, read once after the window);
the worst layer. 100 is an even load. Left out for a program without the
counter."""

import numpy as np


def read(layer: dict):
    slots = layer.get("expert_slots")
    if slots is None:
        return None
    slots = np.asarray(slots, np.float64)
    mean = slots.mean(axis=1)
    if slots.size == 0 or (mean <= 0).any():
        return None
    return float(100.0 * (slots.max(axis=1) / mean).max())
