"""Per-layer metrics from the program's own spans
(``openmatch_tpu_torch.utils.profiling``): the program records a span
only while a profiler records, so in a ``--trace 1`` run the recorder
holds the spans of the traced part and nothing else. A program without
the recorder gives no spans, and each metric read from them is left out.
"""

from __future__ import annotations

from typing import Optional


def recorded() -> list:
    try:
        from openmatch_tpu_torch.utils.profiling import recorded as spans
    except ImportError:
        return []
    return spans()


def per_unit_ms(name: str, unit: str) -> Optional[float]:
    """Mean summed duration of the spans ``name`` per span ``unit`` (a
    dispatch, a batch or a step), ms; None without a whole unit.

    A span is kept only if tracing was on when it began, so a unit that
    the end of the traced part cut may lack spans: only units that ended
    while tracing was on count (``whole``). The spans ``name`` counted
    are those that began no later than the last of them ended: the units'
    own, and the work that led up to each (the loader's wait for a batch
    before it)."""
    spans = recorded()
    whole = [s for s in spans if s.name == unit and s.whole]
    if not whole:
        return None
    last = max(s.end for s in whole)
    total_us = sum(s.end - s.start for s in spans
                   if s.name == name and s.start <= last)
    return total_us * 1e-3 / len(whole)
