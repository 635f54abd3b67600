"""Per-layer counts from the program's spans (``benchmark.spans``): how
many spans of one name fall to each whole unit (a dispatch, a batch).
A program that lacks the module making the spans gives no count, so a
metric read from them is left out rather than read as 0."""

from __future__ import annotations

import importlib.util
from typing import Optional

from benchmark import spans


def program_has(module: str) -> bool:
    """Whether the program under test has ``module``."""
    try:
        return importlib.util.find_spec(module) is not None
    except ImportError:
        return False


def per_unit_count(name: str, unit: str) -> Optional[float]:
    """Mean count of spans ``name`` per whole span ``unit``; the spans
    counted are those ``spans.per_unit_ms`` sums: begun no later than the
    last whole unit ended. None without a whole unit."""
    recorded = spans.recorded()
    whole = [s for s in recorded if s.name == unit and s.whole]
    if not whole:
        return None
    last = max(s.end for s in whole)
    return sum(1 for s in recorded
               if s.name == name and s.start <= last) / len(whole)
