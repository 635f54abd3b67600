"""Template mini-language for query/document text construction.

The port's own copy of ``find_all_markers`` and ``fill_template`` from
``openmatch_tpu/templates.py``. Markers are written ``<name>`` and may use
dotted paths (``<meta.title>``) to descend into nested dicts. A missing
marker raises unless ``allow_not_found`` is set, in which case it becomes
the empty string (with a warning).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional


def find_all_markers(template: str) -> List[str]:
    """Return every ``<marker>`` name appearing in *template*, in order."""
    markers = []
    pos = 0
    while True:
        start = template.find("<", pos)
        if start == -1:
            break
        end = template.find(">", start)
        if end == -1:
            break
        markers.append(template[start + 1 : end])
        pos = end + 1
    return markers


def fill_template(
    template: str,
    data: Dict,
    markers: Optional[List[str]] = None,
    allow_not_found: bool = False,
) -> str:
    """Substitute ``<marker>`` occurrences in *template* with values from *data*.

    Dotted markers (``a.b.c``) walk nested dictionaries. Values are
    stringified with ``str()``.
    """
    if markers is None:
        markers = find_all_markers(template)
    for marker in markers:
        content = data
        found = True
        for level in marker.split("."):
            content = content.get(level, None) if isinstance(content, dict) else None
            if content is None:
                found = False
                break
        if not found:
            if allow_not_found:
                warnings.warn(
                    f"Marker '{marker}' not found in data; replacing with ''.",
                    RuntimeWarning,
                )
                content = ""
            else:
                raise ValueError(f"Cannot find the marker '{marker}' in the data")
        template = template.replace(f"<{marker}>", str(content))
    return template
