"""Mean number of query rows a dispatch of the coalescing queue carried
over the window (``_QueueService.timeline[*].rows``)."""


def read(layer: dict):
    rows = [d["rows"] for d in layer.get("timeline") or []]
    return sum(rows) / len(rows) if rows else None
