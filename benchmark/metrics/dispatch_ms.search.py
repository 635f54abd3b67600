"""Mean time a dispatch of the retrieval service took to execute
(encode, search, read back, build the result dicts), ms
(``_QueueService.timeline[*].exec_s``, host clock)."""


def read(layer: dict):
    ex = [d["exec_s"] * 1e3 for d in layer.get("timeline") or []]
    return sum(ex) / len(ex) if ex else None
