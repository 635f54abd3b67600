"""Host-side batching and prefetch.

The port's own copy of ``batched`` and ``prefetch`` from
``openmatch_tpu/data/loader.py``: a plain generator plus a bounded
background prefetch thread, deterministic and single-consumer. The
producer's work on an item is a ``loader.produce`` span, the consumer's
wait for one a ``loader.wait`` span (``utils.profiling``).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, List

from ..utils.profiling import span


def batched(
    iterator: Iterable,
    batch_size: int,
    collate_fn: Callable[[List], object],
    drop_last: bool = False,
    pad_to_full: bool = False,
) -> Iterator:
    """Group examples into collated batches.

    pad_to_full repeats the last example to keep static batch shapes (used
    by encode jobs; surplus rows are sliced off by valid-count downstream).
    Yields (batch, n_valid) when pad_to_full else batch.
    """
    buf: List = []
    for ex in iterator:
        buf.append(ex)
        if len(buf) == batch_size:
            yield (collate_fn(buf), batch_size) if pad_to_full else collate_fn(buf)
            buf = []
    if buf and not drop_last:
        n_valid = len(buf)
        if pad_to_full:
            buf = buf + [buf[-1]] * (batch_size - n_valid)
            yield collate_fn(buf), n_valid
        else:
            yield collate_fn(buf)


def prefetch(iterator: Iterable, depth: int = 2) -> Iterator:
    """Run the upstream iterator in a daemon thread with a bounded queue.

    Upstream exceptions propagate to the consumer: a crashed producer must
    not look like a clean end of stream (that would silently truncate
    encode shards)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def worker():
        try:
            upstream = iter(iterator)
            while True:
                with span("loader.produce"):
                    item = next(upstream, _END)
                if item is _END:
                    break
                # bounded put with a stop check: a consumer that abandons
                # the generator must not leave this thread blocked on q.put
                # forever, pinning the upstream iterator and depth+1 batches
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 - forwarded, not swallowed
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            with span("loader.wait"):
                item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # runs on normal exhaustion, consumer break (GeneratorExit), or
        # consumer exception: release the worker either way
        stop.set()
