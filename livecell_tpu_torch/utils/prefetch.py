"""Background-thread batch prefetching (counterpart of
livecell_tpu/utils/prefetch.py).

A single daemon thread assembles the next batches while the device is
busy (batch assembly is numpy slicing). An exception raised by the
iterator reaches the consumer after the items before it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_DONE = object()


def prefetch(it: Iterable, size: int = 2) -> Iterator:
    q: queue.Queue = queue.Queue(maxsize=size)
    err = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            q.put(_DONE)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _DONE:
            if err:
                raise err[0]
            return
        yield item
