"""Background-thread batch prefetcher (copy of
`dh3d_tpu/data/prefetch.py:24-55`).

A daemon thread keeps up to `depth` host batches ready, so that loading,
normalising and augmenting overlap the device's step.  The reference
loads serially (`core/datasets.py:25` imports tensorpack's
`PrefetchDataZMQ` and never uses it).
"""

from __future__ import annotations

import queue
import threading


class _Sentinel:
    pass


_END = _Sentinel()


class ThreadedPrefetcher:
    """Wraps an iterator; a daemon thread pre-computes up to `depth` items.

    Exceptions raised by the source iterator propagate to the consumer at
    the point of `next()`.  Iteration order is preserved.
    """

    def __init__(self, iterator, depth=2):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._iterator = iter(iterator)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._iterator:
                self._queue.put(item)
        except BaseException as e:  # propagate to the consumer
            self._queue.put(e)
            return
        self._queue.put(_END)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _END:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item
