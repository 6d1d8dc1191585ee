"""Background-thread batch prefetcher (copy of
`dh3d_tpu/data/prefetch.py:24-55`).

A daemon thread keeps up to `depth` host batches ready, so that loading,
normalising and augmenting overlap the device's step.  The reference
loads serially (`core/datasets.py:25` imports tensorpack's
`PrefetchDataZMQ` and never uses it).

Given a CUDA `device`, the thread makes it its current device before it
loads: the current device is a thread's own, and the loaders count
outliers on it (`data.io.radius_counts`), so a data-parallel rank's
loader stays on the rank's card.
"""

from __future__ import annotations

import queue
import threading

import torch


class _Sentinel:
    pass


_END = _Sentinel()


class ThreadedPrefetcher:
    """Wraps an iterator; a daemon thread pre-computes up to `depth` items.

    Exceptions raised by the source iterator propagate to the consumer at
    the point of `next()`.  Iteration order is preserved.
    """

    def __init__(self, iterator, depth=2, device=None):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._iterator = iter(iterator)
        self._device = None if device is None else torch.device(device)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.set_device(self._device)
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
