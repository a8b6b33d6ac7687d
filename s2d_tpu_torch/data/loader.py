"""The evaluator's pipeline threads: the port's copy of `FinalizeThread` and
`_prefetch` from `s2d_tpu/data/loader.py`, with their deadlock-safe error
paths. The train loader waits for the train CLI (ROADMAP queue 1)."""
from __future__ import annotations

import queue
import threading
from typing import Iterator


class FinalizeThread:
    """Bounded background consumer for device->host finalize work (the
    readback + encode half of the prefetch/compute/finalize overlap the
    evaluator runs).

    Deadlock-safe error path: after the callback raises, the worker keeps
    DRAINING the queue (discarding items) until close(), so a producer
    blocked in put() always wakes; put() re-raises the worker's error
    early, and close() flushes, joins, and re-raises it."""

    _SENTINEL = object()

    def __init__(self, fn, depth: int = 2):
        self._fn = fn
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: list = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                return
            if self._err:
                continue  # failed already: just drain
            try:
                self._fn(*item)
            except BaseException as e:  # re-raised by put() and close()
                self._err.append(e)

    def put(self, *item) -> None:
        if self._err:
            raise self._err[0]
        self._q.put(item)

    def close(self) -> None:
        """Flush remaining work, join, and re-raise any worker error."""
        self._q.put(self._SENTINEL)
        self._thread.join()
        if self._err:
            raise self._err[0]


def _prefetch(it: Iterator, depth: int) -> Iterator:
    """Run `it` on a background thread, `depth` items ahead of the
    consumer; an error in `it` is re-raised on the consumer side."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side: a
            err.append(e)          # swallowed error silently truncates
        finally:                   # the dataset
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()

    def drained():
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item

    return drained()
