"""Background-thread prefetching for host data loaders (port of
gigapose_tpu/utils/prefetch.py).

One daemon thread fills a bounded queue with the loader's batches so the
trainer does not wait on PNG decoding and augmentation between steps; an
exception in the loader is raised in the consumer. The thread shares the
GIL with the trainer's own Python work. `close()` stops the thread when the
consumer leaves early.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class PrefetchIterator(Iterator[T]):
    def __init__(self, iterable: Iterable[T], buffer_size: int = 4):
        self._queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._error = None

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            it = iter(iterable)
            try:
                for item in it:
                    if not put(item):
                        break
            except BaseException as e:  # handed to the consumer, raised there
                self._error = e
            finally:
                if hasattr(it, "close"):  # a generator's own cleanup (thread pools) runs now
                    it.close()
                put(_SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> T:
        item = self._queue.get()
        if item is _SENTINEL:
            self._thread.join()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the thread (after the item it is producing) and wait for it."""
        self._stop.set()
        self._thread.join()


def prefetch(iterable: Iterable[T], buffer_size: int = 4) -> PrefetchIterator:
    return PrefetchIterator(iterable, buffer_size)
