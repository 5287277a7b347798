"""Host-side pipeline iterators: a thread-pumped bounded queue and a
streaming shuffle."""
from __future__ import annotations

import queue
import random
import threading
from typing import Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")


class _EndOfStream:
    """End-of-stream marker, detected by ``isinstance``."""


class ThreadedIterator(Iterator[T]):
    """Runs the wrapped iterator in a daemon thread with a bounded queue.
    ``close()`` stops the producer so an abandoned iterator does not leave a
    thread blocked on a full queue."""

    def __init__(self, original: Iterable[T], max_queue_size: int = 500, enabled: bool = True):
        self.__enabled = enabled
        if not enabled:
            self.__iter = iter(original)
            return
        self.__queue: queue.Queue = queue.Queue(maxsize=max_queue_size)
        self.__error: Optional[BaseException] = None
        self.__stop = threading.Event()

        def worker():
            try:
                for element in original:
                    while True:
                        if self.__stop.is_set():
                            return
                        try:
                            self.__queue.put(element, timeout=0.2)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # re-raised in the consumer
                self.__error = e
            finally:
                while not self.__stop.is_set():
                    try:
                        self.__queue.put(_EndOfStream(), timeout=0.2)
                        break
                    except queue.Full:
                        continue

        self.__thread = threading.Thread(target=worker, daemon=True)
        self.__thread.start()

    def close(self) -> None:
        """Stop the producer thread and release its queued elements."""
        if not self.__enabled:
            return
        self.__stop.set()
        try:
            while True:
                self.__queue.get_nowait()
        except queue.Empty:
            pass
        try:
            self.__queue.put_nowait(_EndOfStream())
        except queue.Full:  # pragma: no cover
            pass

    def __iter__(self):
        return self

    def __next__(self) -> T:
        if not self.__enabled:
            return next(self.__iter)
        item = self.__queue.get()
        if isinstance(item, _EndOfStream):
            if self.__error is not None:
                raise self.__error
            raise StopIteration
        return item


def shuffled_iterator(inner: Iterable[T], buffer_size: int = 500, rng: Optional[random.Random] = None) -> Iterator[T]:
    """Streaming shuffle with a bounded reservoir."""
    if rng is None:
        rng = random.Random()
    buffer = []
    for element in inner:
        if len(buffer) < buffer_size:
            buffer.append(element)
            continue
        idx = rng.randrange(buffer_size)
        yield buffer[idx]
        buffer[idx] = element
    rng.shuffle(buffer)
    yield from buffer
