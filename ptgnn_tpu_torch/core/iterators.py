"""Host-side pipeline iterators: a thread-pumped bounded queue, a bounded
queue pumped by a forked process, and a streaming shuffle."""
from __future__ import annotations

import gc
import multiprocessing as mp
import pickle
import queue
import random
import threading
import traceback
from typing import Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")

# BufferedIterator's liveness check: how often it looks at the child, and
# how long a live child may send nothing before it counts as deadlocked.
POLL_SECONDS = 1.0
STALL_SECONDS = 600.0


class _EndOfStream:
    """End-of-stream marker, detected by ``isinstance``: it pickles as an
    instance of this class, so no data element can be taken for it."""


class _WorkerError:
    """A producer's failure (its formatted traceback), carried across the
    process boundary."""

    def __init__(self, message: str):
        self.message = message


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


def _produce(q, original, collect: bool) -> None:
    """The forked producer: every element of ``original``, then the end
    marker; on a failure, the traceback instead. Each element is pickled
    here, so an element that does not pickle fails in this loop: the
    queue's feeder thread would print the error and drop the element. The
    objects inherited from the parent are frozen out of the collector
    first, which ``collect`` then turns back on."""
    gc.freeze()
    if collect:
        gc.enable()
    try:
        for element in original:
            q.put(pickle.dumps(element, protocol=pickle.HIGHEST_PROTOCOL))
        q.put(_EndOfStream())
    except BaseException:  # shipped to the consumer
        q.put(_WorkerError(traceback.format_exc()))


class BufferedIterator(Iterator[T]):
    """Runs the wrapped iterable in a forked child process, its elements
    pickled through a bounded queue, so CPU-heavy work (tensorizing) runs
    outside this process's interpreter lock.

    The child is forked from a process that may hold a CUDA context: what
    it runs must make no CUDA call (PyTorch raises on one in a forked
    child) and should stay numpy-only. The objects alive at the fork are
    frozen out of the child's garbage collector (which is off across the
    fork), so the child never runs the destructor of a CUDA object of the
    parent's. Its elements must pickle: a type defined inside a function
    does not.

    No failure of the child hangs the consumer. An exception in the child
    is re-raised here as ``RuntimeError`` with the child's traceback. A
    child that dies without its end marker (killed, or crashed in native
    code) raises "died without an end-of-stream marker" at the next
    liveness check, every ``POLL_SECONDS``. A child that lives but sends
    nothing for ``STALL_SECONDS`` (a deadlock on a lock that another
    thread held when the parent forked) is terminated and raises too.
    :meth:`close` terminates and joins the child; the end of the stream
    and an error join it."""

    def __init__(self, original: Iterable[T], max_queue_size: int = 500, enabled: bool = True):
        self.__enabled = enabled
        if not enabled:
            self.__iter = iter(original)
            return
        ctx = mp.get_context("fork")
        self.__queue = ctx.Queue(maxsize=max_queue_size)
        # The child must not collect this process's garbage: a CUDA object's
        # destructor (a CUDA graph's, an event's) would call CUDA there. The
        # collector is off across the fork, and the child freezes every
        # object it inherited before it turns its collector back on.
        collecting = gc.isenabled()
        self.__process = ctx.Process(target=_produce, args=(self.__queue, original, collecting), daemon=True)
        gc.disable()
        try:
            self.__process.start()
        finally:
            if collecting:
                gc.enable()
        self.__closed = False

    @property
    def process(self):
        """The child process (None when not enabled)."""
        return self.__process if self.__enabled else None

    def close(self) -> None:
        """Terminate the child if it still runs, join it and release the
        queue. Idempotent."""
        if not self.__enabled or self.__closed:
            return
        self.__closed = True
        if self.__process.is_alive():
            self.__process.terminate()
        self.__process.join()
        self.__queue.close()
        self.__queue.join_thread()

    def __finish(self) -> None:
        """Join a child that has sent its last item, then close."""
        self.__process.join(timeout=POLL_SECONDS)
        self.close()

    def __get(self):
        waited = 0.0
        while True:
            try:
                return self.__queue.get(timeout=POLL_SECONDS)
            except queue.Empty:
                waited += POLL_SECONDS
            if not self.__process.is_alive():
                try:  # the child may have flushed between the timeout and the check
                    return self.__queue.get_nowait()
                except queue.Empty:
                    exitcode = self.__process.exitcode
                    self.close()
                    raise RuntimeError(
                        "BufferedIterator worker process died without an end-of-stream marker "
                        f"(exitcode={exitcode}); it was likely killed or crashed in native code."
                    ) from None
            if waited >= STALL_SECONDS:
                self.close()
                raise RuntimeError(
                    f"BufferedIterator worker process sent nothing for {waited:.0f} s and was terminated; it "
                    "may have deadlocked on a lock that another thread held when the parent forked."
                )

    def __iter__(self):
        return self

    def __next__(self) -> T:
        if not self.__enabled:
            return next(self.__iter)
        if self.__closed:
            raise StopIteration
        item = self.__get()
        if isinstance(item, _WorkerError):
            self.__finish()
            raise RuntimeError("BufferedIterator worker process failed:\n" + item.message)
        if isinstance(item, _EndOfStream):
            self.__finish()
            raise StopIteration
        return pickle.loads(item)


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
