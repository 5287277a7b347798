"""Re-invokable dataset iterables (the subset the ported trainers use).

Training loops iterate the same dataset once per epoch, so a dataset handle
is an *iterator factory*, not a one-shot iterator.
"""
from __future__ import annotations

import random
from typing import Callable, Iterable, Iterator, List, Optional, TypeVar

T = TypeVar("T")


class LazyDataIterable(Iterable[T]):
    """A dataset handle built from a zero-argument iterator factory: each
    ``iter()`` call re-invokes the factory, so every epoch sees a fresh pass."""

    def __init__(self, base_iterable_func: Callable[[], Iterator[T]]):
        self._make_iter = base_iterable_func

    def __iter__(self) -> Iterator[T]:
        return self._make_iter()


class MemorizedDataIterable(Iterable[T]):
    """Materializes the source into RAM on the first full pass.

    The first ``iter()`` streams from the factory while recording each
    element; once that pass COMPLETES, later passes serve the recorded list
    (optionally reshuffled per epoch with ``rng``). An abandoned first pass
    does not mark the cache valid."""

    def __init__(
        self,
        base_iterable_func: Callable[[], Iterator[T]],
        shuffle: bool = False,
        rng: Optional[random.Random] = None,
    ):
        self._make_iter = base_iterable_func
        self._shuffle = shuffle
        self._rng = rng if rng is not None else random.Random()
        self._cache: Optional[List[T]] = None  # None until a pass completes

    def _record_first_pass(self) -> Iterator[T]:
        recorded: List[T] = []
        for element in self._make_iter():
            recorded.append(element)
            yield element
        self._cache = recorded

    def __iter__(self) -> Iterator[T]:
        if self._cache is None:
            return self._record_first_pass()
        if self._shuffle:
            self._rng.shuffle(self._cache)
        return iter(self._cache)

    def __call__(self) -> Iterator[T]:
        # Lets a memorized dataset stand in where a factory is expected.
        return iter(self)


def enforce_not_None(e: Optional[T]) -> T:
    """Narrow ``Optional[T]`` to ``T``, failing loudly on ``None``."""
    if e is None:
        raise ValueError("expected a value, got None")
    return e
