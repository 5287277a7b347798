"""Dataset helpers (the subset the ported models use)."""
from __future__ import annotations

from typing import Optional, TypeVar

T = TypeVar("T")


def enforce_not_None(e: Optional[T]) -> T:
    """Narrow ``Optional[T]`` to ``T``, failing loudly on ``None``."""
    if e is None:
        raise ValueError("expected a value, got None")
    return e
