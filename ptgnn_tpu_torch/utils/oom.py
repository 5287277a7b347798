"""Device-OOM catch-and-continue: the counterpart of the JAX package's
``utils/oom.py``.

A training loop that is told to survive a device OOM skips the minibatch
that raised it and empties the CUDA cache. Three forms of the error are
recognised: ``torch.OutOfMemoryError`` (the caching allocator's, also
``torch.cuda.OutOfMemoryError``), CUDA's ``out of memory`` runtime error
(``CUDA error: out of memory``, which a kernel's host wrapper raises too,
``ops/cuda_build.check``), and cuBLAS's ``CUBLAS_STATUS_ALLOC_FAILED``.
"""
from __future__ import annotations

import logging
from contextlib import contextmanager

import torch

LOGGER = logging.getLogger(__name__)

_OOM_MARKERS = ("CUDA out of memory", "CUDA error: out of memory", "CUBLAS_STATUS_ALLOC_FAILED")


def is_oom_error(error: BaseException) -> bool:
    """Whether ``error`` is a device allocation failure."""
    if isinstance(error, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(error, RuntimeError) and any(marker in str(error) for marker in _OOM_MARKERS)


def release_cached_memory() -> None:
    """Hand the caching allocator's free blocks back to the device after an
    OOM (a no-op without CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


@contextmanager
def catch_device_oom(enabled: bool = True):
    """Swallow a device OOM raised in the block (skipping the current
    minibatch) and empty the CUDA cache; any other error propagates."""
    if not enabled:
        yield
        return
    try:
        yield
    except RuntimeError as error:
        if not is_oom_error(error):
            raise
        LOGGER.exception("A device OOM error was caught; skipping minibatch.")
        release_cached_memory()


# The reference's name, kept for discoverability.
catch_cuda_oom = catch_device_oom
