"""The check that no JAX, and nothing of the JAX package, was loaded: each
loaded module's top-level name (the part before the first dot) compared
whole, so the port, whose name begins with the JAX package's, passes."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "ptgnn_tpu")


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(t for t in tops if t in FORBIDDEN)
