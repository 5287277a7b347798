"""Module base and parameter initialisation.

The JAX package describes a module by ``init(key) -> params`` and
``apply(params, ...)``. Here a module is a ``torch.nn.Module`` that owns its
parameters; each parametrised module has ``reset_parameters(generator)``,
and :func:`init_parameters` walks a module tree in a fixed order with one
``torch.Generator``, so a seed gives the same weights on every device.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch


class Module(torch.nn.Module):
    """``torch.nn.Module`` plus the metrics protocol of the task modules:
    ``forward`` returns (loss, metric accumulators) and the caller sums the
    accumulators over batches before :meth:`finalize_metrics`."""

    def finalize_metrics(self, accumulated: Mapping[str, Any]) -> Dict[str, Any]:
        return dict(accumulated)


@torch.no_grad()
def init_parameters(module: torch.nn.Module, seed: int) -> None:
    """Initialise every parametrised submodule from one seeded CPU
    generator, in ``module.modules()`` order (shared submodules once)."""
    generator = torch.Generator().manual_seed(seed)
    for sub in module.modules():
        reset = getattr(sub, "reset_parameters", None)
        if reset is not None:
            reset(generator)
