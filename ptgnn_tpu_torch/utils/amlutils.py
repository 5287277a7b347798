"""Logging configuration + optional AzureML metric forwarding
(reference: ptgnn/baseneuralmodel/utils/amlutils.py:7-39). The port's own
copy of the JAX package's ``utils/amlutils.py``.

AzureML is optional: ``log_run`` accepts a context object with a ``log``
method (e.g. azureml Run) or None, in which case metrics only reach the
standard logging handlers.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import numpy as np


def configure_logging(aml_ctx: Optional[Any] = None, rank: Optional[int] = None) -> str:
    """File (logs/full.log) + stdout handlers, rank-tagged when distributed."""
    os.makedirs("logs", exist_ok=True)
    log_path = os.path.join("logs", "full.log")
    if rank is None:
        fmt = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
    else:
        fmt = f"%(asctime)s [%(levelname)s r{rank}] %(name)s: %(message)s"
    handlers = [logging.FileHandler(log_path), logging.StreamHandler()]
    logging.basicConfig(level=logging.INFO, format=fmt, handlers=handlers, force=True)
    return log_path


def _flatten(prefix: str, metrics: Dict[str, Any], out: Dict[str, float]) -> None:
    for key, value in metrics.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            _flatten(name + "/", value, out)
        elif isinstance(value, (int, float, np.integer, np.floating)):
            out[name] = float(value)


def get_run_context() -> Optional[Any]:
    """The AzureML run context, or None when azureml is unavailable /
    running outside an AML job (reference: typilus/train.py uses
    Run.get_context())."""
    try:
        from azureml.core.run import Run  # type: ignore

        return Run.get_context()
    except Exception:  # noqa: BLE001 - azureml absent or offline run
        return None


def log_run(aml_ctx, fold: str, model, epoch: int, metrics: Dict[str, Any]) -> None:
    """Forward per-epoch metrics to an AML-style run context, if any."""
    if aml_ctx is None:
        return
    flat: Dict[str, float] = {}
    _flatten(f"{fold}/", metrics, flat)
    for name, value in flat.items():
        aml_ctx.log(name, value)
