"""Metric accumulation across steps.

Each step returns a dict of scalar *accumulators* (counts, sums); the
trainer sums them across steps and the task module's ``finalize_metrics``
turns the sums into reported values. Sums of device tensors stay on the
device until :meth:`MetricsAccumulator.totals` reads them, so a step adds no
host synchronisation.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch


class MetricsAccumulator:
    def __init__(self):
        self._sums: Dict[str, Any] = {}

    def update(self, step_metrics: Mapping[str, Any]) -> None:
        for key, value in step_metrics.items():
            if isinstance(value, torch.Tensor):
                value = value.detach().to(torch.float64)
            else:
                value = float(value)
            self._sums[key] = self._sums[key] + value if key in self._sums else value

    def totals(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self._sums.items()}

    def __len__(self) -> int:
        return len(self._sums)
