from ptgnn_tpu_torch.core.data import (
    LazyDataIterable,
    MemorizedDataIterable,
    ShardedLazyDataIterable,
    enforce_not_None,
)
from ptgnn_tpu_torch.core.metrics import MetricsAccumulator
from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.core.trainer import AbstractScheduler, EndOfEpochHook, ModelTrainer

__all__ = [
    "AbstractNeuralModel",
    "AbstractScheduler",
    "EndOfEpochHook",
    "LazyDataIterable",
    "MemorizedDataIterable",
    "MetricsAccumulator",
    "ModelTrainer",
    "ShardedLazyDataIterable",
    "enforce_not_None",
]
