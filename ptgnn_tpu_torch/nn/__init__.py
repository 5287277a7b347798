from ptgnn_tpu_torch.nn.layers import (
    Conv1d,
    Embedding,
    GRU,
    GRUCell,
    LayerNorm,
    Linear,
    dropout,
    gelu_exact,
)
from ptgnn_tpu_torch.nn.module import Module, init_parameters

__all__ = [
    "Conv1d",
    "Embedding",
    "GRU",
    "GRUCell",
    "LayerNorm",
    "Linear",
    "Module",
    "dropout",
    "gelu_exact",
    "init_parameters",
]
