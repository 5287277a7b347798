from ptgnn_tpu_torch.nn.layers import (
    MLP,
    Activation,
    Conv1d,
    Embedding,
    GRU,
    GRUCell,
    LayerNorm,
    Linear,
    dropout,
    gelu_exact,
    get_activation,
)
from ptgnn_tpu_torch.nn.module import Module, init_parameters

__all__ = [
    "Activation",
    "Conv1d",
    "Embedding",
    "GRU",
    "GRUCell",
    "LayerNorm",
    "Linear",
    "MLP",
    "Module",
    "dropout",
    "gelu_exact",
    "get_activation",
    "init_parameters",
]
