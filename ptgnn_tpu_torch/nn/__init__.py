from ptgnn_tpu_torch.nn.layers import (
    Embedding,
    LayerNorm,
    Linear,
    dropout,
    gelu_exact,
)
from ptgnn_tpu_torch.nn.module import Module, init_parameters

__all__ = [
    "Embedding",
    "LayerNorm",
    "Linear",
    "Module",
    "dropout",
    "gelu_exact",
    "init_parameters",
]
