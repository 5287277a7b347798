from ptgnn_tpu_torch.graph.messagepassing.base import (
    AbstractMessagePassingLayer,
    GraphContext,
)
from ptgnn_tpu_torch.graph.messagepassing.mlp_mp import MlpMessagePassingLayer, TypedMLP
from ptgnn_tpu_torch.graph.messagepassing.residual import (
    AbstractResidualLayer,
    ConcatResidualLayer,
    MeanResidualLayer,
)

__all__ = [
    "AbstractMessagePassingLayer",
    "AbstractResidualLayer",
    "ConcatResidualLayer",
    "GraphContext",
    "MeanResidualLayer",
    "MlpMessagePassingLayer",
    "TypedMLP",
]
