from ptgnn_tpu_torch.graph.messagepassing.base import (
    AbstractMessagePassingLayer,
    GraphContext,
)
from ptgnn_tpu_torch.graph.messagepassing.gated import GatedMessagePassingLayer
from ptgnn_tpu_torch.graph.messagepassing.global_exchange import (
    AbstractGlobalGraphExchange,
    GruGlobalStateUpdate,
)
from ptgnn_tpu_torch.graph.messagepassing.mlp_mp import MlpMessagePassingLayer, TypedMLP
from ptgnn_tpu_torch.graph.messagepassing.residual import (
    AbstractResidualLayer,
    ConcatResidualLayer,
    MeanResidualLayer,
)

__all__ = [
    "AbstractGlobalGraphExchange",
    "AbstractMessagePassingLayer",
    "AbstractResidualLayer",
    "ConcatResidualLayer",
    "GatedMessagePassingLayer",
    "GraphContext",
    "GruGlobalStateUpdate",
    "MeanResidualLayer",
    "MlpMessagePassingLayer",
    "TypedMLP",
]
