from ptgnn_tpu_torch.graph.messagepassing.base import (
    AbstractMessageAggregation,
    AbstractMessagePassingLayer,
    GraphContext,
)
from ptgnn_tpu_torch.graph.messagepassing.egc import EGCMessagePassingLayer
from ptgnn_tpu_torch.graph.messagepassing.gated import GatedMessagePassingLayer
from ptgnn_tpu_torch.graph.messagepassing.global_exchange import (
    AbstractGlobalGraphExchange,
    GruGlobalStateUpdate,
)
from ptgnn_tpu_torch.graph.messagepassing.graphnorm import GraphNorm
from ptgnn_tpu_torch.graph.messagepassing.mlp_mp import MlpMessagePassingLayer, TypedMLP
from ptgnn_tpu_torch.graph.messagepassing.pna import PnaMessageAggregation
from ptgnn_tpu_torch.graph.messagepassing.residual import (
    AbstractResidualLayer,
    ConcatResidualLayer,
    LinearResidualLayer,
    MeanResidualLayer,
)
from ptgnn_tpu_torch.graph.messagepassing.selfatt import MultiHeadSelfAttentionMessagePassing

__all__ = [
    "AbstractGlobalGraphExchange",
    "AbstractMessageAggregation",
    "AbstractMessagePassingLayer",
    "AbstractResidualLayer",
    "ConcatResidualLayer",
    "EGCMessagePassingLayer",
    "GatedMessagePassingLayer",
    "GraphContext",
    "GraphNorm",
    "GruGlobalStateUpdate",
    "LinearResidualLayer",
    "MeanResidualLayer",
    "MlpMessagePassingLayer",
    "MultiHeadSelfAttentionMessagePassing",
    "PnaMessageAggregation",
    "TypedMLP",
]
