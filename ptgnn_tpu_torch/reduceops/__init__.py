from ptgnn_tpu_torch.reduceops.varsizedsummary import (
    AbstractVarSizedElementReduce,
    ElementsToSummaryRepresentationInput,
    MultiheadSelfAttentionVarSizedElementReduce,
    NormalizedWeightsVarSizedElementReduce,
    SelfAttentionVarSizedElementReduce,
    SimpleVarSizedElementReduce,
    WeightedSumVarSizedElementReduce,
)

__all__ = [
    "AbstractVarSizedElementReduce",
    "ElementsToSummaryRepresentationInput",
    "MultiheadSelfAttentionVarSizedElementReduce",
    "NormalizedWeightsVarSizedElementReduce",
    "SelfAttentionVarSizedElementReduce",
    "SimpleVarSizedElementReduce",
    "WeightedSumVarSizedElementReduce",
]
