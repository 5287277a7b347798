from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetwork, GraphNeuralNetworkModel
from ptgnn_tpu_torch.graph.structs import (
    AbstractNodeEmbedder,
    AdjacencyStruct,
    BatchPadding,
    GnnOutput,
    GraphBatch,
    GraphData,
    ReferenceSet,
    TensorizedGraphData,
)

__all__ = [
    "AbstractNodeEmbedder",
    "AdjacencyStruct",
    "BatchPadding",
    "GnnOutput",
    "GraphBatch",
    "GraphData",
    "GraphNeuralNetwork",
    "GraphNeuralNetworkModel",
    "ReferenceSet",
    "TensorizedGraphData",
]
