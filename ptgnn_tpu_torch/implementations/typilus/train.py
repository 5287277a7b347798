"""The Graph2Class model factory and its batch budgets (the training CLI
comes with the training slice)."""
from __future__ import annotations

from typing import Optional

from ptgnn_tpu_torch.graph.embedders import StrElementRepresentationModel
from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetworkModel
from ptgnn_tpu_torch.graph.messagepassing import ConcatResidualLayer, MlpMessagePassingLayer
from ptgnn_tpu_torch.graph.structs import BatchPadding
from ptgnn_tpu_torch.implementations.typilus.graph2class import Graph2Class


def default_padding(
    max_nodes: int = 8192,
    max_graphs: Optional[int] = None,
    edge_slots_per_node: float = 6.0,
) -> BatchPadding:
    """Static batch budgets: 8k-node batches at 6 edge slots per node."""
    return BatchPadding(
        max_nodes=max_nodes,
        max_edge_slots=int(max_nodes * edge_slots_per_node) // 128 * 128,
        max_graphs=max_graphs if max_graphs is not None else max(8, max_nodes // 1024),
        edge_tile=128,
        reference_budgets=typilus_reference_budgets(max_nodes),
    )


def typilus_reference_budgets(max_nodes: int) -> tuple:
    return (
        ("supernodes", max(512, max_nodes // 16)),
        ("token-sequence", max_nodes),
    )


def create_graph2class_gnn_model(
    hidden_state_size: int = 64,
    dropout_rate: float = 0.1,
    padding: Optional[BatchPadding] = None,
    architecture: str = "mlp",
    min_freq_threshold: int = 5,
) -> Graph2Class:
    """The benchmark 'mlp' architecture: 12 stack entries, 8 MLP-MP layers
    with max aggregation and target-state input, two concat residuals."""
    if architecture != "mlp":
        raise NotImplementedError(f"architecture {architecture!r} is not ported yet")
    padding = padding if padding is not None else default_padding()

    def create_mlp_mp_layers(num_edges: int):
        def mlp_mp(input_dim: int, message_dim: int):
            return MlpMessagePassingLayer(
                input_state_dimension=input_dim,
                message_dimension=message_dim,
                output_state_dimension=hidden_state_size,
                num_edge_types=num_edges,
                message_aggregation_function="max",
                dropout_rate=dropout_rate,
            )

        h = hidden_state_size
        r1 = ConcatResidualLayer(h)
        r2 = ConcatResidualLayer(h)
        return [
            r1.pass_through_dummy_layer(),
            mlp_mp(h, h), mlp_mp(h, h), mlp_mp(h, h),
            r1,
            mlp_mp(2 * h, 2 * h),
            r2.pass_through_dummy_layer(),
            mlp_mp(h, h), mlp_mp(h, h), mlp_mp(h, h),
            r2,
            mlp_mp(2 * h, 2 * h),
        ]

    return Graph2Class(
        gnn_model=GraphNeuralNetworkModel(
            node_representation_model=StrElementRepresentationModel(
                embedding_size=hidden_state_size,
                token_splitting="subtoken",
                subtoken_combination="mean",
                vocabulary_size=10000,
                min_freq_threshold=min_freq_threshold,
                dropout_rate=dropout_rate,
            ),
            message_passing_layer_creator=create_mlp_mp_layers,
            padding=padding,
            max_nodes_per_graph=100000,
            max_graph_edges=500000,
            introduce_backwards_edges=True,
            add_self_edges=True,
            stop_extending_minibatch_after_num_nodes=min(120000, padding.max_nodes),
        ),
        max_num_classes=100,
    )
