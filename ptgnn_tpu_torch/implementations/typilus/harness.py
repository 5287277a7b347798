"""Build the Graph2Class model on synthetic Typilus-schema data and produce
finalized, statically shaped minibatches."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ptgnn_tpu_torch.device import DeviceLike
from ptgnn_tpu_torch.graph.structs import BatchPadding
from ptgnn_tpu_torch.implementations.typilus.graph2class import Graph2Class, Graph2ClassModule
from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model
from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs


def small_padding(max_nodes: int = 512, max_graphs: int = 16) -> BatchPadding:
    return BatchPadding(
        max_nodes=max_nodes,
        max_edge_slots=max_nodes * 12,
        max_graphs=max_graphs,
        edge_tile=64,
        reference_budgets=(
            ("supernodes", max(64, max_nodes // 8)),
            ("token-sequence", max_nodes),
        ),
    )


def bench_graph_count(num_batches: int, max_nodes: int = 8192) -> int:
    """Synthetic graphs (mean 2500 nodes) that fill ``num_batches`` batches of
    the benchmark configuration (``train.default_padding()``)."""
    return max(32, 2 * num_batches * (max_nodes // 2500 + 1))


def build_graph2class(
    *,
    padding: BatchPadding,
    num_metadata_graphs: int = 48,
    mean_nodes: int = 60,
    max_graph_nodes: int = 200,
    hidden_state_size: int = 64,
    seed: int = 0,
    num_minibatches: int = 1,
    minibatch_size: int = 16,
    architecture: str = "mlp",
    dropout_rate: float = 0.1,
    topology: str = "random",
    device: DeviceLike = None,
) -> Tuple[Graph2Class, Graph2ClassModule, List[Dict[str, Any]]]:
    """Returns (model, module on ``device`` with seeded weights, host
    minibatches)."""
    model = create_graph2class_gnn_model(
        hidden_state_size=hidden_state_size, padding=padding,
        architecture=architecture, dropout_rate=dropout_rate,
    )

    def data():
        return synthetic_typilus_graphs(
            num_metadata_graphs, seed=seed, mean_nodes=mean_nodes,
            max_nodes=max_graph_nodes, topology=topology,
        )

    model.compute_metadata(data(), parallelize=False)
    module = model.build_neural_module(device=device, seed=seed)

    minibatches: List[Dict[str, Any]] = []
    for mb, _ in model.minibatch_iterator(
        model.tensorize_dataset(data(), parallelize=False),
        max_minibatch_size=minibatch_size,
        parallelize=False,
    ):
        minibatches.append(mb)
        if len(minibatches) >= num_minibatches:
            break
    if not minibatches:
        raise RuntimeError("synthetic data produced no minibatches")
    while len(minibatches) < num_minibatches:
        minibatches.append(minibatches[len(minibatches) % len(minibatches)])
    return model, module, minibatches
