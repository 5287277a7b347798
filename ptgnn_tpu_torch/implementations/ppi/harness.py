"""Build the PPI model on synthetic PPI-like graphs and produce finalized,
statically shaped minibatches (for tests, ``chip_smoke.py`` and the
profiler). The step loop is ``implementations.typilus.harness.train_steps``.

:func:`build_edge_feature_gnn` builds the library's generic engine with
edge features (a feature embedder for the edges too) at PPI's width and
layout, on :func:`synthetic_edge_feature_graphs`."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.device import DeviceLike, resolve_device
from ptgnn_tpu_torch.graph.embedders import FeatureRepresentationModel
from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetwork, GraphNeuralNetworkModel
from ptgnn_tpu_torch.graph.messagepassing import GatedMessagePassingLayer, MlpMessagePassingLayer
from ptgnn_tpu_torch.graph.structs import BatchPadding, GraphBatch, GraphData
from ptgnn_tpu_torch.nn.module import Module, init_parameters
from ptgnn_tpu_torch.implementations.ppi.dataloader import PPIGraphSample
from ptgnn_tpu_torch.implementations.ppi.ppi import PPIClassification, PPIMulticlassClassification
from ptgnn_tpu_torch.implementations.ppi.train import create_ppi_gnn_model
from ptgnn_tpu_torch.utils.synthetic import synthetic_ppi_graphs

# The published PPI dataset's sizes: 50 features, 121 labels, about 2,372
# nodes and 34k edges (14.4 per node) per graph.
PPI_GRAPH_SIZES = dict(mean_nodes=2372, edges_per_node=14.4, num_features=50, num_labels=121)


def synthetic_ppi_samples(num_graphs: int, seed: int = 0, **sizes) -> List[PPIGraphSample]:
    """``synthetic_ppi_graphs(num_graphs, seed, **sizes)`` as samples."""
    return [PPIGraphSample.from_synthetic(g) for g in synthetic_ppi_graphs(num_graphs, seed=seed, **sizes)]


def build_ppi(
    *,
    padding: BatchPadding,
    samples: List[PPIGraphSample],
    hidden_state_size: int = 256,
    seed: int = 0,
    minibatch_size: int = 50,
    device: DeviceLike = None,
) -> Tuple[PPIMulticlassClassification, PPIClassification, List[Dict[str, Any]]]:
    """Returns (model with metadata from ``samples``, module on ``device``
    with seeded weights, the host minibatches of ``samples``)."""
    model = create_ppi_gnn_model(hidden_state_size=hidden_state_size, padding=padding)
    model.compute_metadata(iter(samples), parallelize=False)
    module = model.build_neural_module(device=device, seed=seed)
    minibatches = [
        mb for mb, _ in model.minibatch_iterator(
            model.tensorize_dataset(iter(samples), parallelize=False),
            max_minibatch_size=minibatch_size, parallelize=False,
        )
    ]
    if not minibatches:
        raise RuntimeError("the samples produced no minibatches")
    return model, module, minibatches


# ---------------------------------------------------------------------------
# The generic engine with edge features, at PPI's width and layout
# ---------------------------------------------------------------------------

EDGE_FEATURE_WIDTH = 4  # seeded floats per forward edge


def synthetic_edge_feature_graphs(num_graphs: int, seed: int = 0, edge_feature_width: int = EDGE_FEATURE_WIDTH,
                                  **sizes) -> List[GraphData]:
    """``synthetic_ppi_graphs(num_graphs, seed, **sizes)`` as GraphData: the
    node features, the one edge type, and ``edge_feature_width`` normal floats
    per edge from their own generator (seeded from ``seed``)."""
    rng = np.random.RandomState(seed + 7919)
    out = []
    for g in synthetic_ppi_graphs(num_graphs, seed=seed, **sizes):
        feats = rng.randn(len(g["edges"]), edge_feature_width).astype(np.float32)
        out.append(GraphData(node_information=list(g["features"]), edges={"e0": g["edges"]}, reference_nodes={},
                             edge_features={"e0": list(feats)}))
    return out


class EdgeFeatureStackCreator:
    """Five MLP-MP layers at state ``hidden_state_size`` with sum aggregation,
    target-state message input and ``features_dimension`` edge-feature
    columns (so a message input of 2 x hidden + features), each with PPI's
    output dropout 0.2; with ``gated``, a gated layer (message width hidden,
    ``edge_feature_dimension`` = features, dropout 0.2) in place of the last.
    A class, not a closure, so a model that holds it pickles."""

    def __init__(self, hidden_state_size: int, features_dimension: int, gated: bool = False):
        self.hidden_state_size = hidden_state_size
        self.features_dimension = features_dimension
        self.gated = gated

    def __call__(self, num_edges: int):
        h, f = self.hidden_state_size, self.features_dimension
        layers = [MlpMessagePassingLayer(h, h, h, num_edges, "sum", features_dimension=f, dropout_rate=0.2)
                  for _ in range(5)]
        if self.gated:
            layers[-1] = GatedMessagePassingLayer(h, h, num_edges, "sum", dropout_rate=0.2, edge_feature_dimension=f)
        return layers


class NodeStatesModule(Module):
    """The GNN alone; its loss is the sum of squares of the real nodes'
    output states (a stand-in head with no weights of its own)."""

    def __init__(self, gnn: GraphNeuralNetwork):
        super().__init__()
        self.gnn = gnn

    def forward(self, batch: GraphBatch, *, train: bool = False, generator: Optional[torch.Generator] = None):
        out, metrics = self.gnn(batch, train=train, generator=generator)
        states = out.output_node_representations.float()
        loss = torch.where(out.node_mask[:, None], states * states, torch.zeros((), device=states.device)).sum()
        return loss, metrics


class NodeStatesModel(AbstractNeuralModel):
    """The lifecycle of a GraphNeuralNetworkModel over GraphData (edge
    features included), with :class:`NodeStatesModule` as its module."""

    def __init__(self, gnn_model: GraphNeuralNetworkModel):
        super().__init__()
        self.__gnn_model = gnn_model

    @property
    def gnn_model(self) -> GraphNeuralNetworkModel:
        return self.__gnn_model

    def update_metadata_from(self, datapoint: GraphData) -> None:
        self.__gnn_model.update_metadata_from(datapoint)

    def build_neural_module(self, device: DeviceLike = None, seed: int = 0) -> NodeStatesModule:
        device = resolve_device(device)
        module = NodeStatesModule(self.__gnn_model.build_neural_module())
        init_parameters(module, seed)
        return module.to(device)

    def tensorize(self, datapoint: GraphData):
        return self.__gnn_model.tensorize(datapoint)

    def initialize_minibatch(self) -> Dict[str, Any]:
        return self.__gnn_model.initialize_minibatch()

    def can_add_to_minibatch(self, tensorized, partial_minibatch) -> bool:
        return self.__gnn_model.can_add_to_minibatch(tensorized, partial_minibatch)

    def extend_minibatch_with(self, tensorized, partial_minibatch) -> bool:
        return self.__gnn_model.extend_minibatch_with(tensorized, partial_minibatch)

    def finalize_minibatch(self, accumulated_minibatch_data: Dict[str, Any]) -> Dict[str, Any]:
        return self.__gnn_model.finalize_minibatch(accumulated_minibatch_data)


def build_edge_feature_gnn(
    *,
    padding: BatchPadding,
    graphs: List[GraphData],
    hidden_state_size: int = 256,
    edge_embedding_size: int = 128,
    gated: bool = False,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[NodeStatesModel, NodeStatesModule, List[Dict[str, Any]]]:
    """The generic engine with edge features at PPI's layout: feature
    embedders for the nodes (``hidden_state_size``) and the edges
    (``edge_embedding_size``), :class:`EdgeFeatureStackCreator`'s stack,
    backward and self edges, batches of up to 3000 nodes. Returns (model
    with metadata from ``graphs``, module on ``device`` with seeded weights,
    the host minibatches of ``graphs``)."""
    model = NodeStatesModel(GraphNeuralNetworkModel(
        node_representation_model=FeatureRepresentationModel(embedding_size=hidden_state_size, activation="tanh"),
        edge_representation_model=FeatureRepresentationModel(embedding_size=edge_embedding_size),
        message_passing_layer_creator=EdgeFeatureStackCreator(hidden_state_size, edge_embedding_size, gated),
        padding=padding,
        introduce_backwards_edges=True,
        add_self_edges=True,
        stop_extending_minibatch_after_num_nodes=3000,
    ))
    model.compute_metadata(iter(graphs), parallelize=False)
    module = model.build_neural_module(device=device, seed=seed)
    minibatches = [mb for mb, _ in model.minibatch_iterator(
        model.tensorize_dataset(iter(graphs), parallelize=False), max_minibatch_size=50, parallelize=False)]
    if not minibatches:
        raise RuntimeError("the graphs produced no minibatches")
    return model, module, minibatches
