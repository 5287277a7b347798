"""The message-passing GNN engine and its host-side model.

The module runs over a statically shaped GraphBatch: backward and self
edges are materialized by the batcher, residual layers compose through an
explicit stash. Edge dropout is one keep mask over the fused edge array,
ANDed with the batch's static mask while training. Edge features, where the
model has an edge representation model, are embedded once per forward edge
and gathered to every slot by ``edge_feature_slot``: a backward edge reads
its forward edge's row, a self or padding slot gets zeros.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ptgnn_tpu_torch.core.data import enforce_not_None
from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.graph.batching import GraphBatcher, materialized_edge_type_count
from ptgnn_tpu_torch.graph.messagepassing.base import AbstractMessagePassingLayer, GraphContext
from ptgnn_tpu_torch.graph.messagepassing.residual import (
    AbstractResidualLayer,
    _ResidualOriginLayer,
)
from ptgnn_tpu_torch.graph.structs import (
    BatchPadding,
    GnnOutput,
    GraphBatch,
    GraphData,
    TensorizedGraphData,
)

LOGGER = logging.getLogger(__name__)


class GraphNeuralNetwork(torch.nn.Module):
    """A generic message-passing GNN with discrete edge types."""

    def __init__(
        self,
        message_passing_layers: List[AbstractMessagePassingLayer],
        node_embedder: torch.nn.Module,
        edge_dropout_rate: float = 0.0,
        edge_feature_embedder: Optional[torch.nn.Module] = None,
    ):
        super().__init__()
        if not 0.0 <= edge_dropout_rate < 1.0:
            raise ValueError(f"edge_dropout_rate {edge_dropout_rate} is not in [0, 1)")
        self.edge_dropout_rate = edge_dropout_rate
        # A layer object used at several positions shares its parameters.
        self.message_passing_layers = torch.nn.ModuleList(message_passing_layers)
        self._layer_param_index: List[int] = []
        seen: Dict[int, int] = {}
        for layer in message_passing_layers:
            self._layer_param_index.append(seen.setdefault(id(layer), len(seen)))
        self.node_embedder = node_embedder
        self.edge_feature_embedder = edge_feature_embedder

    @property
    def input_node_state_dim(self) -> int:
        return self.message_passing_layers[0].input_state_dimension

    @property
    def output_node_state_dim(self) -> int:
        return self.message_passing_layers[-1].output_state_dimension

    def gnn(self, node_representations, ctx: GraphContext, *, train: bool = False,
            generator: Optional[torch.Generator] = None, return_all_states: bool = False) -> torch.Tensor:
        """Run the message-passing layer stack; with ``return_all_states``,
        the input and every entry's output concatenated on the last dim."""
        if self.edge_dropout_rate > 0 and train:
            if generator is None:
                raise ValueError("edge dropout during training needs a torch.Generator")
            mask = ctx.adjacency.mask
            keep = torch.rand(mask.shape, generator=generator, device=mask.device) < 1.0 - self.edge_dropout_rate
            ctx = ctx._replace(adjacency=ctx.adjacency._replace(mask=mask & keep), edge_mask_is_static=False)
        all_states = [node_representations] if return_all_states else None
        stash: Dict[int, torch.Tensor] = {}
        for layer in self.message_passing_layers:
            if isinstance(layer, _ResidualOriginLayer):
                stash[id(layer.target_layer)] = node_representations
            elif isinstance(layer, AbstractResidualLayer):
                original = stash.pop(id(layer))
                node_representations = layer.combine(original, node_representations, train=train)
            else:
                node_representations = layer(node_representations, ctx, train=train, generator=generator)
            if return_all_states:
                all_states.append(node_representations)
        if return_all_states:
            return torch.cat(all_states, dim=-1)
        return node_representations

    def forward(
        self, batch: GraphBatch, *, train: bool = False, generator: Optional[torch.Generator] = None,
        return_all_states: bool = False,
    ) -> Tuple[GnnOutput, Dict[str, Any]]:
        """Returns (GnnOutput, metric accumulators). ``generator`` draws every
        dropout mask when training."""
        initial = self.node_embedder(**batch.node_data, train=train, generator=generator)  # [N_pad, D]
        edge_features = None
        if self.edge_feature_embedder is not None and batch.edge_feature_data is not None:
            embedded = self.edge_feature_embedder(
                **batch.edge_feature_data, train=train, generator=generator
            )  # [max_edge_slots, F], one row per forward edge
            slot = batch.adjacency.edge_feature_slot
            gathered = embedded.index_select(0, slot.clamp_min(0).long())
            edge_features = torch.where(slot[:, None] >= 0, gathered, torch.zeros((), dtype=gathered.dtype,
                                                                                  device=gathered.device))
        ctx = GraphContext(
            adjacency=batch.adjacency,
            node_graph=batch.node_graph,
            node_mask=batch.node_mask,
            graph_mask=batch.graph_mask,
            references=batch.references,
            att_order=batch.att_order,
            edge_features=edge_features,
        )
        output = self.gnn(initial, ctx, train=train, generator=generator, return_all_states=return_all_states)
        metrics = {
            "num_graphs": batch.num_graphs,
            "num_nodes": batch.num_nodes,
            "num_edges": batch.num_edges,
        }
        gnn_out = GnnOutput(
            input_node_representations=initial,
            output_node_representations=output,
            node_to_graph_idx=batch.node_graph,
            node_mask=batch.node_mask,
            node_idx_references={n: r.node_ids for n, r in batch.references.items()},
            node_graph_idx_reference={n: r.graph_ids for n, r in batch.references.items()},
            reference_masks={n: r.mask for n, r in batch.references.items()},
            num_graphs=batch.num_graphs,
            graph_mask=batch.graph_mask,
        )
        return gnn_out, metrics


class GraphNeuralNetworkModel(AbstractNeuralModel):
    """Tensorization + static batching for graphs."""

    def __init__(
        self,
        *,
        node_representation_model: AbstractNeuralModel,
        message_passing_layer_creator: Callable[[int], List[AbstractMessagePassingLayer]],
        padding: BatchPadding,
        max_nodes_per_graph: int = 80000,
        max_graph_edges: int = 100000,
        introduce_backwards_edges: bool = True,
        stop_extending_minibatch_after_num_nodes: Optional[int] = None,
        add_self_edges: bool = False,
        edge_dropout_rate: float = 0.0,
        edge_representation_model: Optional[AbstractNeuralModel] = None,
    ):
        super().__init__()
        self.__message_passing_layers_creator = message_passing_layer_creator
        self.__node_embedding_model = node_representation_model
        self.__edge_embedding_model = edge_representation_model
        self.padding = padding
        self.max_nodes_per_graph = min(max_nodes_per_graph, padding.max_nodes)
        self.max_graph_edges = max_graph_edges
        self.introduce_backwards_edges = introduce_backwards_edges
        self.stop_extending_minibatch_after_num_nodes = (
            stop_extending_minibatch_after_num_nodes
            if stop_extending_minibatch_after_num_nodes is not None
            else padding.max_nodes
        )
        self.add_self_edges = add_self_edges
        self.edge_dropout_rate = edge_dropout_rate

    @property
    def node_embedding_model(self) -> AbstractNeuralModel:
        return self.__node_embedding_model

    @property
    def edge_embedding_model(self) -> Optional[AbstractNeuralModel]:
        return self.__edge_embedding_model

    def initialize_metadata(self) -> None:
        self.__edge_types_mdata: Set[str] = set()
        self.__reference_names_mdata: Set[str] = set()

    def update_metadata_from(self, datapoint: GraphData) -> None:
        for node in datapoint.node_information:
            self.__node_embedding_model.update_metadata_from(node)
        self.__edge_types_mdata.update(datapoint.edges)
        self.__reference_names_mdata.update(datapoint.reference_nodes)
        if datapoint.edge_features is not None and self.__edge_embedding_model is not None:
            for edge_features in datapoint.edge_features.values():
                for edge_feature in edge_features:
                    self.__edge_embedding_model.update_metadata_from(edge_feature)

    def finalize_metadata(self) -> None:
        LOGGER.info("Found %s edge types in data.", len(self.__edge_types_mdata))
        self.__edge_idx_to_type = tuple(sorted(self.__edge_types_mdata))
        self.__edge_types = {e: i for i, e in enumerate(self.__edge_idx_to_type)}
        self.__reference_names = tuple(sorted(self.__reference_names_mdata))
        del self.__edge_types_mdata
        del self.__reference_names_mdata

    @property
    def _num_edge_types(self) -> int:
        return materialized_edge_type_count(
            len(self.__edge_types),
            introduce_backwards_edges=self.introduce_backwards_edges,
            add_self_edges=self.add_self_edges,
        )

    @property
    def edge_type_names(self) -> Tuple[str, ...]:
        return self.__edge_idx_to_type

    @property
    def reference_names(self) -> Tuple[str, ...]:
        return self.__reference_names

    def build_neural_module(self) -> GraphNeuralNetwork:
        """A new (uninitialised, CPU) GNN module with layers of its own; the
        root model initialises and places it."""
        layers = self.__message_passing_layers_creator(self._num_edge_types)
        for layer in layers:
            declared = getattr(layer, "num_edge_types", None)
            if declared is not None and declared != self._num_edge_types:
                raise ValueError(
                    f"layer {type(layer).__name__} was built for {declared} edge "
                    f"types but the batch materializes {self._num_edge_types}"
                )
        return GraphNeuralNetwork(
            layers,
            node_embedder=self.__node_embedding_model.build_neural_module(),
            edge_dropout_rate=self.edge_dropout_rate,
            edge_feature_embedder=(
                None if self.__edge_embedding_model is None else self.__edge_embedding_model.build_neural_module()
            ),
        )

    def _make_batcher(self) -> GraphBatcher:
        return GraphBatcher(
            num_fwd_edge_types=len(self.__edge_types),
            padding=self.padding,
            introduce_backwards_edges=self.introduce_backwards_edges,
            add_self_edges=self.add_self_edges,
            track_edge_features=self.__edge_embedding_model is not None,
        )

    def __iterate_edge_types(self, data: GraphData):
        for edge_type in self.__edge_idx_to_type:
            adjacency_list = data.edges.get(edge_type)
            if adjacency_list is not None and len(adjacency_list) > 0:
                adj = np.array(adjacency_list, dtype=np.int32)
                yield adj[:, 0], adj[:, 1]
            else:
                yield np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)

    def tensorize(self, datapoint: GraphData) -> Optional[TensorizedGraphData]:
        if len(datapoint.node_information) > self.max_nodes_per_graph:
            LOGGER.warning("Dropping graph with %s nodes.", len(datapoint.node_information))
            return None
        edge_features_flat = None
        if self.__edge_embedding_model is not None and datapoint.edge_features is not None:
            # One feature per forward edge, in canonical type order: the
            # batcher's numbering of the graph's edges.
            edge_features_flat = []
            for edge_type in self.__edge_idx_to_type:
                feats = datapoint.edge_features.get(edge_type, [])
                type_edges = len(datapoint.edges.get(edge_type, []) or [])
                if len(feats) != type_edges:
                    raise ValueError(
                        f"edge type '{edge_type}' has {type_edges} edges but {len(feats)} edge features: a "
                        "feature-tracking model needs exactly one feature per edge (or edge_features=None "
                        "for the whole graph)"
                    )
                edge_features_flat.extend(
                    enforce_not_None(self.__edge_embedding_model.tensorize(feat)) for feat in feats
                )
        tensorized = TensorizedGraphData(
            adjacency_lists=list(self.__iterate_edge_types(datapoint)),
            node_tensorized_data=[
                enforce_not_None(self.__node_embedding_model.tensorize(ni))
                for ni in datapoint.node_information
            ],
            edge_features=edge_features_flat,
            reference_nodes={
                n: np.array(refs, dtype=np.int32) for n, refs in datapoint.reference_nodes.items()
            },
            num_nodes=len(datapoint.node_information),
        )
        if tensorized.num_edges > self.max_graph_edges:
            LOGGER.warning("Dropping graph with %s edges.", tensorized.num_edges)
            return None
        batcher = self._make_batcher()
        if not batcher.can_add(tensorized, batcher.initialize()):
            LOGGER.warning(
                "Dropping graph (%s nodes / %s edges) exceeding static batch budgets.",
                tensorized.num_nodes, tensorized.num_edges,
            )
            return None
        return tensorized

    def initialize_minibatch(self) -> Dict[str, Any]:
        batcher = self._make_batcher()
        mb = {
            "batcher": batcher,
            "batcher_mb": batcher.initialize(),
            "node_data_mb": self.__node_embedding_model.initialize_minibatch(),
        }
        if self.__edge_embedding_model is not None:
            mb["edge_data_mb"] = self.__edge_embedding_model.initialize_minibatch()
        return mb

    def can_add_to_minibatch(self, tensorized: TensorizedGraphData, partial_minibatch) -> bool:
        return partial_minibatch["batcher"].can_add(tensorized, partial_minibatch["batcher_mb"])

    def extend_minibatch_with(self, tensorized: TensorizedGraphData, partial_minibatch) -> bool:
        continue_extending = True
        for node_info in tensorized.node_tensorized_data:
            continue_extending &= self.__node_embedding_model.extend_minibatch_with(
                node_info, partial_minibatch["node_data_mb"]
            )
        if self.__edge_embedding_model is not None and tensorized.edge_features is not None:
            for feat in tensorized.edge_features:
                self.__edge_embedding_model.extend_minibatch_with(feat, partial_minibatch["edge_data_mb"])
        mb = partial_minibatch["batcher_mb"]
        partial_minibatch["batcher"].extend(tensorized, mb)
        continue_extending &= mb["num_nodes_in_mb"] < self.stop_extending_minibatch_after_num_nodes
        return continue_extending

    def finalize_minibatch(self, accumulated_minibatch_data: Dict[str, Any]) -> Dict[str, Any]:
        node_data = self.__node_embedding_model.finalize_minibatch(
            accumulated_minibatch_data["node_data_mb"], pad_to=self.padding.max_nodes
        )
        batch = accumulated_minibatch_data["batcher"].finalize(
            accumulated_minibatch_data["batcher_mb"],
            node_data=node_data,
            reference_names=self.__reference_names,
        )
        if self.__edge_embedding_model is not None:
            edge_data = self.__edge_embedding_model.finalize_minibatch(
                accumulated_minibatch_data["edge_data_mb"], pad_to=self.padding.max_edge_slots
            )
            batch = batch._replace(edge_feature_data=edge_data)
        return {"batch": batch}
