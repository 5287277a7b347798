"""Global graph-state exchange: summarize each graph with a var-sized reduce
over its (masked) nodes, then update every node with its graph's summary.
The counterpart of the JAX package's ``global_exchange.py``. Summaries use
the padded graph budget, so shapes stay static. Under node sharding a
reduce that takes sharded inputs (``supports_sharded_inputs``: every reduce
of ``reduceops/``) summarizes this rank's rows with one collective per
reduction; another reduce gets the all-gathered node table.

Parameters sit under the JAX package's param keys: the reduce under
``summary``, the node update under ``update``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ptgnn_tpu_torch.graph.messagepassing.base import AbstractMessagePassingLayer, GraphContext
from ptgnn_tpu_torch.nn.layers import GRUCell, dropout
from ptgnn_tpu_torch.ops.segment import masked_take
from ptgnn_tpu_torch.reduceops.varsizedsummary import (
    AbstractVarSizedElementReduce,
    ElementsToSummaryRepresentationInput,
)


class AbstractGlobalGraphExchange(AbstractMessagePassingLayer):
    needs_boundary_exchange = False  # per-graph summaries only

    def __init__(self, global_graph_representation_module: AbstractVarSizedElementReduce,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.summary = global_graph_representation_module
        self.dropout_rate = dropout_rate

    def _update_node_states(self, node_states: torch.Tensor, global_info_per_node: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, node_states: torch.Tensor, ctx: GraphContext, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        num_graphs = ctx.graph_mask.shape[0]
        ns = ctx.node_sharding
        if ns is None:
            inputs = ElementsToSummaryRepresentationInput(node_states, ctx.node_graph, num_graphs, ctx.node_mask)
        elif self.summary.supports_sharded_inputs:
            inputs = ElementsToSummaryRepresentationInput(
                ns.h_local, ctx.node_graph[:ns.rows_per], num_graphs, ctx.node_mask[:ns.rows_per],
                shard_group=ns.group,
            )
        else:
            from ptgnn_tpu_torch.parallel.collectives import all_gather_rows

            inputs = ElementsToSummaryRepresentationInput(
                all_gather_rows(ns.h_local, ns.group), ns.node_graph_global, num_graphs, ns.node_mask_global,
            )
        graph_representations = dropout(self.summary(inputs), self.dropout_rate, train, generator)  # [G_pad, D']
        # Padding nodes carry graph id G_pad: they read 0.
        per_node = masked_take(graph_representations, ctx.node_graph, 0.0)
        return self._update_node_states(node_states, per_node)


class GruGlobalStateUpdate(AbstractGlobalGraphExchange):
    """A GRU cell updates each node's state from its graph's summary."""

    def __init__(
        self,
        global_graph_representation_module: AbstractVarSizedElementReduce,
        input_state_size: int,
        summarized_state_size: int,
        dropout_rate: float = 0.0,
    ):
        super().__init__(global_graph_representation_module, dropout_rate)
        self.__input_dim = input_state_size
        self.update = GRUCell(input_size=summarized_state_size, hidden_size=input_state_size)

    def _update_node_states(self, node_states, global_info_per_node):
        return self.update(global_info_per_node, node_states)

    @property
    def input_state_dimension(self) -> int:
        return self.__input_dim

    @property
    def output_state_dimension(self) -> int:
        return self.__input_dim
