"""GGNN-style gated message passing: per-edge-type bias-free linear messages
from the source states (and, optionally, the edge features), aggregated to
receivers (by the fused route where the batch allows it, else per slot),
then a GRU state update. The counterpart of the JAX package's
``graph/messagepassing/gated.py``."""
from __future__ import annotations

from typing import Optional

import torch

from ptgnn_tpu_torch.graph.messagepassing.base import (
    AbstractMessagePassingLayer,
    GraphContext,
    fused_linear_message_aggregation_or_none,
)
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import GRUCell, dropout
from ptgnn_tpu_torch.ops.segment import take_rows
from ptgnn_tpu_torch.ops.typed_linear import typed_tile_matmul


class GatedMessagePassingLayer(AbstractMessagePassingLayer):
    """Messages ``x[src] @ message_weights[type]`` (keyed message-input
    dropout while training), aggregated by ``message_aggregation_function``,
    update the state through a GRU cell. Where the fused route is closed
    (a non-static edge mask, under edge dropout), the messages are computed
    per slot: gather, message-input dropout, typed tile matmul, aggregation
    dispatch. ``edge_feature_dimension`` F widens the message weights to
    [T, D + F, M]: the context's [E_pad, F] edge features are concatenated
    after the source states, before the message-input dropout, on the
    per-slot route (the fused op takes no features). ``argmax_routing``
    applies to the fused route: max/min aggregation routes each gradient to
    the first winning edge alone (``ops/fused_mp.py``)."""

    def __init__(
        self,
        state_dimension: int,
        message_dimension: int,
        num_edge_types: int,
        message_aggregation_function: str,
        dropout_rate: float = 0.0,
        edge_feature_dimension: int = 0,
        argmax_routing: bool = False,
    ):
        super().__init__()
        self.state_dimension = state_dimension
        self.edge_feature_dimension = edge_feature_dimension
        self.message_dimension = message_dimension
        self.num_edge_types = num_edge_types
        self.aggregation_fn = message_aggregation_function
        self.dropout_rate = dropout_rate
        self.argmax_routing = argmax_routing
        # [T, D + F, M]: each type's torch-layout [M, D + F] weight, transposed.
        self.message_weights = torch.nn.Parameter(
            torch.empty(num_edge_types, state_dimension + edge_feature_dimension, message_dimension)
        )
        self.state_update = GRUCell(
            message_dimension,
            state_dimension,
            weight_hh_init=init.orthogonal(),
            weight_ih_init=init.xavier_uniform(),
            bias_hh_init=init.normal(std=1e-5),
            bias_ih_init=init.normal(std=1e-5),
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # Per-type xavier_normal with gain (1/T)^0.5 on the torch layout.
        w_init = init.xavier_normal(gain=(1.0 / self.num_edge_types) ** 0.5)
        for t in range(self.num_edge_types):
            block = torch.empty(self.message_dimension, self.state_dimension + self.edge_feature_dimension)
            w_init(block, generator)
            self.message_weights.data[t].copy_(block.T)

    def forward(self, node_states: torch.Tensor, ctx: GraphContext, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        aggregated = None
        if self.edge_feature_dimension == 0:
            aggregated = fused_linear_message_aggregation_or_none(
                self.message_weights, node_states, ctx, reduction=self.aggregation_fn, use_target_state=False,
                dropout_rate=self.dropout_rate, train=train, generator=generator,
                argmax_routing=self.argmax_routing,
            )
        elif ctx.edge_features is None or ctx.edge_features.shape[-1] != self.edge_feature_dimension:
            raise ValueError(f"the layer takes {self.edge_feature_dimension} edge-feature columns, the context "
                             f"carries {None if ctx.edge_features is None else ctx.edge_features.shape[-1]}")
        if aggregated is None:
            adj = ctx.adjacency
            n = node_states.shape[0]
            msg_input = take_rows(node_states, adj.senders.clamp(max=n - 1))
            if self.edge_feature_dimension:
                msg_input = torch.cat([msg_input, ctx.edge_features.to(msg_input.dtype)], dim=-1)
            msg_input = dropout(msg_input, self.dropout_rate, train, generator)
            messages = typed_tile_matmul(msg_input, self.message_weights, adj.tile_types, adj.edge_tile)
            aggregated = self._aggregate_messages(messages, ctx, n, self.aggregation_fn)
        return self.state_update(aggregated, node_states)

    @property
    def input_state_dimension(self) -> int:
        return self.state_dimension

    @property
    def output_state_dimension(self) -> int:
        return self.state_dimension
