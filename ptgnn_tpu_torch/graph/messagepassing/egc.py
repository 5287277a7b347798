"""Efficient Graph Convolution (EGC-S, Tailor et al. 2021): per-edge-type
basis projections of the source states, aggregated per head and basis and
combined by per-node learned coefficients. The counterpart of the JAX
package's ``graph/messagepassing/egc.py``."""
from __future__ import annotations

from typing import Optional

import torch

from ptgnn_tpu_torch.graph.messagepassing.base import (
    AbstractMessagePassingLayer,
    GraphContext,
    fused_linear_message_aggregation_or_none,
)
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import Linear, dropout
from ptgnn_tpu_torch.ops.segment import take_rows
from ptgnn_tpu_torch.ops.typed_linear import typed_tile_matmul


class EGCMessagePassingLayer(AbstractMessagePassingLayer):
    """Messages ``x[src] @ bases[type]`` ([T, D, B*O], kaiming-uniform per
    type), reshaped to [E, heads, bases, O/heads] and aggregated; each node
    sums its bases weighted by ``weight_coeffs(x)`` (a biased Linear to
    heads*bases). A named reduction under the static mask takes the fused
    route."""

    def __init__(
        self,
        input_state_dimension: int,
        output_state_dimension: int,
        num_edge_types: int,
        message_aggregation_function: str,
        num_bases: int = 4,
        num_heads: int = 8,
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        if output_state_dimension % num_heads:
            raise ValueError(f"output_state_dimension {output_state_dimension} is not a multiple of "
                             f"num_heads {num_heads}")
        self.__input_state_dim = input_state_dimension
        self.__output_state_dim = output_state_dimension
        self.num_edge_types = num_edge_types
        self.aggregation_fn = message_aggregation_function
        self.num_bases = num_bases
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.bases = torch.nn.Parameter(
            torch.empty(num_edge_types, input_state_dimension, num_bases * output_state_dimension)
        )
        self.weight_coeffs = Linear(input_state_dimension, num_heads * num_bases, use_bias=True,
                                    weight_init=init.kaiming_uniform())

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        w_init = init.kaiming_uniform()
        _, d, bo = self.bases.shape
        for t in range(self.num_edge_types):
            block = torch.empty(bo, d)  # torch layout [out, in]
            w_init(block, generator)
            self.bases.data[t].copy_(block.T)

    def forward(self, node_states: torch.Tensor, ctx: GraphContext, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        adj = ctx.adjacency
        n = node_states.shape[0]
        h, b, o = self.num_heads, self.num_bases, self.__output_state_dim
        node_weights = self.weight_coeffs(node_states).reshape(n, h, b, 1)
        aggregated = fused_linear_message_aggregation_or_none(
            self.bases, node_states, ctx, reduction=self.aggregation_fn, use_target_state=False,
            dropout_rate=self.dropout_rate, train=train, generator=generator,
        )
        if aggregated is not None:
            aggregated = aggregated.reshape(n, h, b, o // h)
        else:
            source_states = take_rows(node_states, adj.senders.clamp(max=n - 1))
            source_states = dropout(source_states, self.dropout_rate, train, generator)
            base_messages = typed_tile_matmul(source_states, self.bases, adj.tile_types, adj.edge_tile)
            messages = base_messages.reshape(-1, h, b, o // h)
            aggregated = self._aggregate_messages(messages, ctx, n, self.aggregation_fn)  # [N, h, b, O/h]
        return (aggregated * node_weights).sum(dim=-2).reshape(n, o)

    @property
    def input_state_dimension(self) -> int:
        return self.__input_state_dim

    @property
    def output_state_dimension(self) -> int:
        return self.__output_state_dim
