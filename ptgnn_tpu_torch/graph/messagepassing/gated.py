"""GGNN-style gated message passing: per-edge-type bias-free linear messages
from the source states, aggregated to receivers by the fused route, then a
GRU state update. The counterpart of the JAX package's
``graph/messagepassing/gated.py`` without edge features (the port's batches
carry none)."""
from __future__ import annotations

from typing import Optional

import torch

from ptgnn_tpu_torch.graph.messagepassing.base import AbstractMessagePassingLayer, GraphContext
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import GRUCell
from ptgnn_tpu_torch.ops.fused_mp import fused_typed_message_aggregation


class GatedMessagePassingLayer(AbstractMessagePassingLayer):
    """Messages ``x[src] @ message_weights[type]`` (keyed message-input
    dropout while training), aggregated by ``message_aggregation_function``,
    update the state through a GRU cell. ``argmax_routing``: max/min
    aggregation routes each gradient to the first winning edge alone
    (``ops/fused_mp.py``)."""

    def __init__(
        self,
        state_dimension: int,
        message_dimension: int,
        num_edge_types: int,
        message_aggregation_function: str,
        dropout_rate: float = 0.0,
        argmax_routing: bool = False,
    ):
        super().__init__()
        self.state_dimension = state_dimension
        self.message_dimension = message_dimension
        self.num_edge_types = num_edge_types
        self.aggregation_fn = message_aggregation_function
        self.dropout_rate = dropout_rate
        self.argmax_routing = argmax_routing
        # [T, D, M]: each type's torch-layout [M, D] weight, transposed.
        self.message_weights = torch.nn.Parameter(
            torch.empty(num_edge_types, state_dimension, message_dimension)
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
            block = torch.empty(self.message_dimension, self.state_dimension)
            w_init(block, generator)
            self.message_weights.data[t].copy_(block.T)

    def forward(self, node_states: torch.Tensor, ctx: GraphContext, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        keep = 1.0 - (self.dropout_rate if train else 0.0)
        seed = None
        if keep < 1.0:  # the keyed message dropout's seed, in [0, 2**32)
            if generator is None:
                raise ValueError("message dropout during training needs a torch.Generator")
            seed = torch.randint(0, 2**32, (), generator=generator, device=node_states.device)
        aggregated = fused_typed_message_aggregation(
            node_states, self.message_weights, ctx.adjacency, node_states.shape[0],
            self.aggregation_fn, False, keep, seed, argmax_routing=self.argmax_routing,
        )
        return self.state_update(aggregated, node_states)

    @property
    def input_state_dimension(self) -> int:
        return self.state_dimension

    @property
    def output_state_dimension(self) -> int:
        return self.state_dimension
