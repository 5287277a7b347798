"""MLP message passing with the benchmark configuration's layer: typed
linear messages, then gelu -> LayerNorm -> Dense -> tanh -> dropout."""
from __future__ import annotations

from typing import Optional

import torch

from ptgnn_tpu_torch.graph.messagepassing.base import AbstractMessagePassingLayer, GraphContext
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import LayerNorm, Linear, dropout, gelu_exact
from ptgnn_tpu_torch.ops.fused_mp import fused_typed_message_aggregation


class TypedMLP(torch.nn.Module):
    """Per-edge-type message weights, applied as one tile-batched matmul by
    the fused route. The port has the single-linear case (the benchmark
    MLP-MP's and the only one the fused path takes): bias-free
    xavier-uniform ``weights_0`` of shape [T, d_in, d_out], dropout before
    it."""

    def __init__(self, num_types: int, input_dimension: int, output_dimension: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_types = num_types
        self.dropout_rate = dropout_rate
        self.weights_0 = torch.nn.Parameter(torch.empty(num_types, input_dimension, output_dimension))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        w_init = init.xavier_uniform()
        _, d_in, d_out = self.weights_0.shape
        for t in range(self.num_types):
            block = torch.empty(d_out, d_in)  # torch layout [out, in]
            w_init(block, generator)
            self.weights_0.data[t].copy_(block.T)


class MlpMessagePassingLayer(AbstractMessagePassingLayer):
    """MLP message passing: typed linear messages from the source (and
    target) states, aggregated to receivers, then gelu -> LayerNorm ->
    Dense -> tanh -> dropout."""

    def __init__(
        self,
        input_state_dimension: int,
        output_state_dimension: int,
        message_dimension: int,
        num_edge_types: int,
        message_aggregation_function: str,
        use_target_state_as_message_input: bool = True,
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        self.__input_state_dim = input_state_dimension
        self.__output_state_dim = output_state_dimension
        self.use_target_state_as_message_input = use_target_state_as_message_input
        self.num_edge_types = num_edge_types
        self.aggregation_fn = message_aggregation_function
        self.dropout_rate = dropout_rate
        message_input_size = (
            2 * input_state_dimension if use_target_state_as_message_input else input_state_dimension
        )
        self.message_mlp = TypedMLP(num_edge_types, message_input_size, message_dimension)
        self.layer_norm = LayerNorm(message_dimension)
        self.dense = Linear(message_dimension, output_state_dimension, use_bias=True,
                            weight_init=init.xavier_uniform())

    def forward(self, node_states: torch.Tensor, ctx: GraphContext, *, train: bool = False):
        aggregated = fused_typed_message_aggregation(
            node_states, self.message_mlp.weights_0, ctx.adjacency, node_states.shape[0],
            self.aggregation_fn, self.use_target_state_as_message_input,
            1.0 - (self.message_mlp.dropout_rate if train else 0.0),
        )
        out = torch.tanh(self.dense(self.layer_norm(gelu_exact(aggregated))))
        return dropout(out, self.dropout_rate, train)

    @property
    def input_state_dimension(self) -> int:
        return self.__input_state_dim

    @property
    def output_state_dimension(self) -> int:
        return self.__output_state_dim
