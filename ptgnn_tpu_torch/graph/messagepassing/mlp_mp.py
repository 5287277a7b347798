"""MLP message passing: per-edge-type MLP messages, a named or pluggable
aggregation, then the activation -> LayerNorm -> Dense(+activation) ->
dropout state update. The counterpart of the JAX package's
``graph/messagepassing/mlp_mp.py``."""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ptgnn_tpu_torch.graph.messagepassing.base import (
    AbstractMessageAggregation,
    AbstractMessagePassingLayer,
    GraphContext,
    fused_linear_message_aggregation_or_none,
)
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import LayerNorm, Linear, dropout, get_activation
from ptgnn_tpu_torch.ops.segment import take_rows
from ptgnn_tpu_torch.ops.typed_linear import typed_tile_matmul


class TypedMLP(torch.nn.Module):
    """Per-edge-type MLPs as stacked tile matmuls: bias-free xavier-uniform
    weights ``weights_{i}`` of shape [T, d_in, d_out], dropout before every
    layer, the activation between hidden layers and none after the last.
    ``hidden_layers`` is an int (that many layers of ``output_dimension``
    units, 32 for a size-1 output) or a list of sizes."""

    def __init__(
        self,
        num_types: int,
        input_dimension: int,
        output_dimension: int,
        hidden_layers: Union[int, Sequence[int]] = 0,
        activation="relu",
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        if isinstance(hidden_layers, int):
            hidden_sizes = [output_dimension if output_dimension != 1 else 32] * hidden_layers
        else:
            hidden_sizes = list(hidden_layers)
        self.num_types = num_types
        self.dims: List[int] = [input_dimension] + hidden_sizes + [output_dimension]
        self.activation = get_activation(activation)
        self.dropout_rate = dropout_rate
        for layer in range(len(self.dims) - 1):
            self.register_parameter(
                f"weights_{layer}",
                torch.nn.Parameter(torch.empty(num_types, self.dims[layer], self.dims[layer + 1])),
            )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        w_init = init.xavier_uniform()
        for layer in range(len(self.dims) - 1):
            weights = getattr(self, f"weights_{layer}")
            _, d_in, d_out = weights.shape
            for t in range(self.num_types):
                block = torch.empty(d_out, d_in)  # torch layout [out, in]
                w_init(block, generator)
                weights.data[t].copy_(block.T)

    def forward(self, x: torch.Tensor, tile_types: torch.Tensor, edge_tile: int, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n_layers = len(self.dims) - 1
        for layer in range(n_layers):
            x = dropout(x, self.dropout_rate, train, generator)
            x = typed_tile_matmul(x, getattr(self, f"weights_{layer}"), tile_types, edge_tile)
            if layer < n_layers - 1:
                x = self.activation(x)
        return x


class MlpMessagePassingLayer(AbstractMessagePassingLayer):
    """MLP message passing: typed MLP messages from the source (and target)
    states, aggregated to receivers by ``message_aggregation_function`` (a
    reduction's name or an :class:`AbstractMessageAggregation`), then
    ``message_activation`` -> LayerNorm -> Dense -> ``dense_activation`` ->
    dropout (each optional as in the JAX package).

    A single-linear message with a named reduction takes the fused route;
    hidden layers, a pluggable aggregation, a non-static edge mask or edge
    features take the per-slot route: gather, typed tile matmuls,
    aggregation dispatch. ``features_dimension`` F widens the first MLP
    layer's input by the context's [E_pad, F] edge features, concatenated
    after the source (and target) states.
    ``argmax_routing`` applies to the fused route: max/min aggregation
    routes each gradient to the first winning edge alone
    (``ops/fused_mp.py``)."""

    def __init__(
        self,
        input_state_dimension: int,
        output_state_dimension: int,
        message_dimension: int,
        num_edge_types: int,
        message_aggregation_function: Union[str, AbstractMessageAggregation],
        message_activation="gelu",
        use_target_state_as_message_input: bool = True,
        mlp_hidden_layers: Union[int, Sequence[int]] = 0,
        use_layer_norm: bool = True,
        use_dense_layer: bool = True,
        dropout_rate: float = 0.0,
        dense_activation="tanh",
        features_dimension: int = 0,
        argmax_routing: bool = False,
    ):
        super().__init__()
        self.__input_state_dim = input_state_dimension
        self.__output_state_dim = output_state_dimension
        self.use_target_state_as_message_input = use_target_state_as_message_input
        self.num_edge_types = num_edge_types
        self.dropout_rate = dropout_rate
        self.argmax_routing = argmax_routing
        self.features_dimension = features_dimension
        message_input_size = (
            2 * input_state_dimension if use_target_state_as_message_input else input_state_dimension
        )
        self.message_mlp = TypedMLP(num_edge_types, message_input_size + features_dimension, message_dimension,
                                    hidden_layers=mlp_hidden_layers)
        if isinstance(message_aggregation_function, AbstractMessageAggregation):
            aggregated_size = message_aggregation_function.output_state_size(message_dimension)
            self.aggregation = message_aggregation_function  # a submodule, as the JAX params' "aggregation"
            self._reduction = None
        else:
            aggregated_size = message_dimension
            self._reduction = message_aggregation_function
        self.message_activation = (
            get_activation(message_activation) if message_activation is not None else None
        )
        self.layer_norm = LayerNorm(aggregated_size) if use_layer_norm else None
        self.dense = (
            Linear(aggregated_size, output_state_dimension, use_bias=True, weight_init=init.xavier_uniform())
            if use_dense_layer else None
        )
        self.dense_activation = get_activation(dense_activation) if dense_activation is not None else None

    def forward(self, node_states: torch.Tensor, ctx: GraphContext, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        adj = ctx.adjacency
        n = node_states.shape[0]
        given = 0 if ctx.edge_features is None else ctx.edge_features.shape[-1]
        if given != self.features_dimension:
            raise ValueError(f"the layer takes {self.features_dimension} edge-feature columns, the context "
                             f"carries {given}")
        aggregated = None
        if len(self.message_mlp.dims) == 2:
            aggregated = fused_linear_message_aggregation_or_none(
                self.message_mlp.weights_0, node_states, ctx, reduction=self.aggregation_fn,
                use_target_state=self.use_target_state_as_message_input,
                dropout_rate=self.message_mlp.dropout_rate, train=train, generator=generator,
                argmax_routing=self.argmax_routing,
            )
        if aggregated is None:
            msg_input = take_rows(node_states, adj.senders.clamp(max=n - 1))
            if self.use_target_state_as_message_input:
                # Padding receivers point past the nodes: clipped for the
                # gather, their rows are masked out of the aggregation.
                target = take_rows(node_states, adj.receivers.clamp(max=n - 1))
                msg_input = torch.cat([msg_input, target], dim=-1)
            if ctx.edge_features is not None:
                msg_input = torch.cat([msg_input, ctx.edge_features.to(msg_input.dtype)], dim=-1)
            messages = self.message_mlp(msg_input, adj.tile_types, adj.edge_tile, train=train, generator=generator)
            if self._reduction is None:
                aggregated = self.aggregation(messages, ctx, n)
            else:
                aggregated = self._aggregate_messages(messages, ctx, n, self._reduction)
        if self.message_activation is not None:
            aggregated = self.message_activation(aggregated)
        out = aggregated
        if self.layer_norm is not None:
            out = self.layer_norm(out)
        if self.dense is not None:
            out = self.dense(out)
            if self.dense_activation is not None:
                out = self.dense_activation(out)
        return dropout(out, self.dropout_rate, train, generator)

    @property
    def aggregation_fn(self) -> Union[str, AbstractMessageAggregation]:
        return self.aggregation if self._reduction is None else self._reduction

    @property
    def input_state_dimension(self) -> int:
        return self.__input_state_dim

    @property
    def output_state_dimension(self) -> int:
        return self.__output_state_dim
