"""Residual connections as message-passing layer pairs.

An origin layer (``pass_through_dummy_layer()``) hands its input states to
the engine's stash under its paired residual layer; that layer later
combines the stashed states with the current ones (graph/gnn.py).
"""
from __future__ import annotations

from typing import Optional

import torch

from ptgnn_tpu_torch.graph.messagepassing.base import AbstractMessagePassingLayer
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import Linear, dropout


class _ResidualOriginLayer(AbstractMessagePassingLayer):
    """Pass-through that records node states for its paired target layer."""

    def __init__(self, input_dim: int, target_layer: "AbstractResidualLayer"):
        super().__init__()
        self.__input_dim = input_dim
        # A plain attribute: registering the target as a submodule would put
        # it in the module tree twice.
        object.__setattr__(self, "target_layer", target_layer)

    def forward(self, node_states, ctx, *, train=False, generator=None):
        return node_states

    @property
    def input_state_dimension(self) -> int:
        return self.__input_dim

    @property
    def output_state_dimension(self) -> int:
        return self.__input_dim


class AbstractResidualLayer(AbstractMessagePassingLayer):
    """Base for layers combining current states with a stashed origin."""

    def pass_through_dummy_layer(self) -> _ResidualOriginLayer:
        return _ResidualOriginLayer(self.input_state_dimension, target_layer=self)

    def combine(self, original: torch.Tensor, node_states: torch.Tensor, *, train: bool,
                generator: Optional[torch.Generator] = None):
        """The states after the block from the stashed ``original`` and the
        current ``node_states``; ``generator`` draws any dropout mask."""
        raise NotImplementedError


class MeanResidualLayer(AbstractResidualLayer):
    def __init__(self, input_dim: int):
        super().__init__()
        self.__input_dim = input_dim

    def combine(self, original, node_states, *, train=False, generator=None):
        return (original + node_states) * 0.5

    @property
    def input_state_dimension(self) -> int:
        return self.__input_dim

    @property
    def output_state_dimension(self) -> int:
        return self.__input_dim


class ConcatResidualLayer(AbstractResidualLayer):
    def __init__(self, input_dim: int):
        super().__init__()
        self.__input_dim = input_dim

    def combine(self, original, node_states, *, train=False, generator=None):
        return torch.cat([original, node_states], dim=-1)

    @property
    def input_state_dimension(self) -> int:
        return self.__input_dim

    @property
    def output_state_dimension(self) -> int:
        return 2 * self.__input_dim


class LinearResidualLayer(AbstractResidualLayer):
    """A bias-free linear map of the concatenated states (``[original,
    node_states]``, ``linear.weight`` ``[target_state_size, d1 + d2]``),
    then dropout. The origin layer passes ``state_dimension1`` wide states;
    the layer takes ``state_dimension2`` wide ones."""

    def __init__(self, state_dimension1: int, state_dimension2: int, target_state_size: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.__input_dim1 = state_dimension1
        self.__input_dim2 = state_dimension2
        self.dropout_rate = dropout_rate
        self.linear = Linear(state_dimension1 + state_dimension2, target_state_size,
                             weight_init=init.kaiming_uniform(), use_bias=False)

    def pass_through_dummy_layer(self) -> _ResidualOriginLayer:
        return _ResidualOriginLayer(self.__input_dim1, target_layer=self)

    def combine(self, original, node_states, *, train=False, generator=None):
        out = self.linear(torch.cat([original, node_states], dim=-1))
        return dropout(out, self.dropout_rate, train, generator)

    @property
    def input_state_dimension(self) -> int:
        return self.__input_dim2

    @property
    def output_state_dimension(self) -> int:
        return self.linear.out_features
