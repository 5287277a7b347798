"""Residual connections as message-passing layer pairs.

An origin layer (``pass_through_dummy_layer()``) hands its input states to
the engine's stash under its paired residual layer; that layer later
combines the stashed states with the current ones (graph/gnn.py).
"""
from __future__ import annotations

import torch

from ptgnn_tpu_torch.graph.messagepassing.base import AbstractMessagePassingLayer


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

    def combine(self, original: torch.Tensor, node_states: torch.Tensor, *, train: bool):
        raise NotImplementedError


class ConcatResidualLayer(AbstractResidualLayer):
    def __init__(self, input_dim: int):
        super().__init__()
        self.__input_dim = input_dim

    def combine(self, original, node_states, *, train=False):
        return torch.cat([original, node_states], dim=-1)

    @property
    def input_state_dimension(self) -> int:
        return self.__input_dim

    @property
    def output_state_dimension(self) -> int:
        return 2 * self.__input_dim
