"""GraphNorm: per-graph feature normalization (Cai et al. 2020), with
masked per-graph moments in float32: padding nodes stay out of the mean and
the variance. The counterpart of the JAX package's
``graph/messagepassing/graphnorm.py``. The per-graph sums go through
``ops/segment.py::segment_sum``, which on the card is the segment sum kernel
over the sorted graph ids: the same bits on every run. Under node sharding
(``ctx.node_sharding``) each rank holds its own rows, and the per-graph
sums and counts are all-reduced over the node group."""
from __future__ import annotations

from typing import Optional

import torch

from ptgnn_tpu_torch.graph.messagepassing.base import AbstractMessagePassingLayer, GraphContext
from ptgnn_tpu_torch.ops.segment import masked_take, segment_count, segment_sum


class GraphNorm(AbstractMessagePassingLayer):
    needs_boundary_exchange = False  # per-graph moments only

    def __init__(self, input_state_dimension: int, eps: float = 1e-10):
        super().__init__()
        self.__input_state_dim = input_state_dimension
        self.__eps = eps
        self.gamma = torch.nn.Parameter(torch.ones(1, input_state_dimension))
        self.alpha = torch.nn.Parameter(torch.ones(1, input_state_dimension))
        self.bias = torch.nn.Parameter(torch.zeros(1, input_state_dimension))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.gamma.data.fill_(1.0)
        self.alpha.data.fill_(1.0)
        self.bias.data.zero_()

    @staticmethod
    def _masked_mean(x: torch.Tensor, ctx: GraphContext, num_graphs: int) -> torch.Tensor:
        total = segment_sum(x, ctx.node_graph, num_graphs, ctx.node_mask)
        count = segment_count(ctx.node_graph, num_graphs, ctx.node_mask).to(x.dtype)
        if ctx.node_sharding is not None:  # each rank holds its rows of a graph
            from ptgnn_tpu_torch.parallel.collectives import all_reduce_sum, all_reduce_sum_

            total = all_reduce_sum(total, ctx.node_sharding.group)
            count = all_reduce_sum_(count, ctx.node_sharding.group)
        return total / count.clamp_min(1.0)[:, None]

    def forward(self, node_states: torch.Tensor, ctx: GraphContext, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        num_graphs = ctx.max_graphs
        x = node_states.float()
        mean_per_node = masked_take(self._masked_mean(x, ctx, num_graphs), ctx.node_graph, 0.0)
        shifted = x - self.alpha.float() * mean_per_node
        sigma_2 = self._masked_mean(shifted.square(), ctx, num_graphs) + self.__eps
        sigma_per_node = masked_take(sigma_2, ctx.node_graph, 1.0)
        out = self.gamma.float() * shifted * torch.rsqrt(sigma_per_node) + self.bias.float()
        return out.to(node_states.dtype)

    @property
    def input_state_dimension(self) -> int:
        return self.__input_state_dim

    @property
    def output_state_dimension(self) -> int:
        return self.__input_state_dim
