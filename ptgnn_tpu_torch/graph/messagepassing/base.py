"""Message-passing layer interface over the fused, type-blocked edge layout.

A layer receives one ``GraphContext`` holding the batch's AdjacencyStruct
and per-graph structure. Messages take the fused route of
``ops/fused_mp.py`` over the batcher's aggregation plan where the layer and
the batch allow it (:func:`fused_linear_message_aggregation_or_none`);
otherwise a layer computes its messages per slot and aggregates them through
:func:`masked_segment_aggregate`. The tensor's device picks kernel or plain
version.

Under edge sharding (``ctx.edge_group``, ``parallel/edge_sharding.py``) each
aggregation reduces the rank's slots and all-reduces over the group, and
the fused route is closed. Under node sharding (``ctx.node_sharding``,
``parallel/node_sharding.py``) the node states are the extended [local rows
++ receive buffer] table, ``ctx.adjacency`` the merged layout over it, and
a single linear message takes the interior/boundary split in place of the
fused route.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ptgnn_tpu_torch.graph.structs import AdjacencyStruct, ReferenceSet
from ptgnn_tpu_torch.ops.fused_mp import fused_typed_message_aggregation
from ptgnn_tpu_torch.ops.segment_kernels import adjacency_segment_reduce, planned_segment_sum, sum_plan_from_adjacency

_REDUCTIONS = ("sum", "add", "mean", "max", "min")


class GraphContext(NamedTuple):
    """Everything a message-passing layer may need besides node states."""

    adjacency: AdjacencyStruct
    node_graph: Any  # [N_pad] int32
    node_mask: Any  # [N_pad] bool
    graph_mask: Any  # [G_pad] bool
    references: Dict[str, ReferenceSet]
    # False when edge dropout replaced the batch's static mask: the plan's
    # counts are then no in-degrees, and the fused route (whose forward and
    # backward assume the static mask) is closed.
    edge_mask_is_static: bool = True
    # [n_blocks, att_block] node permutation for exact block-diagonal
    # self-attention (graph/batching.py), or None.
    att_order: Any = None
    # [E_pad, F] embedded edge features per slot (backward edges share their
    # forward edge's row, self and padding slots are 0), or None.
    edge_features: Any = None
    # The process group the edge array is cut over (edge sharding), or None.
    edge_group: Any = None
    # A NodeShardCtx under node sharding (parallel/node_sharding.py), or None.
    node_sharding: Any = None

    @property
    def max_graphs(self) -> int:
        return self.graph_mask.shape[0]


def masked_segment_aggregate(
    messages: torch.Tensor, ctx: GraphContext, num_nodes: int, reduction: str
) -> torch.Tensor:
    """Masked segment reduce of [E_pad, ...] per-slot values to receiver
    nodes: the aggregation dispatch of the layers and of pluggable
    aggregations (PNA). Sum and mean run the sum kernel, max and min the
    extremum kernel; a mean under a non-static mask counts the live slots
    with the sum kernel at width 1. Under edge sharding the rank's partial
    aggregate is all-reduced over the group."""
    adj = ctx.adjacency
    if ctx.edge_group is not None:
        from ptgnn_tpu_torch.parallel.edge_sharding import sharded_aggregate

        return sharded_aggregate(messages, adj, num_nodes, reduction, ctx.edge_group, mask=adj.mask,
                                 counts_exact=ctx.edge_mask_is_static)
    return adjacency_segment_reduce(
        messages, adj, num_nodes, reduction, mask=adj.mask, counts_exact=ctx.edge_mask_is_static
    )


def live_in_degree(adj: AdjacencyStruct, num_nodes: int, mask: Optional[torch.Tensor],
                   counts_exact: bool) -> torch.Tensor:
    """[num_nodes] float32 count of each row's live slots in ``adj``: the
    plan's counts under the static mask (``counts_exact``), else the sum
    kernel over ``mask`` at width 1."""
    if counts_exact or mask is None:
        return adj.agg_counts.reshape(-1)[:num_nodes].float()
    return planned_segment_sum(mask[:, None].float(), sum_plan_from_adjacency(adj), num_nodes)[:, 0]


def masked_segment_degree(ctx: GraphContext, num_nodes: int) -> torch.Tensor:
    """[num_nodes] float32 count of each node's live in-slots; summed over
    the ranks under edge sharding."""
    adj = ctx.adjacency
    degree = live_in_degree(adj, num_nodes, adj.mask, ctx.edge_mask_is_static)
    if ctx.edge_group is not None:
        from ptgnn_tpu_torch.parallel.collectives import all_reduce_sum_

        degree = all_reduce_sum_(degree.clone(), ctx.edge_group)
    return degree


def fused_linear_message_aggregation_or_none(
    weight_stack: torch.Tensor,
    node_states: torch.Tensor,
    ctx: GraphContext,
    *,
    reduction,
    use_target_state: bool,
    dropout_rate: float,
    train: bool,
    generator: Optional[torch.Generator],
    argmax_routing: bool = False,
) -> Optional[torch.Tensor]:
    """The scatter-free fused message + aggregate (``ops/fused_mp.py``) of a
    single typed linear message, where the reduction is one of the named
    ones and the batch's layout allows it (an aggregation plan, the
    transposed tile types, the static mask) and the context carries no edge
    features (the fused op never sees them); None, and the caller computes
    its messages per slot, otherwise. Under node sharding the message takes
    the interior/boundary split (no argmax routing there, as in the JAX
    package); under edge sharding the per-slot route."""
    adj = ctx.adjacency
    if not isinstance(reduction, str) or reduction not in _REDUCTIONS or ctx.edge_features is not None:
        return None
    if ctx.node_sharding is not None:
        from ptgnn_tpu_torch.parallel.node_sharding import node_sharded_linear_message_aggregation

        return node_sharded_linear_message_aggregation(
            weight_stack, ctx, reduction=reduction, use_target_state=use_target_state,
            dropout_rate=dropout_rate, train=train, generator=generator,
        )
    if ctx.edge_group is not None:
        return None
    if adj.tile_row_blocks is None or adj.tile_types_transposed is None or not ctx.edge_mask_is_static:
        return None
    keep = 1.0 - (dropout_rate if train else 0.0)
    seed = None
    if keep < 1.0:  # the keyed message dropout's seed, in [0, 2**32)
        if generator is None:
            raise ValueError("message dropout during training needs a torch.Generator")
        seed = torch.randint(0, 2**32, (), generator=generator, device=node_states.device)
    return fused_typed_message_aggregation(
        node_states, weight_stack, adj, node_states.shape[0], reduction, use_target_state, keep, seed,
        argmax_routing=argmax_routing,
    )


class AbstractMessagePassingLayer(torch.nn.Module):
    """forward(node_states [N, D], ctx, train=False, generator=None) -> [N, D']
    node states; ``generator`` draws the layer's dropout when training.

    ``needs_boundary_exchange``: under node sharding, whether the layer
    reads sender rows of other ranks. A layer that sets it False (GraphNorm,
    the global exchange, self-attention) gets a zero receive buffer instead
    of an exchange, so it must read neither ``ctx.adjacency`` nor
    ``ctx.node_sharding.recv``."""

    needs_boundary_exchange: bool = True

    def forward(self, node_states: torch.Tensor, ctx: GraphContext, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def _aggregate_messages(
        self, messages: torch.Tensor, ctx: GraphContext, num_nodes: int, aggregation_fn: str
    ) -> torch.Tensor:
        """Masked segment reduce to receivers, accumulated in float32 and
        cast back to the messages' dtype."""
        return masked_segment_aggregate(messages, ctx, num_nodes, aggregation_fn)

    @property
    def input_state_dimension(self) -> int:
        raise NotImplementedError

    @property
    def output_state_dimension(self) -> int:
        raise NotImplementedError


class AbstractMessageAggregation(torch.nn.Module):
    """A pluggable aggregation: forward(messages [E_pad, M], ctx, num_nodes)
    -> [num_nodes, output_state_size(M)]."""

    def forward(self, messages: torch.Tensor, ctx: GraphContext, num_nodes: int) -> torch.Tensor:
        raise NotImplementedError

    def output_state_size(self, message_input_size: int) -> int:
        raise NotImplementedError
