"""Fused typed-message computation + aggregation (forward).

The hot loop of every message-passing layer:

    gather source (and target) node states per edge
    -> per-edge-type linear message (one tile-batched matmul)
    -> masked segment reduce to receivers.

Target-state rows are receiver-keyed and block-local in the unified layout,
so they come from the broadcast kernel; the reduction runs the segment
kernels. The scatter-free backward of the JAX package (transpose-edge
routing, tie splitting, keyed message dropout) comes with the training
slice; until then the backward raises.
"""
from __future__ import annotations

import torch

from ptgnn_tpu_torch.ops.segment_kernels import (
    adjacency_broadcast_to_edges,
    adjacency_segment_reduce,
)
from ptgnn_tpu_torch.ops.typed_linear import typed_tile_matmul


def _fused_fwd_impl(node_states, weight_stack, adj, num_nodes, reduction, use_target_state):
    n = node_states.shape[0]
    # Padding slots' sender ids are out of range: clamp, the slots are masked
    # in the reduce.
    inp = node_states.index_select(0, adj.senders.clamp(max=n - 1).long())
    if use_target_state:
        # Receiver rows from the broadcast (0 at padding slots).
        tgt_rows = adjacency_broadcast_to_edges(node_states.contiguous(), adj)
        inp = torch.cat([inp, tgt_rows], dim=-1)
    msgs = typed_tile_matmul(inp, weight_stack, adj.tile_types, adj.edge_tile)
    return adjacency_segment_reduce(msgs, adj, num_nodes, reduction, mask=adj.mask)


class _FusedTypedMessageAggregation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, node_states, weight_stack, adj, num_nodes, reduction, use_target_state):
        return _fused_fwd_impl(
            node_states, weight_stack, adj, num_nodes, reduction, use_target_state
        )

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the fused message-passing backward is not ported yet (training slice)"
        )


def fused_typed_message_aggregation(
    node_states: torch.Tensor,  # [N, D]
    weight_stack: torch.Tensor,  # [T_total, Din, M]
    adj,
    num_nodes: int,
    reduction: str,
    use_target_state: bool,
    dropout_keep: float = 1.0,
) -> torch.Tensor:
    """[num_nodes, M] aggregated messages."""
    if dropout_keep < 1.0:
        raise NotImplementedError(
            "keyed message dropout in the fused path is not ported yet (training slice)"
        )
    return _FusedTypedMessageAggregation.apply(
        node_states, weight_stack, adj, num_nodes, reduction, use_target_state
    )

