"""Transformer-style self-attention among the nodes of each graph, over
fixed blocks of rows. The counterpart of the JAX package's
``graph/messagepassing/selfatt.py`` (without its node-sharded branch).

The node rows are cut into blocks and attention runs block-diagonally with a
same-graph mask inside every block: one batched matmul over [blocks, block,
...]. Over the batcher's ``att_order`` packing every graph of at most one
block sits in one block, so attention is exact for it; a larger graph
attends within its block-wide chunks. Padding rows are masked from both
sides of the softmax and get zero attention output. ``target_reference``
restricts attention to a named reference-node subset and writes its rows
back in place. The attention is stock PyTorch matmuls and softmax, as the
JAX layer's is XLA einsums.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

from ptgnn_tpu_torch.graph.messagepassing.base import AbstractMessagePassingLayer, GraphContext
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import LayerNorm, Linear, dropout
from ptgnn_tpu_torch.ops.segment import take_rows

LOGGER = logging.getLogger(__name__)


def _block_attention(
    qkv: torch.Tensor,  # [N, heads, 2*kd + vd]
    graph_ids: torch.Tensor,  # [N]
    valid: torch.Tensor,  # [N] bool
    *,
    key_dim: int,
    block_size: int,
    dropout_rate: float,
    train: bool,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """Block-diagonal same-graph attention: [N, heads, vd]. Row i mixes the
    values by softmax_j(keys[i] . queries[j] / sqrt(kd)) over the rows j of
    its block in its graph; a row with no such j gets zeros."""
    n, heads, _ = qkv.shape
    nb = n // block_size
    keys = qkv[:, :, :key_dim].reshape(nb, block_size, heads, key_dim)
    queries = qkv[:, :, key_dim:2 * key_dim].reshape(nb, block_size, heads, key_dim)
    values = qkv[:, :, 2 * key_dim:].reshape(nb, block_size, heads, -1)
    scores = torch.einsum("bkhd,bvhd->bhkv", keys, queries) / (key_dim ** 0.5)

    gid = graph_ids.reshape(nb, block_size)
    vld = valid.reshape(nb, block_size)
    attend = ((gid[:, :, None] == gid[:, None, :]) & vld[:, :, None] & vld[:, None, :])[:, None]  # [nb, 1, k, v]
    scores = torch.where(attend, scores, torch.full((), torch.finfo(scores.dtype).min, dtype=scores.dtype,
                                                     device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(attend.any(dim=-1, keepdim=True), probs, torch.zeros((), dtype=probs.dtype,
                                                                            device=probs.device))
    probs = dropout(probs, dropout_rate, train, generator)
    return torch.einsum("bhkv,bvhd->bkhd", probs, values).reshape(n, heads, -1)


class MultiHeadSelfAttentionMessagePassing(AbstractMessagePassingLayer):
    """Multi-head self-attention among the nodes of a graph, then the
    summarization, LayerNorm and FFN of a transformer layer with residuals.
    ``max_num_nodes`` is the attention block; the batch's ``att_order``
    block width wins where the two differ."""

    def __init__(
        self,
        input_state_dimension: int,
        key_query_dimension: int,
        value_dimension: int,
        output_dimension: int,
        intermediate_dimension: int,
        num_heads: int,
        dropout_rate: float = 0.0,
        target_reference: str = "all",
        max_num_nodes: int = 256,
    ):
        super().__init__()
        self.__input_dim = input_state_dimension
        self.__output_dim = output_dimension
        self.num_heads = num_heads
        self.key_query_dim = key_query_dimension
        self.value_dim = value_dimension
        self.dropout_rate = dropout_rate
        self.target_reference = target_reference
        self.block_size = max_num_nodes
        self._att_width_warned = False
        kaiming = init.kaiming_uniform()
        self.head_transforms = Linear(input_state_dimension, num_heads * (2 * key_query_dimension + value_dimension),
                                      use_bias=False, weight_init=kaiming)
        self.summarization = Linear(num_heads * value_dimension, output_dimension, use_bias=False,
                                    weight_init=kaiming)
        self.intermediate = Linear(output_dimension, intermediate_dimension, weight_init=kaiming)
        self.output = Linear(intermediate_dimension, output_dimension, weight_init=kaiming)
        self.layer_norm1 = LayerNorm(output_dimension)
        self.layer_norm2 = LayerNorm(output_dimension)

    def _att_order_width(self, att_order: torch.Tensor) -> int:
        width = att_order.shape[1]
        if width != self.block_size and not self._att_width_warned:
            LOGGER.warning(
                "Self-attention layer max_num_nodes=%d but the batch packs attention blocks of %d nodes; "
                "using the batch's block width (set BatchPadding.att_block to match the layer to silence this).",
                self.block_size, width,
            )
            self._att_width_warned = True
        return width

    # Under node sharding the layer all-gathers the node states, attends over
    # the global packing (the single-device computation) and keeps this
    # rank's rows: one O(N x D) gather for this layer alone. Reference sets
    # carry global ids, so the reference-subset mode resolves them in the
    # gathered table too. It reads no receive buffer (no exchange).
    needs_boundary_exchange = False

    def forward(self, node_states: torch.Tensor, ctx: GraphContext, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        ns = ctx.node_sharding
        if ns is not None:
            from ptgnn_tpu_torch.parallel.collectives import all_gather_rows

            global_ctx = ctx._replace(node_graph=ns.node_graph_global, node_mask=ns.node_mask_global,
                                      att_order=ns.att_order_global, node_sharding=None)
            out = self.forward(all_gather_rows(ns.h_local, ns.group), global_ctx, train=train, generator=generator)
            local = out[ns.shard_index * ns.rows_per:(ns.shard_index + 1) * ns.rows_per]
            return torch.cat([local, local.new_zeros((node_states.shape[0] - ns.rows_per, local.shape[1]))])
        n = node_states.shape[0]
        order = None
        att_width = self.block_size
        if self.target_reference == "all":
            if ctx.att_order is not None:
                # Gather the rows in the batch's packing, attend, scatter the
                # rows back; padding slots (order >= n) drop.
                att_width = self._att_order_width(ctx.att_order)
                order = ctx.att_order.reshape(-1).long()
                in_range = order < n
                safe = order.clamp(max=n - 1)
                relevant = take_rows(node_states, safe)
                graph_ids = torch.where(in_range, ctx.node_graph.index_select(0, safe),
                                        torch.full((), -1, dtype=ctx.node_graph.dtype, device=order.device))
                valid = in_range & ctx.node_mask.index_select(0, safe)
            else:
                relevant, graph_ids, valid = node_states, ctx.node_graph, ctx.node_mask
        else:
            ref = ctx.references[self.target_reference]
            relevant = take_rows(node_states, ref.node_ids)
            graph_ids = torch.where(ref.mask, ref.graph_ids, torch.full((), -1, dtype=ref.graph_ids.dtype,
                                                                          device=ref.mask.device))
            valid = ref.mask

        r = relevant.shape[0]
        block = min(att_width, r)
        pad = (-r) % block
        relevant_p, graph_ids_p, valid_p = relevant, graph_ids, valid
        if pad:
            relevant_p = torch.cat([relevant, relevant.new_zeros((pad, relevant.shape[1]))])
            graph_ids_p = torch.cat([graph_ids, graph_ids.new_full((pad,), -1)])
            valid_p = torch.cat([valid, valid.new_zeros((pad,))])

        qkv = self.head_transforms(relevant_p).reshape(relevant_p.shape[0], self.num_heads, -1)
        att = _block_attention(
            qkv, graph_ids_p, valid_p, key_dim=self.key_query_dim, block_size=block,
            dropout_rate=self.dropout_rate, train=train, generator=generator,
        )[:r]  # [r, heads, vd]
        output = dropout(self.summarization(att.reshape(r, -1)), self.dropout_rate, train, generator)
        attention_output = self.layer_norm1(output + relevant)
        intermediate = torch.relu(self.intermediate(attention_output))
        out = dropout(self.output(intermediate), self.dropout_rate, train, generator)
        output_node_states = self.layer_norm2(out + attention_output)

        if self.target_reference == "all":
            if order is None:
                return output_node_states
            rows = torch.where(in_range, order, torch.full((), n, dtype=order.dtype, device=order.device))
            return output_node_states.new_zeros((n + 1, output_node_states.shape[1])).index_copy(
                0, rows, output_node_states)[:n]
        # The updated reference rows back in place; padding rows go to an
        # out-of-range row that is cut off.
        rows = torch.where(ref.mask, ref.node_ids, torch.full((), n, dtype=ref.node_ids.dtype,
                                                             device=ref.mask.device)).long()
        padded = torch.cat([node_states, node_states.new_zeros((1, node_states.shape[1]))])
        return padded.index_copy(0, rows, output_node_states.to(node_states.dtype))[:n]

    @property
    def input_state_dimension(self) -> int:
        return self.__input_dim

    @property
    def output_state_dimension(self) -> int:
        return self.__output_dim
