"""Fused typed-message computation + aggregation with a scatter-free backward.

The hot loop of every message-passing layer:

    gather source (and target) node states per edge
    -> per-edge-type linear message (one tile-batched matmul)
    -> masked segment reduce to receivers.

The counterpart of the JAX package's ``ops/fused_mp.py``. Target-state rows
are receiver-keyed and block-local in the unified layout, so they come from
the broadcast kernel; the reduction runs the segment kernels.

The backward is the JAX package's scatter-free one. The batcher stores every
edge's transpose (u -> v, t) <-> (v -> u, t + T), so the sender-keyed
gradient of an edge's source input is re-derived on its transpose slot,
where it is receiver-keyed: each slot acts as the carrier of its pair edge,
whose message, routing weights and dropout mask are recomputed from rows
gathered through the slot's own endpoints. Forward and backward are built
from gathers, tile matmuls and the three segment kernels only; no [E, D]
scatter runs. For max/min the cotangent is split evenly among tied extrema
(jax ``segment_max`` semantics), with the ties found by comparing messages
recomputed bitwise from the saved forward input against the aggregated
extremum, in both orientations.

With ``argmax_routing`` (the JAX package's ``PTGNN_TPU_ARGMAX_ROUTING``), max
and min instead route each (node, column)'s cotangent to one slot: the first
that attains the extremum (torch-scatter's ``scatter_max``, which the
original ptgnn trains with). The forward's argmax extremum kernel returns
the winning slots; the backward selects by slot id in the primary
orientation, and by the winner's (pair id, type) in the transpose one: no
tie count, no message recompute.

Message-input dropout is keyed on the DIRECTED (src, dst, type) identity by
a uint32 hash (``ops/keyed_dropout.py``: the keyed dropout kernel on the
card, in one uint32 pass from the slot's endpoint ids; the plain int64
version elsewhere), so the transpose orientation regenerates the mask its
pair edge used, and the mask equals the JAX package's bit for bit. Each
mask made and applied, its edge keys included, sits between the phase
marks ``KEYED_BEGIN`` and ``KEYED_END`` (``utils/tracing.py``), and its
elements are counted in the counter table as ``keyed_dropout_elements``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ptgnn_tpu_torch.ops.keyed_dropout import EdgeIds, keyed_dropout
from ptgnn_tpu_torch.ops.segment import masked_take
from ptgnn_tpu_torch.ops.segment_kernels import (
    adjacency_broadcast_to_edges,
    adjacency_segment_reduce,
    plan_from_adjacency,
    planned_segment_extremum_with_argmax,
)
from ptgnn_tpu_torch.ops.typed_linear import (
    typed_tile_matmul,
    typed_weight_gradient,
    typed_weight_gradient_plain,
    use_typed_dw_kernel,
)
from ptgnn_tpu_torch.utils import tracing

_BIG = 3.0e38

Dropout = Optional[Tuple[torch.Tensor, EdgeIds, float]]  # (seed, the edges' ids, keep)


def _apply_keyed_dropout(x: torch.Tensor, drop: Dropout, col_offset: int = 0) -> torch.Tensor:
    if drop is None:
        return x
    seed, ids, keep = drop
    tracing.mark(tracing.KEYED_BEGIN, x.device)
    tracing.count("keyed_dropout_elements", n=x.shape[0] * x.shape[1])
    out = keyed_dropout(x, seed, ids, keep, col_offset)
    tracing.mark(tracing.KEYED_END, x.device)
    return out


def _forward_ids(adj) -> EdgeIds:
    """Each slot's own directed edge: (sender, receiver, type)."""
    return EdgeIds(adj.senders, adj.receivers, adj.edge_types)


def _transpose_ids(adj) -> EdgeIds:
    """The PAIR edge a slot carries, from its own endpoints: (receiver,
    sender, the tile's transposed type)."""
    return EdgeIds(adj.receivers, adj.senders, adj.tile_types_transposed, adj.edge_tile)


def _senders(adj, n: int) -> torch.Tensor:
    # Padding slots' ids may be out of range: clamp; the slots are masked.
    return adj.senders.clamp(max=n - 1).long()


def _compute_dtype(node_states: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if node_states.dtype == torch.bfloat16 else torch.float32


def _fused_fwd_impl(node_states, weight_stack, adj, seed, num_nodes, reduction, use_target_state, keep,
                    argmax_routing=False):
    """(aggregated messages, the winning slots of argmax routing or None, the
    dropped-out message input)."""
    inp = node_states.index_select(0, _senders(adj, node_states.shape[0]))
    if use_target_state:
        # Receiver rows from the broadcast (0 at padding slots).
        inp = torch.cat([inp, adjacency_broadcast_to_edges(node_states.contiguous(), adj)], dim=-1)
    if keep < 1.0:
        inp = _apply_keyed_dropout(inp, (seed, _forward_ids(adj), keep))
    msgs = typed_tile_matmul(inp, weight_stack, adj.tile_types, adj.edge_tile)
    if argmax_routing and reduction in ("max", "min"):
        # The backward resolves each winner's transpose slot by its fwd/bwd
        # pair id; the port's batcher numbers them in every batch, those
        # with featureless graphs among featured ones included.
        if adj.edge_pair_id is None:
            raise ValueError("argmax routing needs the batch's edge_pair_id (fwd/bwd pair ids)")
        is_max = reduction == "max"
        neutral = torch.full((), -_BIG if is_max else _BIG, dtype=msgs.dtype, device=msgs.device)
        work = torch.where(adj.mask[:, None], msgs, neutral)
        if work.dtype not in (torch.float32, torch.bfloat16):
            work = work.float()
        vals, args = planned_segment_extremum_with_argmax(
            work.contiguous(), plan_from_adjacency(adj), num_nodes, is_max
        )
        return vals.to(msgs.dtype), args, inp
    # The mask is the batch's static one, so the plan's counts are exact.
    out = adjacency_segment_reduce(msgs, adj, num_nodes, reduction, mask=adj.mask, counts_exact=True)
    return out, None, inp


def _primary_indicator(inp, weight_stack, adj, out, dtype) -> torch.Tensor:
    """[E, M] 1 where a slot's message equals its receiver's extremum. The
    messages are reproduced bitwise from the saved input by the forward's
    own tile matmul; the extremum rows come from the broadcast."""
    msgs = typed_tile_matmul(inp, weight_stack, adj.tile_types, adj.edge_tile)
    out_e = adjacency_broadcast_to_edges(out.contiguous(), adj).float()
    return ((msgs.float() == out_e) & adj.mask[:, None]).to(dtype)


def _transpose_indicator(x_recv, x_send, weight_stack, adj, out_send, drop_tr, dtype) -> torch.Tensor:
    """[E, M] 1 where the PAIR edge carried by a slot attains the extremum at
    the pair's receiver (the slot's sender): the pair's message recomputed in
    the transpose orientation from the slot's own endpoint rows."""
    inp_tr = x_recv if x_send is None else torch.cat([x_recv, x_send], dim=-1)
    inp_tr = _apply_keyed_dropout(inp_tr, drop_tr)
    msgs_tr = typed_tile_matmul(inp_tr, weight_stack, adj.tile_types_transposed, adj.edge_tile)
    return ((msgs_tr.float() == out_send) & adj.mask[:, None]).to(dtype)


def _primary_winners(args, adj, dtype) -> torch.Tensor:
    """[E, M] 1 where a slot is its receiver's winning slot (argmax routing).
    Padding receivers read -2, which no slot id equals; padding slots are
    masked by the caller."""
    arg_e = masked_take(args, adj.receivers, -2)
    slots = torch.arange(arg_e.shape[0], dtype=arg_e.dtype, device=arg_e.device)[:, None]
    return (slots == arg_e).to(dtype)


def _transpose_winners(args, adj, dtype) -> torch.Tensor:
    """[E, M] 1 where the PAIR edge carried by a slot is the winner at the
    pair's receiver (the slot's sender): the winning slot's (pair id, type)
    equals this slot's (pair id, transposed type). A self edge is its own
    pair, with pair id -1: its winner matches only a self edge of the same
    type."""
    pair = adj.edge_pair_id
    m = args.shape[1]
    flat = args.reshape(-1)
    of_arg = torch.cat([
        masked_take(pair, flat, -7).reshape(args.shape),
        masked_take(adj.edge_types, flat, -7).reshape(args.shape),
    ], dim=1)  # [N, 2M]: the winner's pair id and type
    at_sender = masked_take(of_arg, adj.senders, -8)
    tau = adj.tile_types_transposed.repeat_interleave(adj.edge_tile)
    return ((pair[:, None] == at_sender[:, :m]) & (tau[:, None] == at_sender[:, m:])).to(dtype)


def _use_masked_dw_route(n_tiles: int, e_pad: int, din: int, m: int, num_types: int, itemsize: int) -> bool:
    """The dW route by device-memory traffic: the per-tile route writes and
    reads an [n_tiles, Din, M] float32 intermediate; the per-type masked
    dots read both operands once per type."""
    per_tile_traffic = 2 * n_tiles * din * m * 4
    masked_traffic = num_types * e_pad * (din + m) * itemsize
    return masked_traffic < per_tile_traffic


def _weight_gradient(inp, d_msgs, weight_stack, adj, compute_dtype) -> torch.Tensor:
    """dW[t] = sum over slots of type t of inp^T d_msgs, float32 accumulation
    (padding slots carry d_msgs == 0). bf16 takes the typed dW (the kernel
    on the card) where its gate opens; elsewhere the per-type masked dots or
    the per-tile route, by traffic."""
    tile = adj.edge_tile
    n_tiles = adj.tile_types.shape[0]
    din, m = inp.shape[1], d_msgs.shape[1]
    num_types = weight_stack.shape[0]
    inp_c = inp.to(compute_dtype)
    if use_typed_dw_kernel(inp_c, m):
        return typed_weight_gradient(inp_c, d_msgs, adj.tile_types, tile, num_types).to(weight_stack.dtype)
    itemsize = torch.finfo(compute_dtype).bits // 8
    if _use_masked_dw_route(n_tiles, inp.shape[0], din, m, num_types, itemsize):
        d_w = typed_weight_gradient_plain(inp_c, d_msgs, adj.tile_types, tile, num_types)
    else:
        inp_f, dm_f = inp_c.float(), d_msgs.float()
        per_tile = torch.bmm(
            inp_f.reshape(n_tiles, tile, din).transpose(1, 2), dm_f.reshape(n_tiles, tile, m)
        )  # [n_tiles, Din, M]
        # Sum by tile type as a one-hot matmul: a fixed order, so the same
        # bits on every run (index_add_ on the card adds in atomic order).
        types = torch.arange(num_types, device=inp.device)
        onehot = (types[:, None] == adj.tile_types.long()[None, :]).float()
        d_w = (onehot @ per_tile.reshape(n_tiles, din * m)).reshape(num_types, din, m)
    return d_w.to(weight_stack.dtype)


def _fused_bwd(node_states, weight_stack, adj, seed, out, args, inp, g,
               num_nodes, reduction, use_target_state, keep):
    n, d = node_states.shape
    # The backward runs in the forward's compute dtype (bf16 under AMP);
    # tie indicators are 0/1 and the segment kernels accumulate in float32.
    compute_dtype = _compute_dtype(node_states)
    g = g.to(compute_dtype)
    value_tie = reduction in ("max", "min") and args is None
    tile = adj.edge_tile

    drop = drop_tr = None
    if keep < 1.0:
        drop, drop_tr = (seed, _forward_ids(adj), keep), (seed, _transpose_ids(adj), keep)

    counts_flat = None
    if reduction == "mean":
        counts_flat = adj.agg_counts.reshape(-1)[:num_nodes].float()

    ties = indicator_p = None
    if value_tie:
        indicator_p = _primary_indicator(inp, weight_stack, adj, out, compute_dtype)
        ties = adjacency_segment_reduce(indicator_p, adj, num_nodes, "sum", mask=adj.mask)

    # Every per-slot lookup keyed on the same index vector rides one widened
    # table: receiver-keyed rows through the broadcast kernel (0 at padding
    # slots), sender-keyed rows through one gather (clamped; masked below).
    # The table dtype never downcasts node_states: the transpose recompute
    # must see the forward's exact inputs.
    tab_dtype = torch.promote_types(compute_dtype, node_states.dtype)
    m = g.shape[1]
    recv_parts = [g.to(tab_dtype)]
    send_parts = [g.to(tab_dtype)]
    counts_widened = reduction == "mean" and counts_flat.shape[0] == n
    if counts_widened:
        recv_parts.append(counts_flat[:, None].to(tab_dtype))
        send_parts.append(counts_flat[:, None].to(tab_dtype))
    if value_tie:
        # x by receivers: transpose-message source input; x by senders: its target
        recv_parts += [ties.to(tab_dtype), node_states.to(tab_dtype)]
        send_parts += [ties.to(tab_dtype), out.to(tab_dtype)]
        if use_target_state:
            send_parts.append(node_states.to(tab_dtype))
    senders = _senders(adj, n)
    recv_rows = adjacency_broadcast_to_edges(torch.cat(recv_parts, dim=1).contiguous(), adj)
    send_rows = torch.cat(send_parts, dim=1).index_select(0, senders)
    g_e_recv = recv_rows[:, :m].to(compute_dtype)
    g_e_send = send_rows[:, :m].to(compute_dtype)

    def per_node_divisor(rows, idx, g_e):
        if counts_widened:
            return rows[:, m:m + 1].float().clamp_min(1.0).to(g_e.dtype)
        return masked_take(counts_flat, idx, 1.0).clamp_min(1.0)[:, None].to(g_e.dtype)

    # Primary orientation: the per-slot message cotangent. The broadcast
    # zeroed the padding rows and the tie indicator carries the mask, so no
    # masking select is needed, except for argmax routing's winners.
    if reduction in ("sum", "add"):
        d_msgs = g_e_recv
    elif reduction == "mean":
        d_msgs = g_e_recv / per_node_divisor(recv_rows, adj.receivers, g_e_recv)
    elif args is not None:
        d_msgs = _primary_winners(args, adj, g_e_recv.dtype) * g_e_recv
        d_msgs = torch.where(adj.mask[:, None], d_msgs, torch.zeros((), dtype=d_msgs.dtype, device=d_msgs.device))
    else:
        ties_recv = recv_rows[:, m:2 * m].to(ties.dtype)
        d_msgs = indicator_p * g_e_recv / ties_recv.clamp_min(1.0)

    # Transpose orientation: the cotangent of each slot's PAIR edge.
    if reduction in ("sum", "add"):
        d_msgs_tr = g_e_send
    elif reduction == "mean":
        d_msgs_tr = g_e_send / per_node_divisor(send_rows, adj.senders, g_e_send)
    elif args is not None:
        d_msgs_tr = _transpose_winners(args, adj, g_e_send.dtype) * g_e_send
    else:
        x_recv = recv_rows[:, 2 * m:2 * m + d].to(node_states.dtype)
        x_send = send_rows[:, 3 * m:3 * m + d].to(node_states.dtype) if use_target_state else None
        out_send = send_rows[:, 2 * m:3 * m].float()
        indicator = _transpose_indicator(x_recv, x_send, weight_stack, adj, out_send, drop_tr, compute_dtype)
        ties_send = send_rows[:, m:2 * m].to(ties.dtype)
        d_msgs_tr = indicator * g_e_send / ties_send.clamp_min(1.0)
    d_msgs_tr = torch.where(adj.mask[:, None], d_msgs_tr, torch.zeros((), dtype=d_msgs_tr.dtype, device=d_msgs_tr.device))

    d_w = _weight_gradient(inp, d_msgs, weight_stack, adj, compute_dtype)

    # Each orientation needs one half of its [E, Din] input cotangent (the
    # primary's target part, the transpose's source part): contract against
    # the matching weight columns only, and regenerate only the matching
    # columns of the dropout mask.
    w_t = weight_stack.transpose(1, 2)  # [T, M, Din]
    d_inp_tr_src = _apply_keyed_dropout(
        typed_tile_matmul(d_msgs_tr, w_t[:, :, :d], adj.tile_types_transposed, tile), drop_tr
    )
    if use_target_state:
        target_cotangent = _apply_keyed_dropout(
            typed_tile_matmul(d_msgs, w_t[:, :, d:], adj.tile_types, tile), drop, col_offset=d
        )
        # One sum kernel call aggregates both cotangents: concat, split after.
        combined = torch.cat([target_cotangent, d_inp_tr_src], dim=1)
        agg = adjacency_segment_reduce(combined, adj, num_nodes, "sum", mask=adj.mask)
        d_x = agg[:, :d] + agg[:, d:]
    else:
        d_x = adjacency_segment_reduce(d_inp_tr_src, adj, num_nodes, "sum", mask=adj.mask)
    return d_x.to(node_states.dtype), d_w


class _FusedTypedMessageAggregation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, node_states, weight_stack, adj, seed, num_nodes, reduction, use_target_state, keep,
                argmax_routing):
        out, args, inp = _fused_fwd_impl(
            node_states, weight_stack, adj, seed, num_nodes, reduction, use_target_state, keep, argmax_routing
        )
        # The dropped-out message input is the one [E, Din] residual, as in
        # the JAX package; messages are recomputed where the ties need them.
        ctx.save_for_backward(node_states, weight_stack, out, inp, args)
        ctx.adj = adj
        ctx.seed = seed
        ctx.config = (num_nodes, reduction, use_target_state, keep)
        return out

    @staticmethod
    def backward(ctx, g):
        node_states, weight_stack, out, inp, args = ctx.saved_tensors
        d_x, d_w = _fused_bwd(node_states, weight_stack, ctx.adj, ctx.seed, out, args, inp, g, *ctx.config)
        return d_x, d_w, None, None, None, None, None, None, None


def fused_typed_message_aggregation(
    node_states: torch.Tensor,  # [N, D]
    weight_stack: torch.Tensor,  # [T_total, Din, M]
    adj,
    num_nodes: int,
    reduction: str,
    use_target_state: bool,
    dropout_keep: float = 1.0,
    seed: Optional[torch.Tensor] = None,
    argmax_routing: bool = False,
) -> torch.Tensor:
    """[num_nodes, M] aggregated messages. ``dropout_keep < 1`` drops message
    inputs by the keyed mask of ``seed`` (an integer in [0, 2**32)).
    ``argmax_routing``: max/min route each cotangent to the first winning
    slot alone instead of splitting it among ties."""
    if reduction not in ("sum", "add", "mean", "max", "min"):
        raise ValueError(f"Unknown reduction '{reduction}'")
    if dropout_keep < 1.0 and seed is None:
        raise ValueError("keyed message dropout needs a seed")
    return _FusedTypedMessageAggregation.apply(
        node_states, weight_stack, adj, seed, num_nodes, reduction, use_target_state, dropout_keep,
        argmax_routing,
    )


@torch.no_grad()
def tie_counts(
    node_states: torch.Tensor,
    weight_stack: torch.Tensor,
    adj,
    reduction: str = "max",
    use_target_state: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, M] float32 count of the slots attaining each (node, column)'s
    extremum, found as the backward finds them: in the primary orientation,
    and in the transpose orientation (summed by sender). Both must be >= 1
    wherever the node has in-edges, or that gradient would vanish."""
    n = node_states.shape[0]
    dtype = _compute_dtype(node_states)
    out, _, inp = _fused_fwd_impl(node_states, weight_stack, adj, None, n, reduction, use_target_state, 1.0)
    ties = adjacency_segment_reduce(
        _primary_indicator(inp, weight_stack, adj, out, dtype), adj, n, "sum", mask=adj.mask
    )
    senders = _senders(adj, n)
    x_recv = adjacency_broadcast_to_edges(node_states.contiguous(), adj)
    x_send = node_states.index_select(0, senders) if use_target_state else None
    indicator = _transpose_indicator(
        x_recv, x_send, weight_stack, adj, out.index_select(0, senders).float(), None, dtype
    )
    ties_tr = torch.zeros((n, out.shape[1]), dtype=torch.float32, device=out.device)
    ties_tr.index_add_(0, senders, indicator.float())
    return ties.float(), ties_tr
