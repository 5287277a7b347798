"""Receiver-aligned node-sharded model parallelism: the nodes of one batch,
and the edges into them, split over the ranks of a process group. The
counterpart of the JAX package's ``parallel/node_sharding.py``.

* Rank ``s`` of the node group owns node rows ``[s * rows_per, (s + 1) *
  rows_per)`` of the flattened batch and every edge whose receiver lies in
  them. The layout is receiver-major, so each rank's aggregation is complete
  on its own: no reduction crosses ranks.
* What crosses ranks is only the boundary SENDER rows that a rank reads:
  per layer one ``all_to_all`` of ``[S, b, D]`` gathered rows.
* Each rank's edges form an INTERIOR layout (senders it owns) and a
  BOUNDARY layout (senders in the receive buffer), each a valid unified
  layout with its own aggregation plan and row index, so the row-indexed
  kernels (K1 sums, K2 extrema, K3 receiver rows) run on each.

A rank's node arrays hold ``rows_per + S * b`` rows, so a graph larger than
one card trains by raising the shard count.

The host side (:func:`shard_batch_by_nodes`, :func:`suggest_budgets`, the
reorder) is numpy and gives the JAX package's arrays bitwise, plus the
port's row index of each sub-layout. Unlike the JAX package, the node-
aligned arrays of a minibatch outside its batch (PPI's ``targets``) are
permuted with the nodes under a reorder, where the caller names them
(``node_aligned``); the JAX package leaves them in the old order.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ptgnn_tpu_torch.graph.batching import (
    assemble_layout_arrays,
    _seg_counts_of,
    build_adjacency_struct,
    required_edge_slots,
)
from ptgnn_tpu_torch.graph.messagepassing.base import live_in_degree
from ptgnn_tpu_torch.graph.structs import AdjacencyStruct, GraphBatch
from ptgnn_tpu_torch.nn.layers import dropout
from ptgnn_tpu_torch.ops.segment import take_rows
from ptgnn_tpu_torch.ops.segment_kernels import (
    AggregationPlan,
    adjacency_segment_reduce,
    broadcast_to_edges,
    sum_plan_from_adjacency,
    with_row_index,
)
from ptgnn_tpu_torch.ops.typed_linear import typed_tile_matmul
from ptgnn_tpu_torch.parallel.collectives import all_to_all
from ptgnn_tpu_torch.parallel.dp import LOCAL, DataParallel, base_rates

__all__ = [
    "BoundaryBudgetError",
    "GroupExchange",
    "NodeParallel",
    "NodeShardCtx",
    "NodeShardingData",
    "exchange_boundary",
    "local_shard",
    "merged_adjacency",
    "node_sharded_linear_message_aggregation",
    "shard_batch_by_nodes",
    "suggest_budgets",
]


class BoundaryBudgetError(ValueError):
    """A shard's interior/boundary slots or per-pair boundary-node budget is
    too small for this batch. The required sizes are attributes
    (``required_boundary_budget``, ``required_interior_slots``,
    ``required_boundary_slots``) as well as in the message."""

    def __init__(self, msg: str, *, boundary_budget: int = 0, interior_slots: int = 0, boundary_slots: int = 0):
        super().__init__(msg)
        self.required_boundary_budget = boundary_budget
        self.required_interior_slots = interior_slots
        self.required_boundary_slots = boundary_slots


class NodeShardingData(NamedTuple):
    """The sharding payload on ``GraphBatch.node_sharding``. As
    :func:`shard_batch_by_nodes` returns it every array has a leading
    ``[S]`` axis except the ``*_global`` fields; :func:`local_shard` takes
    one rank's slice."""

    adjacency_bnd: AdjacencyStruct  # senders index the [S * b] receive buffer
    send_idx: Any  # [S, b] int32: local rows this shard sends to each destination
    node_graph_global: Any  # [N_pad] int32
    node_mask_global: Any  # [N_pad] bool
    boundary_counts: Any  # [S] int32: real boundary rows this shard sends to each destination
    # The global [n_blocks, att_block] attention packing (renumbered under a
    # reorder), or None: the self-attention layer's node-sharded path reads it.
    att_order_global: Any = None


class NodeShardCtx(NamedTuple):
    """A layer's view of node sharding (``GraphContext.node_sharding``)."""

    group: Any  # the node group
    shard_index: int  # this rank's index in it
    rows_per: int
    adj_int: AdjacencyStruct  # interior layout
    adj_bnd: AdjacencyStruct  # boundary layout
    h_local: torch.Tensor  # [rows_per, D] the layer's input rows
    recv: torch.Tensor  # [S * b, D] boundary sender rows (after the exchange)
    node_graph_global: Any  # [N_pad] int32
    node_mask_global: Any  # [N_pad] bool
    att_order_global: Any = None


# ---------------------------------------------------------------------------
# Host side: resharding a finalized minibatch
# ---------------------------------------------------------------------------
def _bfs_locality_order(senders: np.ndarray, receivers: np.ndarray, node_graph: np.ndarray,
                        node_mask: np.ndarray) -> np.ndarray:
    """A bandwidth-reducing node order (reverse Cuthill-McKee over the
    batch's undirected edges; the graphs are separate components, so each
    keeps its locality). A contiguous-range partition cuts the edges that
    cross range boundaries, so the exchange volume is the bandwidth of the
    numbering. Returns ``perm`` with ``perm[new_row] == old_row``; padding
    rows go last. Without scipy, a per-graph breadth-first search."""
    n_pad = len(node_mask)
    try:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:
        return _bfs_order_python(senders, receivers, node_graph, node_mask)
    und_src = np.concatenate([senders, receivers])
    und_dst = np.concatenate([receivers, senders])
    m = coo_matrix((np.ones(len(und_src), np.int8), (und_src, und_dst)), shape=(n_pad, n_pad)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True), np.int64)
    # keep padding rows at the tail (RCM takes isolated rows for components
    # of their own and may interleave them)
    masked = node_mask[perm]
    return np.concatenate([perm[masked], perm[~masked]])


def _bfs_order_python(senders, receivers, node_graph, node_mask) -> np.ndarray:
    from collections import deque

    n_pad = len(node_mask)
    und_src = np.concatenate([senders, receivers])
    und_dst = np.concatenate([receivers, senders])
    order_e = np.argsort(und_src, kind="stable")
    und_dst = und_dst[order_e]
    starts = np.searchsorted(und_src[order_e], np.arange(n_pad + 1))
    visited = np.zeros(n_pad, bool)
    perm = np.empty(n_pad, np.int64)
    pos = 0
    for seed in np.nonzero(node_mask)[0]:
        if visited[seed]:
            continue
        g = node_graph[seed]
        visited[seed] = True
        dq = deque([int(seed)])
        while dq:
            u = dq.popleft()
            perm[pos] = u
            pos += 1
            for v in und_dst[starts[u]:starts[u + 1]]:
                if not visited[v] and node_mask[v] and node_graph[v] == g:
                    visited[v] = True
                    dq.append(int(v))
    perm[pos:] = np.nonzero(~visited)[0]  # padding rows
    return perm


def _boundary_rows_under(senders, receivers, rows_per: int, num_shards: int) -> int:
    """The distinct (sender row, reader shard) pairs that a contiguous-range
    partition exchanges: what the budgets pay for."""
    ss = senders // rows_per
    rs = receivers // rows_per
    cross = ss != rs
    if not cross.any():
        return 0
    return len(np.unique(senders[cross].astype(np.int64) * num_shards + rs[cross]))


def shard_batch_by_nodes(
    minibatch: Dict[str, Any],
    num_shards: int,
    *,
    boundary_budget: int,
    interior_slots: int,
    boundary_slots: int,
    num_fwd_edge_types: Optional[int] = None,
    introduce_backwards_edges: bool = False,
    reorder: Optional[str] = "auto",
    node_aligned: Sequence[str] = (),
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reshard one finalized (host numpy) minibatch receiver-aligned.
    Returns (sharded minibatch, exchange stats). The budgets are static, so
    every batch of a configuration has one shape:
      * ``interior_slots`` / ``boundary_slots``: padded edge slots per shard;
      * ``boundary_budget``: boundary sender rows per ordered shard pair.
    Raises :class:`BoundaryBudgetError` with the required sizes when one is
    exceeded.

    ``reorder``: the node numbering the partition cuts (message passing is
    permutation-equivariant, so results do not change): ``"auto"`` keeps
    whichever of the batch's order and the BFS renumbering exchanges fewer
    boundary rows, ``"bfs"`` always renumbers, None never does. Under a
    renumbering the minibatch entries named in ``node_aligned`` (arrays of
    ``max_nodes`` rows) are permuted with the nodes."""
    batch: GraphBatch = minibatch["batch"]
    adj = batch.adjacency
    n_pad = batch.node_graph.shape[0]
    S = num_shards
    if n_pad % S:
        raise ValueError(f"max_nodes ({n_pad}) does not divide into {S} node shards")
    rows_per = n_pad // S
    tile = adj.edge_tile
    # The sub-layouts are assembled afresh with the batch's agg_rows where it
    # divides the shard, else the largest power-of-two divisor below it.
    r = min(adj.agg_rows, rows_per)
    while rows_per % r:
        r //= 2
    if r < 8:
        raise ValueError(f"rows per shard ({rows_per}) leave no usable agg_rows (from {adj.agg_rows})")
    align = tile
    if adj.super_tile_row_blocks is not None:
        align = adj.senders.shape[0] // adj.super_tile_row_blocks.shape[0]
    num_types = int(adj.edge_types.max()) + 1 if adj.edge_types.size else 1
    b = boundary_budget
    if interior_slots % tile or boundary_slots % tile:
        raise ValueError(f"edge slot budgets must be multiples of the edge tile {tile}")

    mask = np.asarray(adj.mask)
    real = np.nonzero(mask)[0]
    s_arr = np.asarray(adj.senders)[real]
    r_arr = np.asarray(adj.receivers)[real]
    t_arr = np.asarray(adj.edge_types)[real]
    f_arr = (np.asarray(adj.edge_feature_slot)[real] if adj.edge_feature_slot is not None
             else np.full(len(real), -1, np.int32))

    node_graph_h = np.asarray(batch.node_graph)
    node_mask_h = np.asarray(batch.node_mask)
    perm = inv = None
    if reorder in ("bfs", "auto"):
        perm = _bfs_locality_order(s_arr, r_arr, node_graph_h, node_mask_h)
        inv = np.empty(n_pad + 1, np.int64)
        inv[perm] = np.arange(n_pad)
        inv[n_pad] = n_pad  # padded references point past the end
        if reorder == "auto":
            before = _boundary_rows_under(s_arr, r_arr, rows_per, S)
            after = _boundary_rows_under(inv[s_arr], inv[r_arr], rows_per, S)
            if before <= after:
                perm = inv = None
        if perm is not None:
            s_arr = inv[s_arr]
            r_arr = inv[r_arr]
            node_graph_h = node_graph_h[perm]
            node_mask_h = node_mask_h[perm]
    elif reorder is not None:
        raise ValueError(f"unknown reorder mode {reorder!r}")

    recv_shard = r_arr // rows_per
    send_shard = s_arr // rows_per
    pair_lists: Dict[Tuple[int, int], np.ndarray] = {}
    int_layouts: List[Tuple[np.ndarray, ...]] = []
    bnd_layouts: List[Tuple[np.ndarray, ...]] = []
    max_pair = req_int = req_bnd = 0
    num_blocks_local = rows_per // r
    for s in range(S):
        mine = recv_shard == s
        interior = mine & (send_shard == s)
        boundary = mine & (send_shard != s)
        ri = (r_arr[interior] - s * rows_per).astype(np.int32)
        si = (s_arr[interior] - s * rows_per).astype(np.int32)
        ti = t_arr[interior].astype(np.int32)
        fi = f_arr[interior].astype(np.int32)
        rb = (r_arr[boundary] - s * rows_per).astype(np.int32)
        sb_global = s_arr[boundary]
        tb = t_arr[boundary].astype(np.int32)
        fb = f_arr[boundary].astype(np.int32)
        owners = send_shard[boundary]
        # receive-buffer index: owner * b + the sender's rank in the sorted
        # unique list of the pair, the list the owner's send_idx is built from
        sb_local = np.zeros(len(sb_global), np.int32)
        for o in range(S):
            if o == s:
                continue
            sel = owners == o
            uniq = np.unique(sb_global[sel])
            pair_lists[(o, s)] = uniq
            max_pair = max(max_pair, len(uniq))
            if len(uniq) > b:
                continue  # raised after the whole scan, with every requirement
            sb_local[sel] = o * b + np.searchsorted(uniq, sb_global[sel]).astype(np.int32)
        req_int = max(req_int, required_edge_slots(_seg_counts_of(ri, ti, r, num_types), tile=tile, align=align,
                                                   num_blocks=num_blocks_local))
        req_bnd = max(req_bnd, required_edge_slots(_seg_counts_of(rb, tb, r, num_types), tile=tile, align=align,
                                                   num_blocks=num_blocks_local))
        int_layouts.append((si, ri, ti, fi))
        bnd_layouts.append((sb_local, rb, tb, fb))

    if max_pair > b or req_int > interior_slots or req_bnd > boundary_slots:
        raise BoundaryBudgetError(
            f"node-sharding budgets too small for this batch: needs boundary_budget>={max_pair} (have {b}), "
            f"interior_slots>={req_int} (have {interior_slots}), boundary_slots>={req_bnd} (have {boundary_slots})",
            boundary_budget=max_pair, interior_slots=req_int, boundary_slots=req_bnd,
        )

    def assemble(arrays, e_pad, sender_domain):
        si, ri, ti, fi = arrays
        out = assemble_layout_arrays(si, ri, ti, fi, max_nodes=rows_per, e_pad=e_pad, tile=tile, agg_rows=r,
                                      num_types=num_types, align=align, sender_domain=sender_domain)
        return build_adjacency_struct(out, tile=tile, align=align, num_fwd_types=num_fwd_edge_types or num_types,
                                      introduce_backwards_edges=introduce_backwards_edges)

    adj_int = [assemble(a, interior_slots, rows_per) for a in int_layouts]
    adj_bnd = [assemble(a, boundary_slots, S * b) for a in bnd_layouts]
    send_idx = np.zeros((S, S, b), np.int32)
    boundary_counts = np.zeros((S, S), np.int32)
    for (o, d), uniq in pair_lists.items():
        send_idx[o, d, :len(uniq)] = uniq - o * rows_per
        boundary_counts[o, d] = len(uniq)

    g_pad = batch.graph_mask.shape[0]
    node_graph = node_graph_h.reshape(S, rows_per)
    node_mask_sh = node_mask_h.reshape(S, rows_per)
    node_graph_ext = np.concatenate([node_graph, np.full((S, S * b), g_pad, node_graph.dtype)], axis=1)
    node_mask_ext = np.concatenate([node_mask_sh, np.zeros((S, S * b), bool)], axis=1)

    def permuted(x):
        x = np.asarray(x)
        if x.shape[0] != n_pad:
            raise ValueError(f"a node-aligned array of {x.shape[0]} rows != max_nodes {n_pad} cannot be node-sharded")
        return x if perm is None else x[perm]

    def slice_nodes(x):
        x = permuted(x)
        return x.reshape((S, rows_per) + x.shape[1:])

    references = batch.references
    if perm is not None and references:
        def remap_ref(ref):
            ids = np.asarray(ref.node_ids)
            new_ids = np.where(np.asarray(ref.mask), inv[np.clip(ids, 0, n_pad)], ids)
            return ref._replace(node_ids=new_ids.astype(ids.dtype))

        references = {k: remap_ref(v) for k, v in references.items()}

    att_order_global = batch.att_order
    if att_order_global is not None:
        att_order_global = np.asarray(att_order_global)
        if perm is not None:  # node ids; padding slots hold n_pad
            att_order_global = np.where(att_order_global < n_pad, inv[np.minimum(att_order_global, n_pad)],
                                        att_order_global).astype(att_order_global.dtype)

    sharded_batch = batch._replace(
        node_data=_tree_map(slice_nodes, batch.node_data),
        adjacency=_stack(adj_int),
        node_graph=node_graph_ext,
        node_mask=node_mask_ext,
        references=references,
        att_order=None,
        node_sharding=NodeShardingData(
            adjacency_bnd=_stack(adj_bnd), send_idx=send_idx, node_graph_global=node_graph_h,
            node_mask_global=node_mask_h, boundary_counts=boundary_counts, att_order_global=att_order_global,
        ),
    )
    out = {**minibatch, "batch": sharded_batch}
    for key in node_aligned:
        out[key] = permuted(minibatch[key])
    total_boundary = int(boundary_counts.sum())
    stats = {
        "num_shards": S,
        "rows_per_shard": rows_per,
        "rows_ext": rows_per + S * b,
        "boundary_nodes_total": total_boundary,
        "boundary_budget_used": int(boundary_counts.max()),
        "boundary_budget": b,
        # rows per layer and direction; the padded figure is what the static
        # all_to_all ships
        "exchanged_rows_real": total_boundary,
        "exchanged_rows_padded": S * (S - 1) * b,
        "interior_slots_required": req_int,
        "boundary_slots_required": req_bnd,
        # the port's own: perm[new_row] == old_row under a reorder, else None
        "permutation": perm,
    }
    return out, stats


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _stack(adjs: List[AdjacencyStruct]) -> AdjacencyStruct:
    return AdjacencyStruct(*(None if xs[0] is None else np.stack(xs) for xs in zip(*adjs)))


def local_shard(sharded_minibatch: Dict[str, Any], shard: int) -> Dict[str, Any]:
    """Rank ``shard``'s view of a minibatch from :func:`shard_batch_by_nodes`:
    its node rows, its interior and boundary layouts, its send lists."""
    batch: GraphBatch = sharded_minibatch["batch"]
    ns: NodeShardingData = batch.node_sharding
    take = lambda x: None if x is None else x[shard]  # noqa: E731
    local = batch._replace(
        node_data=_tree_map(take, batch.node_data),
        adjacency=_tree_map(take, batch.adjacency),
        node_graph=batch.node_graph[shard],
        node_mask=batch.node_mask[shard],
        node_sharding=ns._replace(adjacency_bnd=_tree_map(take, ns.adjacency_bnd), send_idx=ns.send_idx[shard],
                                  boundary_counts=ns.boundary_counts[shard]),
    )
    return {**sharded_minibatch, "batch": local}


def suggest_budgets(minibatches, num_shards: int, *, reorder: Optional[str] = "auto") -> Dict[str, int]:
    """The smallest static budgets (slots rounded up to the edge tile) that
    fit every one of the finalized ``minibatches``. ``reorder`` must be what
    the later :func:`shard_batch_by_nodes` calls use."""
    b = e_int = e_bnd = 0
    tile = None
    for mb in minibatches:
        adj = mb["batch"].adjacency
        tile = adj.edge_tile if tile is None else tile
        try:
            shard_batch_by_nodes(mb, num_shards, boundary_budget=1, interior_slots=tile, boundary_slots=tile,
                                 reorder=reorder)
        except BoundaryBudgetError as exc:
            b = max(b, exc.required_boundary_budget)
            e_int = max(e_int, exc.required_interior_slots)
            e_bnd = max(e_bnd, exc.required_boundary_slots)
    tile = tile or 128

    def ceil(n, k):
        return -(-max(n, 1) // k) * k

    return {"boundary_budget": max(b, 8), "interior_slots": ceil(e_int, tile), "boundary_slots": ceil(e_bnd, tile)}


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------
def exchange_boundary(h_local: torch.Tensor, send_idx: torch.Tensor, group: Any) -> torch.Tensor:
    """One boundary exchange: gather the rows each destination reads and
    ``all_to_all`` them over the node group. Returns the [S * b, D] receive
    buffer whose rows ``o * b:(o + 1) * b`` came from rank ``o``."""
    buf = take_rows(h_local, send_idx.reshape(-1))
    return all_to_all(buf, group)


class GroupExchange:
    """The boundary exchange over a node group (:func:`exchange_boundary`)
    and this rank's place in the group: what the node-sharded forward calls
    once per layer that reads sender rows."""

    def __init__(self, group: Any):
        self.group = group
        self.shard_index = dist.get_rank(group)
        self.num_shards = dist.get_world_size(group)

    def __call__(self, h_local: torch.Tensor, send_idx: torch.Tensor) -> torch.Tensor:
        return exchange_boundary(h_local, send_idx, self.group)


def merged_adjacency(adj_int: AdjacencyStruct, adj_bnd: AdjacencyStruct, rows_per: int,
                     num_rows: int) -> AdjacencyStruct:
    """One layout over the [local rows ++ receive buffer] table for the
    layers that aggregate per slot (hidden-layer MLPs, PNA, edge features):
    the interior slots, then the boundary slots with their senders shifted
    past ``rows_per``. The port keeps a plan: both halves target the same
    local row blocks, so their tiles concatenate, the in-degrees add, and
    the row index of the concatenation (each row's interior slots, then its
    boundary ones) is built here on the device. Its counts cover
    ``num_rows`` rows (the receive buffer's rows have none), so the
    aggregations give the extended table's row count."""

    def cat(a, b):
        return None if a is None or b is None else torch.cat([a, b], dim=0)

    r = adj_int.agg_counts.shape[1]
    counts = adj_int.agg_counts + adj_bnd.agg_counts
    extra = -(-num_rows // r) - counts.shape[0]
    if extra > 0:
        counts = torch.cat([counts, counts.new_zeros((extra, r))])
    plan = with_row_index(AggregationPlan(cat(adj_int.local_rows, adj_bnd.local_rows),
                                          cat(adj_int.tile_row_blocks, adj_bnd.tile_row_blocks), counts))
    return AdjacencyStruct(
        senders=cat(adj_int.senders, adj_bnd.senders + rows_per),
        receivers=cat(adj_int.receivers, adj_bnd.receivers),
        edge_types=cat(adj_int.edge_types, adj_bnd.edge_types),
        tile_types=cat(adj_int.tile_types, adj_bnd.tile_types),
        mask=cat(adj_int.mask, adj_bnd.mask),
        tile_types_transposed=cat(adj_int.tile_types_transposed, adj_bnd.tile_types_transposed),
        local_rows=plan.local_rows,
        tile_row_blocks=plan.tile_row_blocks,
        agg_counts=counts,
        edge_feature_slot=cat(adj_int.edge_feature_slot, adj_bnd.edge_feature_slot),
        row_offsets=plan.row_offsets,
        row_slots=plan.row_slots,
        edge_pair_id=cat(adj_int.edge_pair_id, adj_bnd.edge_pair_id),
    )


def node_sharded_linear_message_aggregation(
    weight_stack: torch.Tensor,
    ctx,
    *,
    reduction: str,
    use_target_state: bool,
    dropout_rate: float,
    train: bool,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """A single typed linear message and its aggregation under node
    sharding: the interior and the boundary slots each run gather -> K3
    receiver rows -> typed matmul (K5 where its gate opens) -> K1 or K2 over
    their own plan, and the two partial aggregates combine. The interior
    pass reads nothing of the exchange. Returns the aggregate padded to the
    caller's extended row count."""
    ns: NodeShardCtx = ctx.node_sharding
    rows_per = ns.rows_per
    exact = ctx.edge_mask_is_static
    base = "sum" if reduction in ("sum", "add", "mean") else reduction

    def one_side(adj, source):
        x = take_rows(source, adj.senders.clamp(max=source.shape[0] - 1))
        if use_target_state:
            x = torch.cat([x, broadcast_to_edges(ns.h_local.contiguous(), sum_plan_from_adjacency(adj))], dim=-1)
        x = dropout(x, dropout_rate, train, generator)
        msgs = typed_tile_matmul(x, weight_stack, adj.tile_types, adj.edge_tile)
        agg = adjacency_segment_reduce(msgs, adj, rows_per, base, mask=adj.mask, counts_exact=exact)
        return agg, live_in_degree(adj, rows_per, adj.mask, exact)

    a_int, c_int = one_side(ns.adj_int, ns.h_local)
    a_bnd, c_bnd = one_side(ns.adj_bnd, ns.recv)
    if reduction in ("sum", "add"):
        total = a_int + a_bnd
    elif reduction == "mean":
        total = (a_int + a_bnd) / (c_int + c_bnd).clamp_min(1.0).to(a_int.dtype)[:, None]
    else:  # max/min: a side without slots in a row read 0 there; pick by the counts
        pick = torch.maximum if reduction == "max" else torch.minimum
        has_i, has_b = c_int[:, None] > 0, c_bnd[:, None] > 0
        total = torch.where(has_i & has_b, pick(a_int, a_bnd), torch.where(has_i, a_int, a_bnd))
    # the layer's update runs over the extended rows; the stack keeps the
    # first rows_per
    tail = ctx.node_mask.shape[0] - rows_per
    return torch.cat([total, total.new_zeros((tail, total.shape[-1]))], dim=0)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------
class NodeParallel:
    """Train steps of ``module`` (a task module exposing ``.gnn``) with each
    minibatch's nodes, and the edges into them, split over the ranks of
    ``node_group`` (the world when None). Parameters and the task head are
    replicated; each layer exchanges only boundary sender rows.

    ``data_group`` is this rank's group of the data axis (one rank of each
    node group, holding different minibatches; ``LOCAL`` when there is
    none): weights, the loss and the metrics are reduced over it, and the
    gradients go through :class:`~ptgnn_tpu_torch.parallel.dp.DataParallel`.
    ZeRO-1 over the data axis is the trainer's optimizer
    (``zero1_optimizer(..., group=data_group)``)."""

    def __init__(
        self,
        module: torch.nn.Module,
        *,
        node_group: Any = None,
        data_group: Any = LOCAL,
        enable_amp: bool = False,
        boundary_budget: int = 0,
        interior_slots: int = 0,
        boundary_slots: int = 0,
        reorder: Optional[str] = "auto",
        node_aligned: Sequence[str] = (),
    ):
        gnn = getattr(module, "gnn", None)
        if gnn is None:
            raise ValueError("NodeParallel needs a module exposing .gnn")
        self.module = module
        self.node_group = node_group if node_group is not None else dist.group.WORLD
        self.num_shards = dist.get_world_size(self.node_group)
        self.shard_index = dist.get_rank(self.node_group)
        self.reorder = reorder
        self.node_aligned = tuple(node_aligned)
        self.last_stats: Optional[Dict[str, Any]] = None
        gnn.node_group = self.node_group
        self.data_parallel = DataParallel(module, enable_amp=enable_amp, data_group=data_group)
        self.set_budgets(boundary_budget=boundary_budget, interior_slots=interior_slots,
                         boundary_slots=boundary_slots)

    def set_budgets(self, *, boundary_budget: int, interior_slots: int, boundary_slots: int) -> None:
        """Budgets may be set after construction (the trainer probes them
        from the first batches of a run)."""
        self.boundary_budget = boundary_budget
        self.interior_slots = interior_slots
        self.boundary_slots = boundary_slots

    @property
    def has_budgets(self) -> bool:
        return self.interior_slots > 0 and self.boundary_slots > 0

    @property
    def budgets(self) -> Dict[str, int]:
        return {"boundary_budget": self.boundary_budget, "interior_slots": self.interior_slots,
                "boundary_slots": self.boundary_slots}

    def _reshard(self, minibatch: Dict[str, Any], reorder: Optional[str]) -> Dict[str, Any]:
        if not self.has_budgets:
            raise RuntimeError("node-sharding budgets are unset: call set_budgets (or probe with suggest_budgets)")
        sharded, self.last_stats = shard_batch_by_nodes(
            minibatch, self.num_shards, **self.budgets, reorder=reorder or self.reorder,
            node_aligned=self.node_aligned,
        )
        return sharded

    def shard_batch(self, minibatch: Dict[str, Any], reorder: Optional[str] = None) -> Dict[str, Any]:
        """Host side: this rank's view of the resharded minibatch
        (``reorder`` overrides the configured mode). Sets ``last_stats``;
        raises :class:`BoundaryBudgetError` over budget."""
        return local_shard(self._reshard(minibatch, reorder), self.shard_index)

    def shard_all(self, minibatch: Dict[str, Any],
                  reorder: Optional[str] = None) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
        """Host side, resharding once: (every node-group rank's view of the
        minibatch, by shard index; the exchange stats), as
        :meth:`shard_batch` gives each rank its own."""
        sharded = self._reshard(minibatch, reorder)
        return [local_shard(sharded, s) for s in range(self.num_shards)], self.last_stats

    def train_step(self, minibatch: Dict[str, Any], optimizer: torch.optim.Optimizer, *, weight: float = 1.0,
                   generator: Optional[torch.Generator] = None, clip_gradient_norm: Optional[float] = None):
        """One optimizer step on this rank's device-resident view of its
        node group's minibatch, through the compiled data-parallel train
        step (a CUDA graph per batch signature on the card, the boundary
        exchanges' ``all_to_all`` inside it). Returns (weighted mean loss,
        metrics summed over the data axis)."""
        return self.data_parallel.train_step(minibatch, weight, generator, optimizer, base_rates(optimizer),
                                             clip_gradient_norm=clip_gradient_norm)
