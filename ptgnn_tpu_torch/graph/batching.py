"""Host-side assembly of statically shaped graph batches in the unified
(row block, type, receiver) edge layout.

Many small graphs become one padded disconnected graph whose fused edge
array is sorted by (receiver row block, edge type, receiver), with every
(row block, type) segment padded up to a multiple of ``edge_tile`` and every
row block's run padded to the supertile ``agg_sum_tile``. One ordering then
serves both hot paths without device-side permutation:

* every tile has a single edge type (``tile_types``): per-type linear maps
  are one tile-batched matmul (ops/typed_linear.py);
* every tile targets a single row block with receivers sorted inside it
  (``tile_row_blocks``, ``local_rows``): aggregation and the receiver
  broadcast are block-local (ops/segment_kernels.py);
* every row's real slots are listed in order (``row_offsets``,
  ``row_slots``; the port's own): the segment max and sum kernels reduce
  row by row.

Backward edges (type id T+t) and self edges (last type id) are materialized
here. All work is numpy; every array the JAX package also has is bitwise
its own.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ptgnn_tpu_torch.graph.structs import (
    AdjacencyStruct,
    BatchPadding,
    GraphBatch,
    ReferenceSet,
    TensorizedGraphData,
)


def materialized_edge_type_count(
    num_fwd_edge_types: int, *, introduce_backwards_edges: bool, add_self_edges: bool
) -> int:
    """Forward types, doubled for backward edges, plus one self-edge type."""
    t = num_fwd_edge_types
    if introduce_backwards_edges:
        t *= 2
    if add_self_edges:
        t += 1
    return t


def _tile_ceil(n: int, tile: int) -> int:
    return int(math.ceil(n / tile)) * tile


def required_edge_slots(
    seg_counts: Dict[Tuple[int, int], int], *, tile: int, align: int, num_blocks: int
) -> int:
    """Slots the unified layout needs for (row block, type) -> edge counts."""
    per_block: Dict[int, int] = {}
    for (b, _t), c in seg_counts.items():
        per_block[b] = per_block.get(b, 0) + _tile_ceil(c, tile)
    slots = sum(_tile_ceil(s, align) for s in per_block.values())
    slots += align * (num_blocks - len(per_block))
    return slots


def _seg_counts_of(
    receivers: np.ndarray, types: np.ndarray, agg_rows: int, num_types: int
) -> Dict[Tuple[int, int], int]:
    delta: Dict[Tuple[int, int], int] = {}
    if len(receivers):
        keys = (receivers // agg_rows).astype(np.int64) * (num_types + 1) + types
        uniq, cnt = np.unique(keys, return_counts=True)
        for k, c in zip(uniq, cnt):
            b, t = divmod(int(k), num_types + 1)
            delta[(b, t)] = int(c)
    return delta


def row_index(
    local_rows: np.ndarray, tile_row_blocks: np.ndarray, counts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """The layout's real slots indexed by row: ``row_offsets``
    [num_row_blocks * R + 1], the exclusive cumulative sum of the in-degrees
    ``counts``, and ``row_slots`` [E_pad], each row's slots in increasing
    order, row after row, then -1. Row g = block * R + local row."""
    r = counts.shape[1]
    tile = local_rows.shape[0] // tile_row_blocks.shape[0]
    real = np.nonzero((local_rows >= 0) & (local_rows < r))[0]
    rows = np.repeat(tile_row_blocks, tile)[real].astype(np.int64) * r + local_rows[real]
    row_slots = np.full(local_rows.shape[0], -1, np.int32)
    row_slots[: real.shape[0]] = real[np.argsort(rows, kind="stable")]
    row_offsets = np.zeros(counts.size + 1, np.int32)
    np.cumsum(counts.reshape(-1), out=row_offsets[1:])
    return row_offsets, row_slots


def build_adjacency_struct(
    layout_arrays: Tuple[np.ndarray, ...],
    *,
    tile: int,
    align: int,
    num_fwd_types: int,
    introduce_backwards_edges: bool,
    edge_pair_id: Optional[np.ndarray] = None,
) -> AdjacencyStruct:
    """Wrap assembled layout arrays into an AdjacencyStruct with the derived
    transpose tile-type map, supertile view and row index. The slots' pair
    ids default to the layout's feature slots (the two are one numbering
    unless the batch tracks edge features)."""
    (senders, receivers, edge_types, local_rows, edge_mask, tile_types,
     tile_row_blocks, counts, feature_slot) = layout_arrays
    n_tiles = senders.shape[0] // tile

    tile_types_transposed = None
    if introduce_backwards_edges:
        base = num_fwd_types
        tt = tile_types
        tile_types_transposed = np.where(
            tt < base, tt + base, np.where(tt < 2 * base, tt - base, tt)
        ).astype(np.int32)

    super_tile_row_blocks = None
    if align > tile:
        k = align // tile
        grouped = tile_row_blocks.reshape(n_tiles // k, k)
        if bool(np.all(grouped == grouped[:, :1])):
            super_tile_row_blocks = np.ascontiguousarray(grouped[:, 0])
    row_offsets, row_slots = row_index(local_rows, tile_row_blocks, counts)

    return AdjacencyStruct(
        senders=senders,
        receivers=receivers,
        edge_types=edge_types,
        tile_types=tile_types,
        mask=edge_mask,
        tile_types_transposed=tile_types_transposed,
        local_rows=local_rows,
        tile_row_blocks=tile_row_blocks,
        agg_counts=counts,
        super_tile_row_blocks=super_tile_row_blocks,
        edge_feature_slot=feature_slot,
        row_offsets=row_offsets,
        row_slots=row_slots,
        edge_pair_id=feature_slot if edge_pair_id is None else edge_pair_id,
    )


def _assemble_layout_python(
    senders_r, receivers_r, types_r, feats_r, *,
    max_nodes, e_pad, tile, agg_rows, num_types, align, sender_domain: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, ...]]:
    """Assemble raw edge arrays into the unified layout. Returns (senders,
    receivers, edge_types, local_rows, edge_mask, tile_types,
    tile_row_blocks, counts [num_blocks, agg_rows], feature_slot), or None
    if the edges exceed the ``e_pad`` budget.

    ``sender_domain`` bounds the sender ids, which are copied through and
    not used for the layout (default ``max_nodes``): the boundary layouts of
    node sharding (``parallel/node_sharding.py``) index a receive buffer."""
    domain = max_nodes if sender_domain is None else sender_domain
    if len(senders_r) and (int(senders_r.min()) < 0 or int(senders_r.max()) >= domain):
        raise ValueError(f"sender ids must lie in [0, {domain})")
    r = agg_rows
    n_tiles = e_pad // tile
    num_blocks = -(-max_nodes // agg_rows)

    block_r = receivers_r // r
    order = np.lexsort((receivers_r, types_r, block_r))
    senders_r = senders_r[order]
    receivers_r = receivers_r[order]
    types_r = types_r[order]
    feats_r = feats_r[order]
    block_r = block_r[order]

    seg_key = block_r.astype(np.int64) * (num_types + 1) + types_r
    if len(seg_key):
        seg_bounds = np.concatenate(
            [[0], np.nonzero(np.diff(seg_key))[0] + 1, [len(seg_key)]]
        )
    else:
        seg_bounds = np.array([0, 0])

    senders = np.zeros(e_pad, np.int32)
    receivers = np.full(e_pad, max_nodes, np.int32)  # padding: out of range
    edge_types = np.zeros(e_pad, np.int32)
    tile_types = np.zeros(n_tiles, np.int32)
    tile_row_blocks = np.zeros(n_tiles, np.int32)
    local_rows = np.full(e_pad, r, np.int32)  # padding: sentinel R
    edge_mask = np.zeros(e_pad, bool)
    feature_slot = np.full(e_pad, -1, np.int32)

    cursor = 0
    tile_cursor = 0
    seg_idx = 0
    num_segments = len(seg_bounds) - 1
    for b in range(num_blocks):
        block_start = cursor
        while seg_idx < num_segments:
            s0, s1 = seg_bounds[seg_idx], seg_bounds[seg_idx + 1]
            if s1 <= s0:
                seg_idx += 1
                continue
            if block_r[s0] != b:
                break
            c = s1 - s0
            seg = _tile_ceil(c, tile)
            t = int(types_r[s0])
            if cursor + seg > e_pad:
                return None
            senders[cursor : cursor + c] = senders_r[s0:s1]
            receivers[cursor : cursor + c] = receivers_r[s0:s1]
            feature_slot[cursor : cursor + c] = feats_r[s0:s1]
            local_rows[cursor : cursor + c] = receivers_r[s0:s1] - b * r
            edge_types[cursor : cursor + seg] = t
            edge_mask[cursor : cursor + c] = True
            tile_types[tile_cursor : tile_cursor + seg // tile] = t
            tile_row_blocks[tile_cursor : tile_cursor + seg // tile] = b
            cursor += seg
            tile_cursor += seg // tile
            seg_idx += 1
        # Pad the block's run to the supertile with all-padding tiles of this
        # block; empty blocks get one aligned run.
        target = block_start + _tile_ceil(max(cursor - block_start, 1), align or tile)
        if target > e_pad:
            return None
        pad_tiles = (target - cursor) // tile
        tile_row_blocks[tile_cursor : tile_cursor + pad_tiles] = b
        cursor = target
        tile_cursor += pad_tiles
    # Trailing spare tiles continue the last row block (all padding).
    if tile_cursor < n_tiles:
        tile_row_blocks[tile_cursor:] = num_blocks - 1

    counts = np.zeros(num_blocks * r, np.int32)
    if len(receivers_r):
        np.add.at(counts, receivers_r, 1)

    return (
        senders, receivers, edge_types, local_rows, edge_mask, tile_types,
        tile_row_blocks, counts.reshape(num_blocks, r), feature_slot,
    )


class GraphBatcher:
    """Accumulates TensorizedGraphData into one statically shaped GraphBatch.

    Backward types get ids T+t and self edges the final id.

    ``edge_pair_id`` numbers every graph's forward edges with one cursor
    over the batch (backward edges share the number, self edges get -1): the
    fwd/bwd pair ids of the fused op's argmax routing. ``edge_feature_slot``
    is the same numbering, except with ``track_edge_features``: there it is
    the edge's row in the batch's edge-feature array, a graph without
    features gets -1 slots and does not advance the feature cursor, so no
    later graph reads another's rows (the JAX package's numbering, which
    has no separate pair ids).
    """

    def __init__(
        self,
        num_fwd_edge_types: int,
        padding: BatchPadding,
        introduce_backwards_edges: bool,
        add_self_edges: bool,
        track_edge_features: bool = False,
    ):
        if padding.max_edge_slots % padding.edge_tile:
            raise ValueError("max_edge_slots must be a multiple of edge_tile")
        self.num_fwd_edge_types = num_fwd_edge_types
        self.padding = padding
        self.introduce_backwards_edges = introduce_backwards_edges
        self.add_self_edges = add_self_edges
        self.track_edge_features = track_edge_features

    @property
    def _block_align(self) -> int:
        """Slot alignment of each row block's run (the sum supertile)."""
        s = self.padding.agg_sum_tile
        if s and s % self.padding.edge_tile == 0 and self.padding.max_edge_slots % s == 0:
            return s
        return self.padding.edge_tile

    @property
    def num_edge_types(self) -> int:
        return materialized_edge_type_count(
            self.num_fwd_edge_types,
            introduce_backwards_edges=self.introduce_backwards_edges,
            add_self_edges=self.add_self_edges,
        )

    @property
    def num_row_blocks(self) -> int:
        return -(-self.padding.max_nodes // self.padding.agg_rows)

    def initialize(self) -> Dict[str, Any]:
        return {
            "senders": [],
            "receivers": [],
            "types": [],
            "seg_counts": {},
            "num_nodes_per_graph": [],
            "reference_node_ids": {},
            "reference_node_graph_idx": {},
            "num_nodes_in_mb": 0,
            "num_edges_in_mb": 0,
            "feature_idx": [],
            "num_features_in_mb": 0,
            "feature_rows": [],
            "num_pairs_in_mb": 0,
        }

    def _graph_edge_arrays(
        self, graph: TensorizedGraphData, offset: int, pair_offset: int = 0
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """All materialized edges of one graph (fwd + bwd + self), offset.
        The fourth array numbers forward edges from ``pair_offset``
        (backward edges share the forward edge's number, self edges get -1)."""
        senders: List[np.ndarray] = []
        receivers: List[np.ndarray] = []
        types: List[np.ndarray] = []
        feats: List[np.ndarray] = []
        base = self.num_fwd_edge_types
        fcursor = pair_offset
        for t, (src, dst) in enumerate(graph.adjacency_lists):
            if len(src) == 0:
                continue
            src = src.astype(np.int32) + offset
            dst = dst.astype(np.int32) + offset
            fidx = np.arange(fcursor, fcursor + len(src), dtype=np.int32)
            fcursor += len(src)
            senders.append(src)
            receivers.append(dst)
            types.append(np.full(len(src), t, np.int32))
            feats.append(fidx)
            if self.introduce_backwards_edges:
                senders.append(dst)
                receivers.append(src)
                types.append(np.full(len(src), base + t, np.int32))
                feats.append(fidx)
        if self.add_self_edges:
            idents = np.arange(offset, offset + graph.num_nodes, dtype=np.int32)
            senders.append(idents)
            receivers.append(idents)
            types.append(np.full(graph.num_nodes, self.num_edge_types - 1, np.int32))
            feats.append(np.full(graph.num_nodes, -1, np.int32))
        if not senders:
            z = np.zeros(0, np.int32)
            return z, z, z, z
        return (
            np.concatenate(senders),
            np.concatenate(receivers),
            np.concatenate(types),
            np.concatenate(feats),
        )

    def _slots_for(self, seg_counts: Dict[Tuple[int, int], int]) -> int:
        return required_edge_slots(
            seg_counts,
            tile=self.padding.edge_tile,
            align=self._block_align,
            num_blocks=self.num_row_blocks,
        )

    def _merged_seg_counts(self, graph, offset) -> Dict[Tuple[int, int], int]:
        # can_add and extend ask for the same (graph, offset) back to back.
        memo = getattr(self, "_seg_counts_memo", None)
        if memo is not None and memo[0] is graph and memo[1] == offset:
            return memo[2]
        _, receivers, types, _ = self._graph_edge_arrays(graph, offset)
        delta = _seg_counts_of(receivers, types, self.padding.agg_rows, self.num_edge_types)
        self._seg_counts_memo = (graph, offset, delta)
        return delta

    def can_add(self, graph: TensorizedGraphData, mb: Dict[str, Any]) -> bool:
        p = self.padding
        if len(mb["num_nodes_per_graph"]) + 1 > p.max_graphs:
            return False
        offset = mb["num_nodes_in_mb"]
        if offset + graph.num_nodes > p.max_nodes:
            return False
        merged = dict(mb["seg_counts"])
        for key, c in self._merged_seg_counts(graph, offset).items():
            merged[key] = merged.get(key, 0) + c
        if self._slots_for(merged) > p.max_edge_slots:
            return False
        for name, refs in graph.reference_nodes.items():
            existing = mb["reference_node_ids"].get(name)
            count = sum(len(a) for a in existing) if existing else 0
            if count + len(refs) > p.reference_budget(name):
                return False
        return True

    def extend(self, graph: TensorizedGraphData, mb: Dict[str, Any]) -> bool:
        """Add a graph (the caller must have checked can_add)."""
        offset = mb["num_nodes_in_mb"]
        graph_idx = len(mb["num_nodes_per_graph"])
        has_features = self.track_edge_features and graph.edge_features is not None
        number_slots = has_features or not self.track_edge_features
        if has_features and len(graph.edge_features) != graph.num_edges:
            raise ValueError(
                f"graph has {graph.num_edges} forward edges but {len(graph.edge_features)} edge features: "
                "the flattened feature list must hold one entry per forward edge in canonical type order"
            )
        # Every graph's edges get pair ids; the feature rows of the pairs
        # (-1 for a graph without features) map them to feature slots.
        senders, receivers, types, pair_idx = self._graph_edge_arrays(graph, offset, mb["num_pairs_in_mb"])
        mb["senders"].append(senders)
        mb["receivers"].append(receivers)
        mb["types"].append(types)
        mb["feature_idx"].append(pair_idx)
        mb["num_pairs_in_mb"] += graph.num_edges
        if number_slots:
            first = mb["num_features_in_mb"]
            mb["feature_rows"].append(np.arange(first, first + graph.num_edges, dtype=np.int32))
            mb["num_features_in_mb"] += graph.num_edges
        else:
            mb["feature_rows"].append(np.full(graph.num_edges, -1, np.int32))
        for key, c in self._merged_seg_counts(graph, offset).items():
            mb["seg_counts"][key] = mb["seg_counts"].get(key, 0) + c
        mb["num_edges_in_mb"] += len(senders)

        for name, refs in graph.reference_nodes.items():
            mb["reference_node_ids"].setdefault(name, []).append(
                refs.astype(np.int32) + offset
            )
            mb["reference_node_graph_idx"].setdefault(name, []).extend(
                graph_idx for _ in range(len(refs))
            )
        mb["num_nodes_per_graph"].append(graph.num_nodes)
        mb["num_nodes_in_mb"] = offset + graph.num_nodes
        return mb["num_nodes_in_mb"] < self.padding.max_nodes

    def finalize(
        self, mb: Dict[str, Any], node_data: Any, reference_names: Sequence[str]
    ) -> GraphBatch:
        p = self.padding
        if mb["senders"]:
            senders_r = np.concatenate(mb["senders"])
            receivers_r = np.concatenate(mb["receivers"])
            types_r = np.concatenate(mb["types"])
            feats_r = np.concatenate(mb["feature_idx"])
        else:
            senders_r = receivers_r = types_r = feats_r = np.zeros(0, np.int32)

        layout = _assemble_layout_python(
            senders_r, receivers_r, types_r, feats_r,
            max_nodes=p.max_nodes, e_pad=p.max_edge_slots, tile=p.edge_tile,
            agg_rows=p.agg_rows, num_types=self.num_edge_types, align=self._block_align,
        )
        if layout is None:
            raise RuntimeError("batcher admitted more edges than the budget")
        pair_slot = layout[8]
        if self.track_edge_features:
            feature_rows = np.concatenate(mb["feature_rows"]) if mb["feature_rows"] else np.zeros(0, np.int32)
            feature_slot = np.where(pair_slot >= 0, feature_rows[np.maximum(pair_slot, 0)] if len(feature_rows)
                                    else -1, -1).astype(np.int32)
            layout = layout[:8] + (feature_slot,)
        adjacency = build_adjacency_struct(
            layout,
            tile=p.edge_tile,
            align=self._block_align,
            num_fwd_types=self.num_fwd_edge_types,
            introduce_backwards_edges=self.introduce_backwards_edges,
            edge_pair_id=pair_slot,
        )

        n_pad, g_pad = p.max_nodes, p.max_graphs
        num_nodes = mb["num_nodes_in_mb"]
        num_graphs = len(mb["num_nodes_per_graph"])
        node_graph = np.full(n_pad, g_pad, np.int32)
        start = 0
        for i, n in enumerate(mb["num_nodes_per_graph"]):
            node_graph[start : start + n] = i
            start += n

        references: Dict[str, ReferenceSet] = {}
        for name in reference_names:
            budget = p.reference_budget(name)
            ids = np.zeros(budget, np.int32)
            gidx = np.full(budget, g_pad, np.int32)
            mask = np.zeros(budget, bool)
            chunks = mb["reference_node_ids"].get(name, [])
            if chunks:
                flat = np.concatenate(chunks)
                nrefs = len(flat)
                ids[:nrefs] = flat
                gidx[:nrefs] = np.asarray(mb["reference_node_graph_idx"][name], np.int32)
                mask[:nrefs] = True
            references[name] = ReferenceSet(node_ids=ids, graph_ids=gidx, mask=mask)

        return GraphBatch(
            node_data=node_data,
            adjacency=adjacency,
            node_graph=node_graph,
            node_mask=np.arange(n_pad) < num_nodes,
            references=references,
            num_nodes=np.int32(num_nodes),
            num_edges=np.int32(mb["num_edges_in_mb"]),
            num_graphs=np.int32(num_graphs),
            graph_mask=np.arange(g_pad) < num_graphs,
            att_order=self._build_att_order(mb["num_nodes_per_graph"]),
        )

    def _build_att_order(self, num_nodes_per_graph: Sequence[int]) -> Optional[np.ndarray]:
        """[n_blocks, att_block] node permutation: Next-Fit packing of the
        graphs into attention blocks, so that no graph of at most one block
        straddles a block boundary. A larger graph starts at a block
        boundary and fills consecutive blocks; the block after it starts
        fresh.

        The budget is the exact worst case: each graph costs at most a
        sealed partial block (block - 1) plus ceil(n / block) * block <= n +
        block - 1 slots, so the total is bounded by both n_pad + 2 * block *
        max_graphs and, pairing each seal with the real node that forced it,
        3 * n_pad."""
        block = self.padding.att_block
        if not block:
            return None
        n_pad = self.padding.max_nodes
        worst = min(n_pad + 2 * block * self.padding.max_graphs, 3 * n_pad)
        n_blocks = -(-worst // block) + 1
        order = np.full(n_blocks * block, n_pad, np.int32)
        cursor = 0  # the next free slot of the flat order
        offset = 0  # the node id of the current graph's first node
        for n in num_nodes_per_graph:
            remaining = block - cursor % block
            if n > remaining and remaining < block:
                cursor += remaining  # seal the partial block
            order[cursor:cursor + n] = np.arange(offset, offset + n, dtype=np.int32)
            cursor += n
            if n > block and cursor % block:
                cursor += block - cursor % block  # a large graph ends its block
            offset += n
        if cursor > len(order):
            raise RuntimeError("the attention packing overran its budget")
        return order.reshape(n_blocks, block)
