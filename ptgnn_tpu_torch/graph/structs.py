"""Graph containers: raw, tensorized, and the statically shaped batch.

As in the JAX package, many small graphs flatten into ONE padded
disconnected graph whose fused edge array is type-blocked (every tile of
``edge_tile`` edges has one edge type) and receiver-blocked (every tile
targets one row block of ``agg_rows`` receivers). The batcher builds every
array in numpy on the host; :meth:`GraphBatch.to` moves the whole batch to a
device in one call.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Generic, List, NamedTuple, Optional, Tuple, TypeVar

import numpy as np
import torch

from ptgnn_tpu_torch.ops.segment import masked_take

TNodeData = TypeVar("TNodeData")
TEdgeData = TypeVar("TEdgeData")
TTensorizedNodeData = TypeVar("TTensorizedNodeData")
TTensorizedEdgeData = TypeVar("TTensorizedEdgeData")


class GraphData(Generic[TNodeData, TEdgeData]):
    """One raw graph: node payloads, per-edge-type adjacency, named reference
    node sets."""

    __slots__ = ("node_information", "edges", "edge_features", "reference_nodes")

    def __init__(
        self,
        node_information: List[TNodeData],
        edges: Dict[str, List[Tuple[int, int]]],
        reference_nodes: Dict[str, List[int]],
        edge_features: Optional[Dict[str, List[TEdgeData]]] = None,
    ):
        self.node_information = node_information
        self.edges = edges
        self.edge_features = edge_features
        self.reference_nodes = reference_nodes


class TensorizedGraphData(Generic[TTensorizedNodeData, TTensorizedEdgeData]):
    """One tensorized graph with per-type (src, dst) numpy pairs in canonical
    metadata order."""

    __slots__ = (
        "num_nodes",
        "node_tensorized_data",
        "adjacency_lists",
        "edge_features",
        "reference_nodes",
    )

    def __init__(
        self,
        num_nodes: int,
        node_tensorized_data: List[TTensorizedNodeData],
        adjacency_lists: List[Tuple[np.ndarray, np.ndarray]],
        edge_features: Optional[List[List[TTensorizedEdgeData]]],
        reference_nodes: Dict[str, np.ndarray],
    ):
        self.num_nodes = num_nodes
        self.node_tensorized_data = node_tensorized_data
        self.adjacency_lists = adjacency_lists
        self.edge_features = edge_features
        self.reference_nodes = reference_nodes

    @property
    def num_edges(self) -> int:
        return sum(len(src) for src, _ in self.adjacency_lists)


@dataclass(frozen=True)
class BatchPadding:
    """Static shape budgets for one batch configuration.

    ``max_edge_slots`` counts materialized edge slots (forward, backward and
    self edges), each (row block, type) segment rounded up to ``edge_tile``.
    ``agg_rows`` receiver rows form one aggregation row block; each block's
    slot run is padded to ``agg_sum_tile`` (the sum supertile).
    ``att_block`` is the self-attention block: the batcher packs each graph's
    nodes into blocks of this many rows (``GraphBatch.att_order``), so
    block-diagonal attention is exact for every graph of at most one block;
    0 turns the packing off.
    """

    max_nodes: int
    max_edge_slots: int
    max_graphs: int
    edge_tile: int = 128
    agg_rows: int = 256
    att_block: int = 256
    agg_sum_tile: int = 512
    reference_budgets: Tuple[Tuple[str, int], ...] = field(default_factory=tuple)
    default_reference_budget: int = 512

    def reference_budget(self, name: str) -> int:
        for n, b in self.reference_budgets:
            if n == name:
                return b
        return self.default_reference_budget


def tree_to(obj: Any, device: torch.device, pin_memory: bool = False) -> Any:
    """numpy arrays and tensors -> tensors on ``device``, through
    NamedTuples, dicts, lists and tuples; anything else is kept.

    With ``pin_memory`` (for a CUDA ``device``) each host array is first
    copied into page-locked memory, so that the copy to the card runs
    asynchronously on the current stream; from pageable memory it is
    synchronous."""
    if obj is None:
        return None
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)  # keeps 0-d scalars 0-d
        if not arr.flags.c_contiguous:
            arr = arr.copy()
        obj = torch.from_numpy(arr)
    if isinstance(obj, torch.Tensor):
        if pin_memory and obj.device.type == "cpu":
            obj = obj.pin_memory()
        return obj.to(device, non_blocking=True)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_to(x, device, pin_memory) for x in obj))
    if isinstance(obj, dict):
        return {k: tree_to(v, device, pin_memory) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_to(x, device, pin_memory) for x in obj)
    return obj


def tree_tensors(obj: Any) -> List[torch.Tensor]:
    """Every tensor of a tree of NamedTuples, dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in tree_tensors(x)]
    return []


class ReferenceSet(NamedTuple):
    """A padded named reference-node set."""

    node_ids: Any  # [R_pad] int32, indices into flattened node slots
    graph_ids: Any  # [R_pad] int32, graph slot per reference
    mask: Any  # [R_pad] bool


class AdjacencyStruct(NamedTuple):
    """The fused edge structure of a flattened batch in the unified
    (row block, type, receiver)-sorted layout (see graph/batching.py).

    ``local_rows``/``tile_row_blocks``/``agg_counts`` form the plan of the
    aggregation kernels; ``super_tile_row_blocks`` views the same slots at
    supertile granularity (one row block per ``agg_sum_tile`` slots).
    ``row_offsets``/``row_slots`` index the real slots by row (the port's
    own; the JAX package has no such arrays): row g's slots are
    ``row_slots[row_offsets[g]:row_offsets[g + 1]]`` in increasing order.
    """

    senders: Any  # [E_pad] int32 (padding: 0)
    receivers: Any  # [E_pad] int32 (padding: max_nodes)
    edge_types: Any  # [E_pad] int32
    tile_types: Any  # [E_pad // edge_tile] int32
    mask: Any  # [E_pad] bool
    tile_types_transposed: Any = None  # [n_tiles] int32
    local_rows: Any = None  # [E_pad] int32 receiver - block*R (padding: R)
    tile_row_blocks: Any = None  # [n_tiles] int32, non-decreasing
    agg_counts: Any = None  # [num_row_blocks, R] int32 in-degrees
    super_tile_row_blocks: Any = None  # [n_super] int32 or None
    edge_feature_slot: Any = None  # [E_pad] int32 (fwd/bwd pair ids) or None
    row_offsets: Any = None  # [num_row_blocks * R + 1] int32, cumsum of agg_counts
    row_slots: Any = None  # [E_pad] int32 real slots row after row (tail: -1)
    # [E_pad] int32 fwd/bwd pair id of each slot (self and padding: -1), the
    # port's own: it equals edge_feature_slot unless the batch tracks edge
    # features, where a featureless graph's slots still get distinct ids.
    edge_pair_id: Any = None

    @property
    def edge_tile(self) -> int:
        return self.senders.shape[0] // self.tile_types.shape[0]

    @property
    def agg_rows(self) -> int:
        return self.agg_counts.shape[1]


class GraphBatch(NamedTuple):
    """A statically shaped flattened minibatch of graphs."""

    node_data: Any  # dict of [max_nodes, ...] arrays for the node embedder
    adjacency: AdjacencyStruct
    node_graph: Any  # [max_nodes] int32 (padding: max_graphs)
    node_mask: Any  # [max_nodes] bool
    references: Dict[str, ReferenceSet]
    num_nodes: Any  # scalar int32
    num_edges: Any  # scalar int32 (incl. materialized bwd/self edges)
    num_graphs: Any  # scalar int32
    graph_mask: Any  # [max_graphs] bool
    # [n_blocks, att_block] int32 node permutation for exact block-diagonal
    # self-attention (padding slots: max_nodes); None when att_block is 0.
    att_order: Any = None
    # The edge embedder's finalized minibatch (arrays of max_edge_slots rows,
    # one per forward edge, in the batcher's feature numbering), read through
    # adjacency.edge_feature_slot; None when the model embeds no edge features.
    edge_feature_data: Any = None
    # The node-sharding payload (parallel/node_sharding.py): when set, node_data,
    # adjacency, node_graph and node_mask are one rank's, and the GNN runs its
    # boundary-exchange stack. None for an ordinary batch.
    node_sharding: Any = None

    def to(self, device) -> "GraphBatch":
        return tree_to(self, torch.device(device))


class GnnOutput(NamedTuple):
    """Output of the GNN engine.

    Under node sharding (``shard_group`` set) the two representation fields
    hold this rank's ``[rows_per, D]`` rows, not the whole node table; heads
    read through the accessors: :meth:`node_rows` and :meth:`reference_rows`
    assemble the rows asked for (each rank contributes the rows it owns, one
    all-reduce), :meth:`node_table` all-gathers the table for heads that
    read every node. Unsharded, the accessors are plain gathers."""

    input_node_representations: Any  # [max_nodes, D] (this rank's rows when sharded)
    output_node_representations: Any  # [max_nodes, H] (this rank's rows when sharded)
    node_to_graph_idx: Any  # [max_nodes] int32 (always global)
    node_mask: Any  # [max_nodes] bool (always global)
    node_idx_references: Dict[str, Any]  # global node ids
    node_graph_idx_reference: Dict[str, Any]
    reference_masks: Dict[str, Any]
    num_graphs: Any
    graph_mask: Any
    shard_group: Any = None  # the node group under node sharding

    @property
    def reference_nodes_idx(self) -> Dict[str, Any]:
        return self.node_idx_references

    @property
    def reference_nodes_graph_idx(self) -> Dict[str, Any]:
        return self.node_graph_idx_reference

    def _table(self, which: str) -> torch.Tensor:
        """This rank's rows of the ``"output"`` or ``"input"`` (the
        embedder's) representations."""
        if which == "output":
            return self.output_node_representations
        if which == "input":
            return self.input_node_representations
        raise ValueError(f"no node table {which!r}")

    def node_table(self, which: str = "output") -> torch.Tensor:
        """The full ``[max_nodes, D]`` node table, ``"output"`` or ``"input"``
        (the embedder's) representations; one all-gather under node
        sharding."""
        table = self._table(which)
        if self.shard_group is None:
            return table
        from ptgnn_tpu_torch.parallel.collectives import all_gather_rows

        return all_gather_rows(table, self.shard_group)

    def node_rows(self, node_ids: torch.Tensor, which: str = "output") -> torch.Tensor:
        """The ``"output"`` or ``"input"`` representations by node id, NaN
        at an out-of-range id (the JAX package's ``jnp.take`` default).
        Padding references carry node id 0, so the task heads read only real
        rows and mask the padding ones."""
        table = self._table(which)
        if self.shard_group is None:
            return masked_take(table, node_ids, float("nan"))
        import torch.distributed as dist

        from ptgnn_tpu_torch.parallel.collectives import all_reduce_sum

        rows_per = table.shape[0]
        total = rows_per * dist.get_world_size(self.shard_group)
        valid = (node_ids >= 0) & (node_ids < total)
        mine = valid & (node_ids // rows_per == dist.get_rank(self.shard_group))
        picked = masked_take(table, torch.where(mine, node_ids % rows_per, -1), 0.0)
        rows = all_reduce_sum(picked, self.shard_group)
        return torch.where(valid[:, None], rows, torch.full((), float("nan"), dtype=rows.dtype, device=rows.device))

    def reference_rows(self, name: str, which: str = "output") -> torch.Tensor:
        """``[R_pad, D]`` ``"output"`` or ``"input"`` representations of the
        named reference set."""
        return self.node_rows(self.node_idx_references[name], which)


class AbstractNodeEmbedder:
    """The node embedders' interface: a node representation model whose
    module embeds each node in ``representation_size()`` columns."""

    def representation_size(self) -> int:
        raise NotImplementedError
