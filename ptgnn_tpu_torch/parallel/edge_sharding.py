"""Edge-partitioned model parallelism: one graph batch over the ranks of a
process group. The counterpart of the JAX package's
``parallel/edge_sharding.py``.

The padded edge array (the unified layout, ``graph/batching.py``) is cut
into contiguous tile-aligned shards, one per rank; node states are
replicated, and each aggregation becomes

    per rank: gather sources -> typed matmul -> row-indexed segment reduce
              of the rank's slots (K1 for sums and means, K2 for extrema)
    across ranks: one all-reduce (sum, or max/min) of the [N, D] partials.

Because the layout's tiles are type- and row-block-pure, every cut at tile
granularity leaves a valid layout. Each shard gets its own row index, built
on the host from its slice (a slice must not reuse the batch's row offsets:
the kernels would read the other shards' slots), and its own in-degrees;
the global degrees are their sum over the ranks.

The JAX package zeroes the output rows of row blocks that no local tile
covers (``_zero_uncovered_blocks``): its kernel leaves them uninitialized.
The port's kernels walk every output row and write 0 for a row without
slots, so nothing needs zeroing.

Partial aggregates across ranks:
* sum/mean: local sum, all-reduce; the mean divides by the global counts;
* max/min: local extremum with the neutral value in rows without local
  slots, all-reduced max/min (its backward splits ties across ranks), then
  rows without any slot read 0.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ptgnn_tpu_torch.graph.batching import row_index
from ptgnn_tpu_torch.graph.messagepassing.base import live_in_degree
from ptgnn_tpu_torch.graph.structs import AdjacencyStruct
from ptgnn_tpu_torch.ops.segment_kernels import adjacency_segment_reduce
from ptgnn_tpu_torch.parallel.collectives import all_reduce_extremum, all_reduce_sum, all_reduce_sum_

__all__ = ["EdgeParallel", "shard_adjacency", "sharded_aggregate"]

_BIG = 3.0e38


def shard_adjacency(adj: AdjacencyStruct, num_shards: int) -> List[AdjacencyStruct]:
    """Cut a batch's (host, numpy) unified layout into ``num_shards``
    contiguous tile-aligned shards. The edge- and tile-indexed arrays are
    the JAX package's shards bitwise; ``agg_counts`` holds the shard's own
    in-degrees (their sum over the shards is the batch's), and each shard
    gets the row index of its own slots. The supertile view does not
    survive a cut, so a shard's sums run on its edge-tile plan."""
    n_tiles = adj.tile_types.shape[0]
    if n_tiles % num_shards:
        raise ValueError(f"edge tiles ({n_tiles}) must divide into the edge-shard count ({num_shards}); "
                         "pick max_edge_slots as a multiple of num_shards * edge_tile")
    tile = adj.edge_tile
    tiles_per = n_tiles // num_shards
    per = tiles_per * tile
    num_blocks, r = adj.agg_counts.shape
    shards = []
    for s in range(num_shards):
        edges = slice(s * per, (s + 1) * per)
        tiles = slice(s * tiles_per, (s + 1) * tiles_per)
        local_rows = adj.local_rows[edges]
        tile_row_blocks = adj.tile_row_blocks[tiles]
        real = (local_rows >= 0) & (local_rows < r)
        rows = np.repeat(tile_row_blocks, tile)[real].astype(np.int64) * r + local_rows[real]
        counts = np.bincount(rows, minlength=num_blocks * r).astype(np.int32).reshape(num_blocks, r)
        row_offsets, row_slots = row_index(local_rows, tile_row_blocks, counts)

        def cut(x, part=edges):
            return None if x is None else x[part]

        shards.append(AdjacencyStruct(
            senders=cut(adj.senders), receivers=cut(adj.receivers), edge_types=cut(adj.edge_types),
            tile_types=cut(adj.tile_types, tiles), mask=cut(adj.mask),
            tile_types_transposed=cut(adj.tile_types_transposed, tiles),
            local_rows=local_rows, tile_row_blocks=tile_row_blocks, agg_counts=counts,
            super_tile_row_blocks=None, edge_feature_slot=cut(adj.edge_feature_slot),
            row_offsets=row_offsets, row_slots=row_slots, edge_pair_id=cut(adj.edge_pair_id),
        ))
    return shards


def sharded_aggregate(
    messages: torch.Tensor,
    local_adj: AdjacencyStruct,
    num_nodes: int,
    reduction: str,
    group: Any,
    mask: Optional[torch.Tensor] = None,
    counts_exact: bool = False,
) -> torch.Tensor:
    """This rank's masked segment reduce of its slots, then one all-reduce
    over ``group``. ``counts_exact``: the mask is the batch's static one, so
    the shard's in-degrees count its live slots."""
    mask = local_adj.mask if mask is None else mask
    if reduction in ("sum", "add", "mean"):
        local = adjacency_segment_reduce(messages, local_adj, num_nodes, "sum", mask=mask)
        total = all_reduce_sum(local, group)
        if reduction == "mean":
            cnt = all_reduce_sum_(live_in_degree(local_adj, num_nodes, mask, counts_exact), group)
            total = total / cnt.clamp_min(1.0).to(total.dtype)[:, None]
        return total
    if reduction in ("max", "min"):
        is_max = reduction == "max"
        local = adjacency_segment_reduce(messages.float(), local_adj, num_nodes, reduction, mask=mask)
        # rows without local slots read 0: the neutral makes them lose the
        # cross-rank combine
        cnt_l = live_in_degree(local_adj, num_nodes, mask, counts_exact)
        local = torch.where(cnt_l[:, None] > 0, local, torch.full((), -_BIG if is_max else _BIG, device=local.device))
        total = all_reduce_extremum(local, group, is_max)
        cnt = all_reduce_sum_(cnt_l.clone(), group)
        return torch.where(cnt[:, None] > 0, total, torch.zeros((), device=total.device)).to(messages.dtype)
    raise ValueError(f"Unknown reduction '{reduction}'")


class EdgeParallel:
    """Train steps of ``module`` (a task module exposing ``.gnn``) with one
    batch's edges cut over the ranks of ``group`` (the default group when
    None): node states, parameters and every other batch field are
    replicated, and each aggregation all-reduces once
    (:func:`sharded_aggregate`). The gradients go through
    :class:`~ptgnn_tpu_torch.parallel.dp.DataParallel` (DDP over the world:
    the sum over the ranks of their partial gradients, divided by the group
    size, as the collectives' convention requires). Every rank steps on the
    same minibatch; at one rank the step is the single-device trainer's.
    For data parallelism across such groups, use node sharding
    (``NodeParallel(data_group=...)``), which also splits the node arrays."""

    def __init__(self, module: torch.nn.Module, *, group: Any = None, enable_amp: bool = False):
        from ptgnn_tpu_torch.parallel.dp import LOCAL, DataParallel

        gnn = getattr(module, "gnn", None)
        if gnn is None:
            raise ValueError("EdgeParallel needs a module exposing .gnn")
        self.module = module
        self.group = group if group is not None else dist.group.WORLD
        self.num_shards = dist.get_world_size(self.group)
        self.shard_index = dist.get_rank(self.group)
        gnn.edge_group = self.group
        self.data_parallel = DataParallel(module, enable_amp=enable_amp, data_group=LOCAL)

    def shard_batch(self, minibatch: Dict[str, Any]) -> Dict[str, Any]:
        """Host side: the minibatch with this rank's shard of the edges."""
        batch = minibatch["batch"]
        local = shard_adjacency(batch.adjacency, self.num_shards)[self.shard_index]
        return {**minibatch, "batch": batch._replace(adjacency=local)}

    def train_step(self, minibatch: Dict[str, Any], optimizer: torch.optim.Optimizer, *,
                   generator: Optional[torch.Generator] = None, clip_gradient_norm: Optional[float] = None):
        """One optimizer step on this rank's device-resident sharded
        minibatch. Returns (loss, metrics)."""
        return self.data_parallel.train_step(minibatch, 1.0, generator, optimizer,
                                             [g["lr"] for g in optimizer.param_groups],
                                             clip_gradient_norm=clip_gradient_norm)
