"""The node-sharded (and hybrid data x node) model trainer. The counterpart
of the JAX package's ``parallel/node_sharded_trainer.py``.

Node sharding (``parallel/node_sharding.py``) as a training mode: real
epochs, validation, early stopping, the best checkpoint's restore and
optimizer-state checkpoints, the :class:`DistributedModelTrainer`
lifecycle, with each minibatch's nodes split over a node group of
``node_shards`` ranks and independent minibatches data-parallel across the
node groups.

* Ranks. ``node_data_groups`` cuts the world into node groups of
  consecutive ranks (the JAX mesh's ``node`` axis) and data groups of the
  ranks with one shard index (its ``data`` axis). The ranks of one node
  group take one slot of each group of minibatches, shard it alike and each
  run their own shard.
* Budgets. The static edge-slot and boundary budgets are probed over the
  first minibatches of a pass (``suggest_budgets``, with a headroom
  factor), max-reduced over the ranks so every rank shards alike, then
  frozen. Budgets probed on a validation pass before any training are
  provisional: the first training pass probes again and keeps the larger.
* Over budget. A later minibatch over the frozen budgets is retried under
  the BFS renumbering (when that is not in play already), else skipped with
  a warning: its slot runs the empty minibatch at weight 0, so the other
  node groups need not know. (The JAX package drops it from the group and
  closes the group with the next one; the same minibatches train, grouped
  otherwise.) A pass counts the samples of the slots that ran, as the JAX
  package does: the weights of each node group's slots, summed over the
  node's ranks at the pass's end.
* ZeRO-1 shards the optimizer's moments over the data group.
"""
from __future__ import annotations

import itertools
import logging
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ptgnn_tpu_torch.core.trainer import make_capturable
from ptgnn_tpu_torch.parallel.distributed_trainer import DistributedModelTrainer
from ptgnn_tpu_torch.parallel.dp import LOCAL, DataParallel, zero1_optimizer
from ptgnn_tpu_torch.parallel.node_sharding import BoundaryBudgetError, NodeParallel, suggest_budgets

__all__ = ["NodeShardedModelTrainer", "node_data_groups"]

_BUDGET_KEYS = ("boundary_budget", "interior_slots", "boundary_slots")


def node_data_groups(node_shards: int) -> Tuple[Any, Any]:
    """(this rank's node group, its data group) over the default process
    group: node groups of ``node_shards`` consecutive ranks, data groups of
    the ranks with one index in their node group (``LOCAL`` when there is
    one node group). Every rank must call this, in the same order as the
    others: each group is created by all ranks."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % node_shards:
        raise ValueError(f"{world} ranks do not divide into node groups of {node_shards}")
    data_size = world // node_shards
    node_group = data_group = None
    for d in range(data_size):
        g = dist.new_group(list(range(d * node_shards, (d + 1) * node_shards)))
        if rank // node_shards == d:
            node_group = g
    if data_size == 1:
        return node_group, LOCAL
    for s in range(node_shards):
        g = dist.new_group(list(range(s, world, node_shards)))
        if rank % node_shards == s:
            data_group = g
    return node_group, data_group


class NodeShardedModelTrainer(DistributedModelTrainer):
    """A :class:`DistributedModelTrainer` whose step splits each minibatch's
    nodes over a node group of ``node_shards`` ranks (boundary rows
    exchanged over the node group, gradients and metrics reduced over the
    data group, ZeRO-1 moments over the data group). ``budgets`` freezes
    the node-sharding budgets; otherwise they are probed over the first
    ``budget_probe_batches`` minibatches with ``budget_headroom``. The
    model's ``node_aligned_minibatch_keys`` name the minibatch entries that
    a reorder permutes with the nodes (PPI's targets)."""

    LOGGER = logging.getLogger(__name__)

    def __init__(
        self,
        *args,
        node_shards: int,
        budgets: Optional[Dict[str, int]] = None,
        budget_probe_batches: int = 8,
        budget_headroom: float = 1.5,
        reorder: Optional[str] = "auto",
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        if self.local_world_size % node_shards:
            raise ValueError(f"a node's {self.local_world_size} ranks do not divide into node groups of "
                             f"{node_shards}: a node group must not span nodes (each node reads its own data)")
        self.node_shards = node_shards
        self.node_group, self.data_group = node_data_groups(node_shards)
        self.data_size = self.world_size // node_shards
        self._budgets = dict(budgets) if budgets else None
        self._budget_probe_batches = budget_probe_batches
        self._budget_headroom = budget_headroom
        self._reorder = reorder
        self._np: Optional[NodeParallel] = None
        self._epoch_shard_stats = self._fresh_stats()
        # budgets probed on a validation pass before any training step stay
        # provisional until the first training pass probes again
        self._budgets_provisional = False
        self._in_validation = False

    @property
    def finalize_slot(self) -> Tuple[int, int]:
        return self.local_rank // self.node_shards, self.local_world_size // self.node_shards

    @property
    def dropout_rank(self) -> int:
        return self.rank // self.node_shards

    @property
    def node_parallel(self) -> NodeParallel:
        if self._np is None or self._np.module is not self.neural_module:
            padding = getattr(getattr(self._model, "gnn_model", None), "padding", None)
            if padding is not None and padding.max_nodes % self.node_shards:
                raise ValueError(f"padding.max_nodes ({padding.max_nodes}) must divide into {self.node_shards} "
                                 "node shards")
            self._np = NodeParallel(self.neural_module, node_group=self.node_group, data_group=self.data_group,
                                    enable_amp=self._enable_amp, reorder=self._reorder,
                                    node_aligned=getattr(self._model, "node_aligned_minibatch_keys", ()))
            if self._budgets is not None:
                self._set_budgets(self._budgets)
        return self._np

    def _set_budgets(self, budgets: Dict[str, int]) -> None:
        """Freeze ``budgets``, raised where needed to fit the empty
        minibatch, which pads short groups and stands in for skipped ones."""
        floor = suggest_budgets([self.empty_minibatch()], self.node_shards, reorder=self._reorder)
        self._budgets = {k: max(v, floor[k]) for k, v in budgets.items()}
        self._np.set_budgets(**self._budgets)

    @property
    def data_parallel(self) -> DataParallel:
        return self.node_parallel.data_parallel

    def _free_graphs(self) -> None:
        if self._np is not None:
            self._np.data_parallel.clear()

    # -- the optimizer: ZeRO-1 over the data group ----------------------------
    def _create_optimizer(self):
        if not self._zero1 or self.data_group == LOCAL:
            return super(DistributedModelTrainer, self)._create_optimizer()
        optimizer = zero1_optimizer(self.neural_module.parameters(), self._optimizer_creator, group=self.data_group)
        if self._restored_optimizer_state is not None:
            optimizer.load_state_dict(self._restored_optimizer_state)
            self._restored_optimizer_state = None
        return optimizer, make_capturable(optimizer, self._device)

    def _save_optimizer_state(self, optimizer, next_epoch: int) -> None:
        sharded = self._zero1 and self.data_group != LOCAL
        if sharded and self.rank % self.node_shards == 0:  # the data group of rank 0
            optimizer.consolidate_state_dict(to=0)
        if self.is_coordinator:
            super(DistributedModelTrainer, self)._save_optimizer_state(optimizer, next_epoch)
        dist.barrier()

    # -- budgets ---------------------------------------------------------------
    def _probe_budgets(self, head: List[Any]) -> Dict[str, int]:
        """Budgets over this rank's finalized minibatches of ``head``, with
        the headroom, max-reduced over the world (a rank with none adds
        zeros). Every rank calls this at the same point."""
        mbs = [mb for mb, _ in head if mb is not None]
        local = torch.zeros(len(_BUDGET_KEYS), dtype=torch.int64)
        if mbs:
            budgets = suggest_budgets(mbs, self.node_shards, reorder=self._reorder)
            # the headroom keeps the slots multiples of the layout's supertile
            adj = mbs[0]["batch"].adjacency
            align = adj.edge_tile
            if adj.super_tile_row_blocks is not None:
                align = adj.senders.shape[0] // adj.super_tile_row_blocks.shape[0]
            h = self._budget_headroom

            def ceil_to(n, k):
                return -(-max(int(n), 1) // k) * k

            local = torch.tensor([ceil_to(budgets["boundary_budget"] * h, 8),
                                  ceil_to(budgets["interior_slots"] * h, align),
                                  ceil_to(budgets["boundary_slots"] * h, align)], dtype=torch.int64)
        local = local.to(self._device)
        dist.all_reduce(local, op=dist.ReduceOp.MAX)
        budgets = dict(zip(_BUDGET_KEYS, (int(v) for v in local.tolist())))
        if budgets["interior_slots"] <= 0:
            raise RuntimeError("no minibatch on any rank to probe the node-sharding budgets")
        return budgets

    def _start_groups(self, minibatch_iterator):
        self._epoch_shard_stats = self._fresh_stats()
        training = not self._in_validation
        if self.node_parallel.has_budgets and not (training and self._budgets_provisional):
            return minibatch_iterator
        head = list(itertools.islice(minibatch_iterator, self._budget_probe_batches))
        probed = self._probe_budgets(head)
        if self._budgets:  # never below the provisional budgets
            probed = {k: max(v, self._budgets[k]) for k, v in probed.items()}
        self._set_budgets(probed)
        self._budgets_provisional = not training
        self.LOGGER.info(
            "Node-sharding budgets probed over %d %s batches (headroom %.2fx%s): %s",
            len(head), "training" if training else "validation", self._budget_headroom,
            ", provisional until the first training pass" if not training else "", self._budgets,
        )
        return itertools.chain(head, minibatch_iterator)

    def _run_validation(self, *args, **kwargs):
        self._in_validation = True
        try:
            return super()._run_validation(*args, **kwargs)
        finally:
            self._in_validation = False
            self._log_shard_stats()

    def _run_training(self, *args, **kwargs):
        try:
            return super()._run_training(*args, **kwargs)
        finally:
            self._log_shard_stats()

    def _pass_samples(self, num_samples: int, weight_sum: float) -> int:
        """The samples of the slots that ran on this node: a skipped slot
        ran at weight 0. One rank of each node group adds its slots'
        weights to its node's entry; a sum over the world."""
        counts = torch.zeros(self.num_nodes, dtype=torch.int64, device=self._device)
        if self.rank % self.node_shards == 0:
            counts[self.node_rank] = int(round(weight_sum))
        dist.all_reduce(counts)
        return int(counts[self.node_rank].item())

    # -- this rank's shard -------------------------------------------------------
    @staticmethod
    def _fresh_stats() -> Dict[str, int]:
        return {"batches": 0, "skipped": 0, "boundary_rows": 0, "boundary_rows_max": 0}

    def shard_minibatch(self, mb_data: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """This rank's shard of a finalized minibatch; over budget, the BFS
        renumbering (when not in play already), then None with a warning."""
        np_ = self.node_parallel
        try:
            sharded = np_.shard_batch(mb_data)
        except BoundaryBudgetError as exc:
            if self._reorder is None:
                try:
                    sharded = np_.shard_batch(mb_data, reorder="bfs")
                except BoundaryBudgetError as exc2:
                    exc, sharded = exc2, None
            else:
                sharded = None
            if sharded is None:
                self._epoch_shard_stats["skipped"] += 1
                self.LOGGER.warning(
                    "Skipping a minibatch that exceeds the frozen node-sharding budgets (%s); re-run with a larger "
                    "--node-budget-headroom or explicit budgets to include it.", exc,
                )
                return None
        stats, s = np_.last_stats, self._epoch_shard_stats
        s["batches"] += 1
        s["boundary_rows"] += stats["boundary_nodes_total"]
        s["boundary_rows_max"] = max(s["boundary_rows_max"], stats["boundary_nodes_total"])
        return sharded

    def _prepare_minibatch(self, mb_data: Dict[str, Any], weight: float) -> Tuple[Dict[str, Any], float]:
        sharded = self.shard_minibatch(mb_data)
        if sharded is None:
            return self.node_parallel.shard_batch(self.empty_minibatch()), 0.0
        return sharded, weight

    def _log_shard_stats(self) -> None:
        s = self._epoch_shard_stats
        if s["batches"] or s["skipped"]:
            self.LOGGER.info(
                "Node-sharding pass stats: %d batches over %d shards, %d boundary rows exchanged per layer in all "
                "(at most %d a batch), %d batches skipped over budget.",
                s["batches"], self.node_shards, s["boundary_rows"], s["boundary_rows_max"], s["skipped"],
            )
