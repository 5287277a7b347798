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
  group take one slot of each group of minibatches and each run their own
  shard of it.
* Who assembles. The node's assembler (its local rank 0, as in
  :class:`DistributedModelTrainer`) tensorizes, assembles and finalizes
  the node's minibatches, reshards each slot once and sends rank ``r``
  shard ``r % node_shards`` of slot ``(r % local_world_size) //
  node_shards``, with the slot's weight and its resharding stats. The
  other ranks reshard nothing.
* Budgets. The static edge-slot and boundary budgets are probed by each
  node's assembler over the first minibatches of a pass
  (``suggest_budgets``, with a headroom factor) and max-reduced over the
  world (the other ranks add zeros), so every rank freezes the same
  budgets; they are never below what the empty minibatch needs. Budgets
  probed on a validation pass before any training are provisional: the
  first training pass probes again and keeps the larger.
* Over budget. A later minibatch over the frozen budgets is retried under
  the BFS renumbering (when that is not in play already), else skipped with
  a warning, decided once by the assembler: its slot's ranks run the empty
  minibatch at weight 0, so the other node groups need not know. (The JAX
  package drops it from the group and closes the group with the next one;
  the same minibatches train, grouped otherwise.) A pass counts the samples
  of the slots that ran, as the JAX package does: the weights of each node
  group's slots, summed over the node's ranks at the pass's end.
* ZeRO-1 shards the optimizer's moments over the data group.
"""
from __future__ import annotations

import itertools
import logging
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

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
        self._budgets_frozen = False  # raised to the empty minibatch's needs, the same on every rank
        self._in_validation = False

    @property
    def slots_per_group(self) -> int:
        return self.local_world_size // self.node_shards

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
            if self._budgets is not None:  # raised to the empty minibatch's needs at the first pass
                self._np.set_budgets(**self._budgets)
        return self._np

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
    def _probe_budgets(self, head: List[Any]) -> List[int]:
        """The budgets over the assembler's finalized minibatches of
        ``head``, with the headroom, and never below the empty minibatch's
        needs (those alone where ``head`` is empty)."""
        floor = suggest_budgets([self.empty_minibatch()], self.node_shards, reorder=self._reorder)
        if not head:
            return [floor[k] for k in _BUDGET_KEYS]
        budgets = suggest_budgets([mb for mb, _ in head], self.node_shards, reorder=self._reorder)
        # the headroom keeps the slots multiples of the layout's supertile
        adj = head[0][0]["batch"].adjacency
        align = adj.edge_tile
        if adj.super_tile_row_blocks is not None:
            align = adj.senders.shape[0] // adj.super_tile_row_blocks.shape[0]
        h = self._budget_headroom

        def ceil_to(n, k):
            return -(-max(int(n), 1) // k) * k

        probed = [ceil_to(budgets["boundary_budget"] * h, 8), ceil_to(budgets["interior_slots"] * h, align),
                  ceil_to(budgets["boundary_slots"] * h, align)]
        return [max(p, floor[k]) for p, k in zip(probed, _BUDGET_KEYS)]

    def _start_groups(self, minibatches: Callable[[], Iterable]) -> Callable[[], Iterable]:
        """Freeze the budgets where they are not (every rank, at the same
        point): each node's assembler probes them on the head of its stream
        (or, for budgets given, only the empty minibatch's needs) and the
        world max-reduces (budgets, head length, failed), the other ranks
        adding zeros. A failure on any assembler raises on every rank."""
        self._epoch_shard_stats = self._fresh_stats()
        training = not self._in_validation
        if self._budgets_frozen and not (training and self._budgets_provisional):
            return minibatches
        probe = self._budgets is None or self._budgets_frozen
        head: List[Any] = []
        local = [0] * (len(_BUDGET_KEYS) + 2)
        failure: Optional[BaseException] = None
        stream = None
        if self.is_assembler:
            try:
                if probe:
                    stream = iter(minibatches())
                    head = list(itertools.islice(stream, self._budget_probe_batches))
                local = [*self._probe_budgets(head), len(head), 0]
            except Exception as exc:
                failure, local = exc, [0] * len(_BUDGET_KEYS) + [0, 1]
        reduced = torch.tensor(local, dtype=torch.int64, device=self._device)
        dist.all_reduce(reduced, op=dist.ReduceOp.MAX)
        *values, probed_batches, failed = (int(v) for v in reduced.tolist())
        if failure is not None:
            raise failure
        if failed:
            raise RuntimeError("a node's assembler failed while probing the node-sharding budgets: its ranks raised")
        budgets = dict(zip(_BUDGET_KEYS, values))
        if probe and not probed_batches:
            raise RuntimeError("no minibatch on any node to probe the node-sharding budgets")
        if self._budgets:  # never below the provisional (or given) budgets
            budgets = {k: max(v, self._budgets[k]) for k, v in budgets.items()}
        self._budgets = budgets
        self.node_parallel.set_budgets(**budgets)
        self._budgets_frozen = True
        if probe:
            self._budgets_provisional = not training
            self.LOGGER.info(
                "Node-sharding budgets probed over %d %s batches (headroom %.2fx%s): %s",
                probed_batches, "training" if training else "validation", self._budget_headroom,
                ", provisional until the first training pass" if not training else "", self._budgets,
            )
        if stream is None:
            return minibatches
        return lambda: itertools.chain(head, stream)

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

    # -- the assembler's shards ---------------------------------------------------
    @staticmethod
    def _fresh_stats() -> Dict[str, int]:
        return {"batches": 0, "skipped": 0, "boundary_rows": 0, "boundary_rows_max": 0}

    def shard_minibatch(self, mb_data: Dict[str, Any]) -> Optional[Tuple[List[Dict[str, Any]], Dict[str, Any]]]:
        """(every node-group rank's shard, the exchange stats) of a
        finalized minibatch; over budget, the BFS renumbering (when not in
        play already), then None with a warning."""
        np_ = self.node_parallel
        try:
            return np_.shard_all(mb_data)
        except BoundaryBudgetError as exc:
            if self._reorder is None:
                try:
                    return np_.shard_all(mb_data, reorder="bfs")
                except BoundaryBudgetError as exc2:
                    exc = exc2
            self.LOGGER.warning(
                "Skipping a minibatch that exceeds the frozen node-sharding budgets (%s); re-run with a larger "
                "--node-budget-headroom or explicit budgets to include it.", exc,
            )
            return None

    def _prepare_slot(self, mb_data: Dict[str, Any], weight: float) -> Tuple[List[Dict[str, Any]], float, Dict]:
        sharded = self.shard_minibatch(mb_data)
        if sharded is None:  # the budgets always fit the empty minibatch
            return self.node_parallel.shard_all(self.empty_minibatch())[0], 0.0, {"skipped": True}
        shards, stats = sharded
        return shards, weight, {"boundary_rows": stats["boundary_nodes_total"]}

    def _took_slot(self, info: Dict) -> None:
        s = self._epoch_shard_stats
        if info.get("skipped"):
            s["skipped"] += 1
            return
        s["batches"] += 1
        s["boundary_rows"] += info["boundary_rows"]
        s["boundary_rows_max"] = max(s["boundary_rows_max"], info["boundary_rows"])

    def _log_shard_stats(self) -> None:
        s = self._epoch_shard_stats
        if s["batches"] or s["skipped"]:
            self.LOGGER.info(
                "Node-sharding pass stats: %d batches over %d shards, %d boundary rows exchanged per layer in all "
                "(at most %d a batch), %d batches skipped over budget.",
                s["batches"], self.node_shards, s["boundary_rows"], s["boundary_rows_max"], s["skipped"],
            )
