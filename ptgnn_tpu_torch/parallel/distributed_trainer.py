"""Distributed (data-parallel) model trainer: one process per GPU.

The counterpart of the JAX package's ``parallel/distributed_trainer.py``,
in PyTorch's idiom: every process runs this trainer over its own card
inside one ``torch.distributed`` process group (NCCL on the card, gloo on
the CPU), and the step is :class:`~ptgnn_tpu_torch.parallel.dp.DataParallel`'s
weighted one.

* Groups. The processes of one node form a group of ``local_world_size``
  slots. One of them, local rank 0, is the node's assembler: as the JAX
  package's one process per host, it alone tensorizes the node's data
  (forking the tensorize child, memorizing the data when asked), assembles
  and finalizes every minibatch of the node's stream, and hands each other
  rank of the node its slot of each group, with the slot's weight (its
  count of real samples) and the group's raw-sample count, over a gloo
  group of the node's ranks (``parallel/handoff.py``), in a thread that
  runs ahead of the steps. The other ranks never call the tensorize
  closures. So the groups, the weights and the padding are the JAX
  package's single-host groups exactly. A short last group is padded with
  the model's empty minibatch
  (``model.finalize_minibatch(model.initialize_minibatch())``) at weight 0.
  An error on the assembler reaches its peers as a message, and every rank
  raises. At one rank a node there is no handoff.
* Nodes. Each node reads its own interleave of the files and, after every
  group, the processes all-reduce an "anyone left" flag; a node that has run
  out feeds empty groups until no node has data, as JAX's
  ``process_allgather`` loop does. A rank whose node failed raises after
  that all-reduce, and the others with it.
* Metadata is computed by rank 0 over the full data and broadcast with
  ``broadcast_object_list``; every rank then builds the module from the
  same seed, and rank 0's weights are broadcast to be sure.
* Checkpoints and the optimizer state are written by rank 0 alone; with
  ZeRO-1 the state is consolidated on rank 0 first.
* Dropout: each rank's generator is seeded from (seed, epoch, step) with
  ``dropout_rank`` folded in, so ranks draw different masks (rank 0 draws
  the single-device trainer's); the ranks of a node group share theirs.
* ``prefetch_to_device`` works as in :class:`ModelTrainer`, on the
  minibatch this rank received (the node-sharded trainer's shard).
* The steps are :class:`~ptgnn_tpu_torch.parallel.dp.DataParallel`'s
  compiled ones (a CUDA graph per batch signature on the card): its train
  step without gradient accumulation, else its accumulation pair, and its
  eval step. They stay compiled across epochs, as :class:`ModelTrainer`'s
  do, and are made anew with the module.

A device OOM is not caught: a rank that skipped its minibatch would leave
the others waiting in the collective.
"""
from __future__ import annotations

import logging
import math
import os
import random
import time
import traceback
from typing import Any, Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ptgnn_tpu_torch.core.compiled_step import canonical_device
from ptgnn_tpu_torch.core.iterators import ThreadedIterator
from ptgnn_tpu_torch.core.metrics import MetricsAccumulator
from ptgnn_tpu_torch.core.trainer import (
    EpochProgress,
    ModelTrainer,
    make_capturable,
    shuffle_seed,
    step_seed,
    with_progress_bar,
)
from ptgnn_tpu_torch.graph.structs import tree_to
from ptgnn_tpu_torch.parallel.dp import DataParallel, zero1_optimizer
from ptgnn_tpu_torch.parallel.handoff import END, ERROR, SLOT, NodeHandoff, node_local_group

__all__ = ["DistributedModelTrainer", "initialize_multi_host"]

_OUT, _HAVE, _FAILED = 0, 1, 2  # a rank's state in the "anyone left" all-reduce
HANDOFF_AHEAD = 4  # groups that the assembling (or receiving) thread runs ahead of the steps


class _NodeEnd(NamedTuple):
    """The end of a node's stream: this rank's empty slot (host minibatch,
    weight 0, info, raw count 0), which it runs while other nodes have data."""

    slot: Tuple[Any, float, Dict, int]


def initialize_multi_host(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> None:
    """Join the process group: torchrun's environment (``env://``) unless
    ``init_method`` names another rendezvous (``file://`` or ``tcp://``,
    with ``world_size`` and ``rank``). The backend is NCCL where CUDA is
    available, gloo otherwise. Call before creating the trainer.

    Under NCCL the rank is bound to its card first: ``LOCAL_RANK`` from
    torchrun's environment, else the rank modulo the local world size
    (``LOCAL_WORLD_SIZE``, else the cards of this host). That card becomes
    the current device (``torch.cuda.set_device``), the hand kernels'
    launches and the trainer's ``device`` go to it, and the group is made
    with it as its ``device_id``. Under gloo nothing touches CUDA.

    Under NCCL the compiled steps capture collectives, and PyTorch's CUDA
    graph notes ask for NCCL's asynchronous error handling to be off: its
    watchdog would otherwise query the events of collectives while a graph
    is being captured, which a capture forbids. So it is set off here, for
    this process, before the group is made."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    rank = rank if rank is not None else -1
    kwargs = {}
    if backend == "nccl":
        os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
        kwargs["device_id"] = _local_device(rank)
        torch.cuda.set_device(kwargs["device_id"])
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size or -1,
                            rank=rank, **kwargs)


def _local_device(rank: int) -> torch.device:
    """This rank's card under NCCL: ``LOCAL_RANK`` where torchrun set it,
    else ``rank`` (torchrun's ``RANK`` when -1) modulo the local world size
    (``LOCAL_WORLD_SIZE``, else the number of cards on this host)."""
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if rank < 0:
        rank = int(os.environ.get("RANK", 0))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or torch.cuda.device_count()
    return torch.device("cuda", rank % per_host)


class DistributedModelTrainer(ModelTrainer):
    """:class:`ModelTrainer` whose optimization step is the weighted mean
    gradient over the process group's ranks. ``zero1`` shards the
    optimizer's moments (ZeRO-1). ``local_world_size`` is the number of
    ranks on each node (torchrun's ``LOCAL_WORLD_SIZE``; all of them when
    it is not set). ``device`` is this rank's card (``cuda:<local_rank>``,
    the current device, which ``initialize_multi_host`` binds; under NCCL
    another device raises) or the CPU."""

    LOGGER = logging.getLogger(__name__)

    def __init__(self, *args, zero1: bool = True, local_world_size: Optional[int] = None, **kwargs):
        if not dist.is_initialized():
            raise RuntimeError("the process group is not initialized: call initialize_multi_host first")
        super().__init__(*args, **kwargs)
        if self._catch_device_ooms:
            raise ValueError("catch_device_ooms: a rank that skipped a minibatch would stall the others")
        if dist.get_backend() == "nccl" and canonical_device(self._device) != torch.device(
                "cuda", torch.cuda.current_device()):
            raise ValueError(f"under NCCL the trainer's device ({self._device}) must be this rank's card, the "
                             f"current device (cuda:{torch.cuda.current_device()}): initialize_multi_host "
                             "binds it, or call torch.cuda.set_device")
        self._zero1 = zero1
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.local_world_size = local_world_size or int(os.environ.get("LOCAL_WORLD_SIZE", self.world_size))
        if self.world_size % self.local_world_size:
            raise ValueError(f"world size {self.world_size} is no multiple of the node's {self.local_world_size}")
        self.local_rank = self.rank % self.local_world_size
        self.node_rank = self.rank // self.local_world_size
        self.num_nodes = self.world_size // self.local_world_size
        self._dp: Optional[DataParallel] = None
        self._empty_minibatch: Optional[Dict[str, Any]] = None
        group, ranks = node_local_group(self.local_world_size)
        self._handoff = NodeHandoff(group, ranks) if group is not None else None

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    @property
    def data_parallel(self) -> DataParallel:
        if self._dp is None or self._dp.module is not self.neural_module:
            self._dp = DataParallel(self.neural_module, enable_amp=self._enable_amp)
        return self._dp

    def train(self, *args, **kwargs) -> None:
        """:meth:`ModelTrainer.train`, then (whatever its outcome) the
        compiled data-parallel steps' graphs are freed: NCCL's group
        destruction waits for every CUDA graph that captured one of its
        collectives, so a group destroyed after training would otherwise
        wait forever. A later call captures anew."""
        try:
            super().train(*args, **kwargs)
        finally:
            self._free_graphs()

    def _free_graphs(self) -> None:
        if self._dp is not None:
            self._dp.clear()

    # ------------------------------------------------------------------
    # Setup, checkpoints, optimizer
    # ------------------------------------------------------------------
    def _broadcast_module(self) -> None:
        """Rank 0's parameters and buffers to every rank."""
        for tensor in self.neural_module.state_dict().values():
            dist.broadcast(tensor, src=0)

    def load_metadata_and_create_network(self, training_data, parallelize: bool = True,
                                         show_progress_bar: bool = False) -> None:
        """Rank 0 computes the metadata over the full ``training_data`` (the
        other ranks do not read it) and broadcasts the model; every rank
        builds the module and takes rank 0's weights."""
        if not self._model.metadata_initialized:
            payload = [None]
            if self.is_coordinator:
                self._model.compute_metadata(with_progress_bar(iter(training_data), show_progress_bar, "metadata",
                                                               "sample"), parallelize)
                payload = [self._model]
            dist.broadcast_object_list(payload, src=0, device=self._device if self._device.type == "cuda" else None)
            if not self.is_coordinator:
                # Keep the caller's model object: take the received state.
                self._model.__dict__.update(payload[0].__dict__)
        self._neural_module = self._model.build_neural_module(device=self._device, seed=self._seed)
        self._broadcast_module()
        self.LOGGER.info("Model metadata loaded; %s trainable parameters.",
                         sum(p.numel() for p in self._neural_module.parameters()))
        for hook in self._metadata_finalized_hooks:
            hook(self._model)
        self._save_checkpoint()

    def _save_checkpoint(self) -> None:
        if self.is_coordinator:
            super()._save_checkpoint()
        dist.barrier()

    def _restore_checkpoint(self) -> None:
        """Rank 0 reads the best checkpoint (the file it wrote) and every
        rank takes its weights."""
        if self.is_coordinator:
            super()._restore_checkpoint()
        self._broadcast_module()

    def _create_optimizer(self):
        if not self._zero1:
            return super()._create_optimizer()
        optimizer = zero1_optimizer(self.neural_module.parameters(), self._optimizer_creator)
        if self._restored_optimizer_state is not None:
            optimizer.load_state_dict(self._restored_optimizer_state)  # the consolidated state
            self._restored_optimizer_state = None
        return optimizer, make_capturable(optimizer, self._device)

    def _save_optimizer_state(self, optimizer, next_epoch: int) -> None:
        if self._zero1:
            optimizer.consolidate_state_dict(to=0)  # a collective: every rank joins
        if self.is_coordinator:
            super()._save_optimizer_state(optimizer, next_epoch)
        dist.barrier()

    # ------------------------------------------------------------------
    # Groups
    # ------------------------------------------------------------------
    @property
    def is_assembler(self) -> bool:
        """Whether this rank assembles its node's minibatches (local rank 0)."""
        return self.local_rank == 0

    @property
    def slots_per_group(self) -> int:
        """The minibatches of each of a node's groups: one a rank."""
        return self.local_world_size

    @property
    def handoff_stats(self) -> Dict[str, float]:
        """This rank's slot messages so far: sent (the assembler) or
        received, their bytes and host seconds (``NodeHandoff.stats``)."""
        if self._handoff is None:
            return {"slots": 0, "bytes": 0, "seconds": 0.0, "pack_seconds": 0.0}
        return dict(self._handoff.stats)

    def empty_minibatch(self) -> Dict[str, Any]:
        """The fully masked minibatch that pads a short group."""
        if self._empty_minibatch is None:
            self._empty_minibatch = self._model.finalize_minibatch(self._model.initialize_minibatch())
        return self._empty_minibatch

    def _anyone_left(self, state: int) -> int:
        """The largest ``state`` (_OUT, _HAVE or _FAILED) of any rank."""
        flag = torch.tensor([state], device=self._device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return int(flag.item())

    @property
    def dropout_rank(self) -> int:
        """The index folded into the dropout seeds: the rank (the node-
        sharded trainer's ranks of one node group share theirs, so that the
        work they replicate draws the same masks)."""
        return self.rank

    def _start_groups(self, minibatches: Callable[[], Iterable]) -> Callable[[], Iterable]:
        """A hook at the start of every pass, on every rank: returns the
        factory of the node's stream that the assembler groups (the node-
        sharded trainer probes its budgets on it)."""
        return minibatches

    def _prepare_slot(self, mb_data: Dict[str, Any], weight: float) -> Tuple[List[Dict[str, Any]], float, Dict]:
        """The assembler's work on one slot of a group: (the host minibatch
        of each rank that takes the slot, the slot's weight, what those
        ranks record of it)."""
        return [mb_data], weight, {}

    def _took_slot(self, info: Dict) -> None:
        """A hook on every rank, for the ``info`` of each slot it takes."""

    def _rank_slots(self, group: List[Tuple[Dict[str, Any], float]]) -> List[Tuple[Dict[str, Any], float, Dict]]:
        """(host minibatch, weight, info) of each local rank, from a group's
        (minibatch, weight) slots."""
        out = []
        for mb_data, weight in group:
            payloads, weight, info = self._prepare_slot(mb_data, weight)
            out += [(payload, weight, info) for payload in payloads]
        return out

    def _assemble(self, minibatches: Iterable) -> Iterator[Tuple[List[Tuple[Dict[str, Any], float, Dict]], int]]:
        """The assembler's groups of ``slots_per_group`` minibatches: every
        local rank's (host minibatch, weight, info) and the group's raw-
        sample count. A short last group is padded with the empty minibatch
        at weight 0."""
        group: List[Tuple[Dict[str, Any], float]] = []
        raw = 0
        for mb_data, raw_samples in minibatches:
            group.append((mb_data, float(len(raw_samples))))
            raw += len(raw_samples)
            if len(group) == self.slots_per_group:
                yield self._rank_slots(group), raw
                group, raw = [], 0
        if group:
            group += [(self.empty_minibatch(), 0.0)] * (self.slots_per_group - len(group))
            yield self._rank_slots(group), raw

    def _assembled(self, minibatches: Callable[[], Iterable]) -> Iterator[Any]:
        """The assembler's (host minibatch, weight, info, raw count) of each
        group, each other rank's sent to it first; with other nodes, a last
        ``_NodeEnd`` with every rank's empty slot. An exception reaches the
        other ranks of the node as an error message, then raises here."""
        try:
            for slots, raw in self._assemble(minibatches()):
                if self._handoff is not None:
                    self._handoff.send(SLOT, [(*slot, raw) for slot in slots[1:]])
                yield (*slots[0], raw)
            ends = [None] * self.local_world_size
            if self.num_nodes > 1:
                ends = [(*slot, 0) for slot in self._rank_slots([(self.empty_minibatch(), 0.0)]
                                                                * self.slots_per_group)]
            if self._handoff is not None:
                self._handoff.send(END, ends[1:])
            if ends[0] is not None:
                yield _NodeEnd(ends[0])
        except Exception:
            if self._handoff is not None:
                self._handoff.send(ERROR, [traceback.format_exc()] * len(self._handoff.peers))
            raise

    def _received(self) -> Iterator[Any]:
        """The slots that the node's assembler sends this rank, as
        :meth:`_assembled` yields its own."""
        while True:
            kind, obj = self._handoff.receive()
            if kind == ERROR:
                raise RuntimeError(f"the node's assembler (rank {self._handoff.assembler}) failed:\n{obj}")
            if kind == END:
                if obj is not None:
                    yield _NodeEnd(obj)
                return
            yield obj

    def group_minibatches(self, minibatches: Callable[[], Iterable],
                          parallelize: bool = False) -> Iterator[Tuple[Dict[str, Any], int, float]]:
        """(this rank's host minibatch, the raw-sample count of its node's
        group, this rank's weight) for every group of ``slots_per_group``
        minibatches; padding slots carry the empty minibatch at weight 0.
        ``minibatches`` makes the node's stream of (finalized minibatch, raw
        samples); only the node's assembler calls it, and hands the others
        their slots. With ``parallelize`` the assembling and the handoff run
        ahead in a thread."""
        minibatches = self._start_groups(minibatches)
        local = ThreadedIterator(self._assembled(minibatches) if self.is_assembler else self._received(),
                                 max_queue_size=HANDOFF_AHEAD, enabled=parallelize)
        try:
            if self.num_nodes == 1:
                for mb_data, weight, info, raw in local:
                    self._took_slot(info)
                    yield mb_data, raw, weight
                return
            ended = None  # this rank's empty slot, once its node has run out
            while True:
                item = None
                try:
                    if ended is None:
                        item = next(local)
                        if isinstance(item, _NodeEnd):
                            ended, item = item.slot, None
                except Exception:
                    self._anyone_left(_FAILED)
                    raise
                state = self._anyone_left(_OUT if item is None else _HAVE)
                if state == _FAILED:
                    raise RuntimeError("the data pipeline of another node failed: its ranks raised")
                if state == _OUT:
                    return
                mb_data, weight, info, raw = ended if item is None else item
                self._took_slot(info)
                yield mb_data, raw, weight
        finally:
            local.close()

    # ------------------------------------------------------------------
    # Epoch loops
    # ------------------------------------------------------------------
    def _pass_samples(self, num_samples: int, weight_sum: float) -> int:
        """The samples a pass counts, from ``num_samples`` (its groups' raw
        samples) and ``weight_sum`` (the weights of this rank's slots): every
        slot with samples runs here, so the raw count."""
        return num_samples

    def _run_training(self, training_tensors, epoch, optimizer, base_lrs, scheduler, parallelize,
                      shuffle_input=True, show_progress_bar=False) -> None:
        sum_epoch_loss, num_minibatches, num_samples, weight_sum = 0.0, 0, 0, 0.0
        metrics_acc = MetricsAccumulator()
        start_time = time.time()
        self._opt_steps_this_epoch = 0
        progress = EpochProgress(show_progress_bar, epoch)
        dp = self.data_parallel

        def minibatches():  # the node's assembler alone makes its stream
            return self._model.minibatch_iterator(
                training_tensors(),
                max_minibatch_size=self._minibatch_size,
                yield_partial_minibatches=False,
                shuffle_input=shuffle_input,
                parallelize=parallelize,
                # decorrelated across nodes
                shuffle_rng=random.Random(shuffle_seed(self._seed, epoch, self.node_rank)),
            )

        for step_idx, (mb_data, num_raw, weight) in enumerate(
                self._device_minibatches(self.group_minibatches(minibatches, parallelize))):
            lr_factor = 1.0 if scheduler is None else scheduler.step(
                epoch, self._opt_steps_this_epoch if self._grad_accum_steps > 1 else step_idx
            )
            dp.generator.manual_seed(step_seed(self._seed, epoch, step_idx, self.dropout_rank))
            if self._grad_accum_steps == 1:
                loss, metrics = dp.train_step(mb_data, weight, None, optimizer, base_lrs,
                                              clip_gradient_norm=self._clip_gradient_norm, lr_factor=lr_factor)
                self._opt_steps_this_epoch += 1
            else:
                loss, metrics, _ = dp.grad_step(mb_data, weight)
                self._accumulated += 1
                self._last_lr_factor = lr_factor
                if self._accumulated >= self._grad_accum_steps:
                    self._apply(dp, optimizer, base_lrs, lr_factor)
            loss_f = float(loss)  # the same on every rank: all raise together
            if not math.isfinite(loss_f):
                raise RuntimeError("Loss has a NaN value.")
            sum_epoch_loss += loss_f
            num_minibatches += 1
            num_samples += num_raw
            weight_sum += weight
            metrics_acc.update(metrics)
            progress.update(loss_f)
        progress.close()
        if self._accumulated:  # a trailing partial accumulation group
            self._apply(dp, optimizer, base_lrs, self._last_lr_factor)
        self._report_training_epoch(epoch, sum_epoch_loss, num_minibatches,
                                    self._pass_samples(num_samples, weight_sum), metrics_acc,
                                    time.time() - start_time)

    def _apply(self, dp: DataParallel, optimizer, base_lrs, lr_factor: float) -> None:
        dp.apply_gradients(optimizer, base_lrs, clip_gradient_norm=self._clip_gradient_norm, lr_factor=lr_factor)
        self._accumulated = 0
        self._opt_steps_this_epoch += 1

    @torch.no_grad()
    def _run_validation(self, validation_tensors, epoch, best_target_metric, parallelize):
        """The epoch's loss weights each group by its real-sample count (a
        group of padding alone counts 0); metrics are summed over ranks."""
        sum_epoch_loss, sum_weight, num_samples, weight_sum = 0.0, 0.0, 0, 0.0
        metrics_acc = MetricsAccumulator()
        start_time = time.time()
        dp = self.data_parallel

        def minibatches():  # the node's assembler alone makes its stream
            return self._model.minibatch_iterator(validation_tensors(), max_minibatch_size=self._minibatch_size,
                                                  yield_partial_minibatches=True, shuffle_input=False,
                                                  parallelize=parallelize)

        for mb_data, num_raw, weight in self.group_minibatches(minibatches, parallelize):
            loss, metrics, group_weight = dp.eval_step(tree_to(mb_data, self._device), weight)
            group_weight = float(group_weight)
            sum_epoch_loss += float(loss) * group_weight
            sum_weight += group_weight
            num_samples += num_raw
            weight_sum += weight
            metrics_acc.update(metrics)
        num_samples = self._pass_samples(num_samples, weight_sum)
        if self.num_nodes > 1:  # each node counted its own groups' samples
            count = torch.tensor([num_samples if self.local_rank == 0 else 0], device=self._device)
            dist.all_reduce(count)
            num_samples = int(count.item())
        if num_samples == 0:
            raise RuntimeError("No validation data was found.")
        return self._report_validation(epoch, sum_epoch_loss / max(sum_weight, 1e-9), num_samples, metrics_acc,
                                       best_target_metric, time.time() - start_time)
