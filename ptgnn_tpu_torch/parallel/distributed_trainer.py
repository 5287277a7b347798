"""Distributed (data-parallel) model trainer: one process per GPU.

The counterpart of the JAX package's ``parallel/distributed_trainer.py``,
in PyTorch's idiom: every process runs this trainer over its own card
inside one ``torch.distributed`` process group (NCCL on the card, gloo on
the CPU), and the step is :class:`~ptgnn_tpu_torch.parallel.dp.DataParallel`'s
weighted one.

* Groups. The processes of one node form a group of ``local_world_size``
  slots. Every process of a node runs the same minibatch iterator (the same
  data, the same shuffle seed) and takes slot ``local_rank`` of each group,
  so the groups, the weights (each slot's count of real samples) and the
  padding are the JAX package's single-host groups exactly. Every rank
  assembles every minibatch (that fixes the group boundaries) but finalizes
  only its own slot's. A short last group is padded with the model's empty
  minibatch (``model.finalize_minibatch(model.initialize_minibatch())``) at
  weight 0.
* Nodes. Each node reads its own interleave of the files and, after every
  group, the processes all-reduce an "anyone left" flag; a node that has run
  out feeds empty groups until no node has data, as JAX's
  ``process_allgather`` loop does.
* Metadata is computed by rank 0 over the full data and broadcast with
  ``broadcast_object_list``; every rank then builds the module from the
  same seed, and rank 0's weights are broadcast to be sure.
* Checkpoints and the optimizer state are written by rank 0 alone; with
  ZeRO-1 the state is consolidated on rank 0 first.
* Dropout: each rank's generator is seeded from (seed, epoch, step) with
  ``dropout_rank`` folded in, so ranks draw different masks (rank 0 draws
  the single-device trainer's); the ranks of a node group share theirs.
* ``prefetch_to_device`` works as in :class:`ModelTrainer`, on this rank's
  minibatch of each group (after the node-sharded trainer takes its shard).
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
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

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

__all__ = ["DistributedModelTrainer", "initialize_multi_host"]


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

    Under NCCL the compiled steps capture collectives, and PyTorch's CUDA
    graph notes ask for NCCL's asynchronous error handling to be off: its
    watchdog would otherwise query the events of collectives while a graph
    is being captured, which a capture forbids. So it is set off here, for
    this process, before the group is made."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size or -1,
                            rank=rank if rank is not None else -1)


class DistributedModelTrainer(ModelTrainer):
    """:class:`ModelTrainer` whose optimization step is the weighted mean
    gradient over the process group's ranks. ``zero1`` shards the
    optimizer's moments (ZeRO-1). ``local_world_size`` is the number of
    ranks on each node (torchrun's ``LOCAL_WORLD_SIZE``; all of them when
    it is not set). ``device`` is this rank's card (``cuda:<local_rank>``)
    or the CPU."""

    LOGGER = logging.getLogger(__name__)

    def __init__(self, *args, zero1: bool = True, local_world_size: Optional[int] = None, **kwargs):
        if not dist.is_initialized():
            raise RuntimeError("the process group is not initialized: call initialize_multi_host first")
        super().__init__(*args, **kwargs)
        if self._catch_device_ooms:
            raise ValueError("catch_device_ooms: a rank that skipped a minibatch would stall the others")
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

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    @property
    def data_parallel(self) -> DataParallel:
        if self._dp is None or self._dp.module is not self.neural_module:
            self._dp = DataParallel(self.neural_module, enable_amp=self._enable_amp)
        return self._dp

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
    def empty_minibatch(self) -> Dict[str, Any]:
        """The fully masked minibatch that pads a short group."""
        if self._empty_minibatch is None:
            self._empty_minibatch = self._model.finalize_minibatch(self._model.initialize_minibatch())
        return self._empty_minibatch

    def _anyone_left(self, have: bool) -> bool:
        flag = torch.tensor([int(have)], device=self._device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    @property
    def dropout_rank(self) -> int:
        """The index folded into the dropout seeds: the rank (the node-
        sharded trainer's ranks of one node group share theirs, so that the
        work they replicate draws the same masks)."""
        return self.rank

    @property
    def finalize_slot(self) -> Tuple[int, int]:
        """(this rank's slot, slots per node) of each group of minibatches."""
        return self.local_rank, self.local_world_size

    def _start_groups(self, minibatch_iterator):
        """A hook at the start of every pass over the groups: returns the
        iterator to group (the node-sharded trainer probes its budgets)."""
        return minibatch_iterator

    def _prepare_minibatch(self, mb_data: Dict[str, Any], weight: float) -> Tuple[Dict[str, Any], float]:
        """A hook on this rank's host minibatch of each group (the node-
        sharded trainer takes this rank's shard of it)."""
        return mb_data, weight

    def group_minibatches(self, minibatch_iterator) -> Iterator[Tuple[Dict[str, Any], List[Any], float]]:
        """(this rank's host minibatch, the raw samples of its node's group,
        this rank's weight) for every group of ``finalize_slot[1]``
        minibatches; padding slots carry the empty minibatch at weight 0.
        The iterator needs to finalize only this rank's slot
        (``finalize_slot``)."""
        for mb_data, raw, weight in self._group_minibatches(self._start_groups(minibatch_iterator)):
            mb_data, weight = self._prepare_minibatch(mb_data, weight)
            yield mb_data, raw, weight

    def _group_minibatches(self, minibatch_iterator) -> Iterator[Tuple[Dict[str, Any], List[Any], float]]:
        slot, per_node = self.finalize_slot

        def local_groups():
            group: List[Dict[str, Any]] = []
            raw: List[Any] = []
            counts: List[float] = []
            for mb_data, raw_samples in minibatch_iterator:
                group.append(mb_data)
                raw.extend(raw_samples)
                counts.append(float(len(raw_samples)))
                if len(group) == per_node:
                    yield group, raw, counts
                    group, raw, counts = [], [], []
            if group:
                while len(group) < per_node:
                    group.append(self.empty_minibatch())
                    counts.append(0.0)
                yield group, raw, counts

        if self.num_nodes == 1:
            for group, raw, counts in local_groups():
                yield group[slot], raw, counts[slot]
            return
        groups = local_groups()
        while True:
            item = next(groups, None)
            if not self._anyone_left(item is not None):
                return
            if item is None:
                yield self.empty_minibatch(), [], 0.0
            else:
                group, raw, counts = item
                yield group[slot], raw, counts[slot]

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
        mb_iter = self._model.minibatch_iterator(
            training_tensors(),
            max_minibatch_size=self._minibatch_size,
            yield_partial_minibatches=False,
            shuffle_input=shuffle_input,
            parallelize=parallelize,
            # the same on every rank of a node, decorrelated across nodes
            shuffle_rng=random.Random(shuffle_seed(self._seed, epoch, self.node_rank)),
            finalize_slot=self.finalize_slot,
        )
        for step_idx, (mb_data, raw_samples, weight) in enumerate(
                self._device_minibatches(self.group_minibatches(mb_iter))):
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
            num_samples += len(raw_samples)
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
        for mb_data, raw_samples, weight in self.group_minibatches(self._model.minibatch_iterator(
            validation_tensors(),
            max_minibatch_size=self._minibatch_size,
            yield_partial_minibatches=True,
            shuffle_input=False,
            parallelize=parallelize,
            finalize_slot=self.finalize_slot,
        )):
            loss, metrics, group_weight = dp.eval_step(tree_to(mb_data, self._device), weight)
            group_weight = float(group_weight)
            sum_epoch_loss += float(loss) * group_weight
            sum_weight += group_weight
            num_samples += len(raw_samples)
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
