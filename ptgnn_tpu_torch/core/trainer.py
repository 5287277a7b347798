"""Single-device training loop: the counterpart of the JAX package's
``core/trainer.py``.

Metadata pass -> build module -> clip + Adam -> epoch loop with a NaN-loss
guard, a per-step scheduler, gradient accumulation, validation-driven early
stopping and best-checkpoint save/restore, plus the five hook families.

* The optimizer is optax's ``chain(clip_by_global_norm(c), adam(lr))``:
  :func:`clip_by_global_norm_` writes optax's clip formula, and
  ``torch.optim.Adam`` with optax's defaults has Adam's update rule.
* AMP keeps float32 master parameters and runs the forward with bfloat16
  copies swapped into each module object for the call (a module used at
  several positions, as the GGNN stack's shared layer, is swapped once);
  autograd brings the gradients back to float32 through the cast. No loss
  scaling: bf16 keeps float32's exponent range.
* Dropout draws from one ``torch.Generator`` on the device, re-seeded from
  (seed, epoch, step) before every step, as the JAX trainer folds its key.

The neural-module protocol: ``module(**minibatch, train=..., generator=...)``
returns ``(loss, metric accumulators)``; ``module.finalize_metrics(sums)``
reports them.
"""
from __future__ import annotations

import contextlib
import json
import logging
import math
import random
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Protocol, Sequence, Tuple

import torch

from ptgnn_tpu_torch.core import checkpoint as ckpt
from ptgnn_tpu_torch.core.data import MemorizedDataIterable
from ptgnn_tpu_torch.core.metrics import MetricsAccumulator
from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.device import DeviceLike, resolve_device
from ptgnn_tpu_torch.graph.structs import tree_to

__all__ = [
    "ModelTrainer", "AbstractScheduler", "EndOfEpochHook", "clip_by_global_norm_",
    "module_loss", "optimizer_step",
]

EndOfEpochHook = Callable[[AbstractNeuralModel, torch.nn.Module, int, Dict], None]
OptimizerCreator = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


class AbstractScheduler(Protocol):
    """Learning-rate schedule queried per optimizer step; returns a factor on
    the optimizer's base update (``core/schedulers.py``)."""

    def step(self, epoch_idx: int, epoch_step: int) -> float:
        ...


def default_optimizer(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """optax.adam(1e-3): b1 0.9, b2 0.999, eps 1e-8."""
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: every gradient is scaled by
    ``max_norm / norm`` unless the global norm is below ``max_norm``.
    (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``.) Returns
    the global norm; nothing waits for the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(grads), scale)
    return norm


def _cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_cast_floats(x, dtype) for x in tree))
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(x, dtype) for x in tree)
    return tree


@contextlib.contextmanager
def _cast_parameters(module: torch.nn.Module, dtype: torch.dtype):
    """Every floating parameter replaced by a ``dtype`` copy while the block
    runs, then restored. Each module object is visited once, so a module
    reached through several paths keeps one copy (``functional_call`` swaps
    by path and leaves such a module holding a copy)."""
    swapped = []
    try:
        for sub in module.modules():
            for name, p in list(sub._parameters.items()):
                if p is not None and p.is_floating_point():
                    sub._parameters[name] = p.to(dtype)
                    swapped.append((sub, name, p))
        yield
    finally:
        for sub, name, p in reversed(swapped):
            sub._parameters[name] = p


def module_loss(
    module: torch.nn.Module,
    minibatch: Dict[str, Any],
    *,
    train: bool,
    generator: Optional[torch.Generator] = None,
    amp: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(float32 loss, metrics) of one device-resident minibatch. Under
    ``amp`` the forward sees bfloat16 copies of the float32 parameters and of
    the minibatch's float arrays, and gradients flow back through the cast."""
    kwargs = dict(minibatch, train=train, generator=generator)
    if amp:
        with _cast_parameters(module, torch.bfloat16):
            loss, metrics = module(**_cast_floats(kwargs, torch.bfloat16))
    else:
        loss, metrics = module(**kwargs)
    return loss.float(), metrics


def optimizer_step(
    module: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    base_lrs: Sequence[float],
    *,
    clip_gradient_norm: Optional[float] = None,
    lr_factor: float = 1.0,
    grad_divisor: int = 1,
) -> None:
    """Apply the gradients held in ``.grad`` (divided by ``grad_divisor``,
    the number of accumulated microbatches), clipped, with the learning rate
    scaled by ``lr_factor``; then clear them."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if grad_divisor > 1:
        torch._foreach_div_(grads, float(grad_divisor))
    if clip_gradient_norm is not None:
        clip_by_global_norm_(grads, clip_gradient_norm)
    for group, base in zip(optimizer.param_groups, base_lrs):
        group["lr"] = base * lr_factor
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def shuffle_seed(seed: int, epoch: int, node: int = 0) -> int:
    """The seed of one epoch's shuffle; a data-parallel node folds its index
    in (node 0 keeps the single-device order)."""
    return seed * 1_000_003 + epoch + node * 0x9E3779B97F4A7C15


def step_seed(seed: int, epoch: int, step: int, rank: int = 0) -> int:
    """The dropout generator's seed of one step; a data-parallel rank folds
    its index in (rank 0 keeps the single-device seed)."""
    seed = ((seed * 1_000_003 + epoch) * 1_000_003 + step) % (1 << 63)
    return (seed + rank * 0x9E3779B97F4A7C15) % (1 << 63)


class ModelTrainer:
    LOGGER = logging.getLogger(__name__)

    def __init__(
        self,
        model: AbstractNeuralModel,
        checkpoint_location: Path,
        *,
        max_num_epochs: int = 100,
        minibatch_size: int = 200,
        optimizer_creator: Optional[OptimizerCreator] = None,
        scheduler_creator: Optional[Callable[[], AbstractScheduler]] = None,
        clip_gradient_norm: Optional[float] = None,
        target_validation_metric: Optional[str] = None,
        target_validation_metric_higher_is_better: bool = False,
        enable_amp: bool = False,
        catch_device_ooms: bool = False,
        gradient_accumulation_steps: int = 1,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        if gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")
        if target_validation_metric is None and target_validation_metric_higher_is_better:
            raise ValueError("without an explicit metric the validation loss is used: lower is better")
        self._model = model
        self._neural_module: Optional[torch.nn.Module] = None
        self._checkpoint_location = Path(checkpoint_location)
        self._max_num_epochs = max_num_epochs
        self._minibatch_size = minibatch_size
        self._optimizer_creator = optimizer_creator or default_optimizer
        self._scheduler_creator = scheduler_creator
        self._clip_gradient_norm = clip_gradient_norm
        self._target_metric = target_validation_metric
        self._target_metric_higher_is_better = target_validation_metric_higher_is_better
        self._enable_amp = enable_amp
        self._catch_device_ooms = catch_device_ooms
        self._grad_accum_steps = gradient_accumulation_steps
        self._seed = seed
        self._device = resolve_device(device)

        self._accumulated = 0  # microbatches whose gradients sit in .grad
        self._opt_steps_this_epoch = 0  # the schedule's step index
        self._last_lr_factor = 1.0
        self._restored_optimizer_state: Optional[Dict[str, Any]] = None
        self._start_epoch_override: Optional[int] = None

        self._metadata_finalized_hooks: List[Callable[[AbstractNeuralModel], None]] = []
        self._training_start_hooks: List[Callable[[AbstractNeuralModel, Any, Any], None]] = []
        self._train_epoch_end_hooks: List[EndOfEpochHook] = []
        self._validation_epoch_end_hooks: List[EndOfEpochHook] = []
        self._improved_epoch_end_hooks: List[EndOfEpochHook] = []

    # ------------------------------------------------------------------
    @property
    def model(self) -> AbstractNeuralModel:
        return self._model

    @property
    def neural_module(self) -> torch.nn.Module:
        if self._neural_module is None:
            raise RuntimeError("Neural module has not been built.")
        return self._neural_module

    # ------------------------------------------------------------------
    # Hooks
    # ------------------------------------------------------------------
    def register_model_metadata_finalized_hook(self, hook) -> None:
        self._metadata_finalized_hooks.append(hook)

    def register_training_start_hook(self, hook) -> None:
        self._training_start_hooks.append(hook)

    def register_train_epoch_end_hook(self, hook: EndOfEpochHook) -> None:
        self._train_epoch_end_hooks.append(hook)

    def register_validation_epoch_end_hook(self, hook: EndOfEpochHook) -> None:
        self._validation_epoch_end_hooks.append(hook)

    def register_epoch_improved_end_hook(self, hook: EndOfEpochHook) -> None:
        self._improved_epoch_end_hooks.append(hook)

    # ------------------------------------------------------------------
    # Setup and checkpoints
    # ------------------------------------------------------------------
    def load_metadata_and_create_network(self, training_data: Iterable, parallelize: bool = True) -> None:
        if not self._model.metadata_initialized:
            self._model.compute_metadata(iter(training_data), parallelize)
        self._neural_module = self._model.build_neural_module(device=self._device, seed=self._seed)
        num_params = sum(p.numel() for p in self._neural_module.parameters())
        self.LOGGER.info("Model metadata loaded; %s trainable parameters.", num_params)
        for hook in self._metadata_finalized_hooks:
            hook(self._model)
        self._save_checkpoint()

    def restore_parameters(self, path: Optional[Path] = None, restore_optimizer: bool = False) -> None:
        """Resume from a checkpoint of :meth:`AbstractNeuralModel.save` (and,
        with ``restore_optimizer``, its ``.optimizerstate`` sibling)."""
        path = Path(path) if path is not None else self._checkpoint_location
        _, state = self._model.restore_model(path)
        self._neural_module = self._model.build_neural_module(device=self._device, seed=self._seed)
        self._neural_module.load_state_dict(state)
        opt_path = ckpt.optimizer_state_path(path)
        if restore_optimizer and opt_path.exists():
            self._restored_optimizer_state, self._start_epoch_override = ckpt.load_optimizer_state(opt_path)

    def _save_checkpoint(self) -> None:
        self._model.save(self._checkpoint_location, self.neural_module)

    def _restore_checkpoint(self) -> None:
        if not self._checkpoint_location.exists():
            self.LOGGER.warning(
                "No checkpoint at %s (no epoch improved on the starting model); "
                "keeping current parameters.", self._checkpoint_location,
            )
            return
        _, state = self._model.restore_model(self._checkpoint_location)
        self.neural_module.load_state_dict(state)

    def _save_optimizer_state(self, optimizer: torch.optim.Optimizer, next_epoch: int) -> None:
        ckpt.save_optimizer_state(
            ckpt.optimizer_state_path(self._checkpoint_location), optimizer.state_dict(), next_epoch
        )

    def _create_optimizer(self) -> Tuple[torch.optim.Optimizer, List[float]]:
        optimizer = self._optimizer_creator(self.neural_module.parameters())
        if self._restored_optimizer_state is not None:
            optimizer.load_state_dict(self._restored_optimizer_state)
            self._restored_optimizer_state = None
        return optimizer, [group["lr"] for group in optimizer.param_groups]

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def _apply_accumulated(self, optimizer, base_lrs, lr_factor: float) -> None:
        optimizer_step(
            self.neural_module, optimizer, base_lrs, clip_gradient_norm=self._clip_gradient_norm,
            lr_factor=lr_factor, grad_divisor=self._accumulated,
        )
        self._accumulated = 0
        self._opt_steps_this_epoch += 1

    def _train_step(self, minibatch, generator, optimizer, base_lrs, lr_factor: float):
        """Forward and backward of one microbatch; every k-th applies the
        mean gradient of the last k. Returns (host loss, metrics)."""
        loss, metrics = module_loss(
            self.neural_module, tree_to(minibatch, self._device), train=True,
            generator=generator, amp=self._enable_amp,
        )
        loss.backward()
        loss_f = float(loss.detach())  # waits for the step, so a device OOM raises here
        self._accumulated += 1
        self._last_lr_factor = lr_factor
        if self._accumulated >= self._grad_accum_steps:
            self._apply_accumulated(optimizer, base_lrs, lr_factor)
        return loss_f, metrics

    # ------------------------------------------------------------------
    # Epoch loops
    # ------------------------------------------------------------------
    def _run_training(self, training_tensors, epoch, optimizer, base_lrs, scheduler, parallelize,
                      shuffle_input=True) -> None:
        sum_epoch_loss, num_minibatches, num_samples = 0.0, 0, 0
        metrics_acc = MetricsAccumulator()
        start_time = time.time()
        self._opt_steps_this_epoch = 0
        generator = torch.Generator(device=self._device)
        mb_iter = self._model.minibatch_iterator(
            training_tensors(),
            max_minibatch_size=self._minibatch_size,
            yield_partial_minibatches=False,
            shuffle_input=shuffle_input,
            parallelize=parallelize,
            # data order is part of the training seed: same seed -> same run
            shuffle_rng=random.Random(shuffle_seed(self._seed, epoch)),
        )
        for step_idx, (mb_data, raw_samples) in enumerate(mb_iter):
            # Schedules count optimizer steps: under gradient accumulation k
            # microbatches share one index.
            lr_factor = 1.0 if scheduler is None else scheduler.step(
                epoch, self._opt_steps_this_epoch if self._grad_accum_steps > 1 else step_idx
            )
            generator.manual_seed(step_seed(self._seed, epoch, step_idx))
            try:
                loss_f, metrics = self._train_step(mb_data, generator, optimizer, base_lrs, lr_factor)
            except torch.cuda.OutOfMemoryError:
                if not self._catch_device_ooms:
                    raise
                # Skip the minibatch, and the partial accumulation group
                # whose gradients it may have touched.
                self.LOGGER.exception("A device OOM error was caught; skipping minibatch.")
                optimizer.zero_grad(set_to_none=True)
                self._accumulated = 0
                continue
            if not math.isfinite(loss_f):
                raise RuntimeError("Loss has a NaN value.")
            sum_epoch_loss += loss_f
            num_minibatches += 1
            num_samples += len(raw_samples)
            metrics_acc.update(metrics)
        if self._accumulated:  # a trailing partial accumulation group
            self._apply_accumulated(optimizer, base_lrs, self._last_lr_factor)
        self._report_training_epoch(epoch, sum_epoch_loss, num_minibatches, num_samples, metrics_acc,
                                    time.time() - start_time)

    def _report_training_epoch(self, epoch, sum_epoch_loss, num_minibatches, num_samples, metrics_acc,
                               elapsed) -> None:
        """Log the epoch's loss and throughput and run the train-epoch hooks."""
        if num_minibatches == 0:
            raise RuntimeError(
                "No training minibatches were created. The minibatch size may be too large "
                "or the training dataset size too small."
            )
        self.LOGGER.info("Training complete in %.1fsec [%.2f samples/sec]", elapsed, num_samples / elapsed)
        self.LOGGER.info("Epoch %i: Train Loss %.2f", epoch + 1, sum_epoch_loss / num_minibatches)
        totals = metrics_acc.totals()
        train_metrics = self.neural_module.finalize_metrics(totals)
        train_metrics["_throughput"] = {
            "samples_per_sec": num_samples / elapsed,
            **{f"{k}_per_sec": totals[k] / elapsed for k in ("num_graphs", "num_nodes", "num_edges") if k in totals},
        }
        for hook in self._train_epoch_end_hooks:
            hook(self._model, self.neural_module, epoch, train_metrics)
        self.LOGGER.info("Training Metrics: %s", json.dumps(train_metrics, indent=2))

    @torch.no_grad()
    def _run_validation(self, validation_tensors, epoch, best_target_metric, parallelize):
        sum_epoch_loss, num_minibatches, num_samples = 0.0, 0, 0
        metrics_acc = MetricsAccumulator()
        start_time = time.time()
        for mb_data, raw_samples in self._model.minibatch_iterator(
            validation_tensors(),
            max_minibatch_size=self._minibatch_size,
            yield_partial_minibatches=True,
            shuffle_input=False,
            parallelize=parallelize,
        ):
            loss, metrics = module_loss(
                self.neural_module, tree_to(mb_data, self._device), train=False, amp=self._enable_amp
            )
            sum_epoch_loss += float(loss)
            num_minibatches += 1
            num_samples += len(raw_samples)
            metrics_acc.update(metrics)
        if num_samples == 0:
            raise RuntimeError("No validation data was found.")
        return self._report_validation(epoch, sum_epoch_loss / num_minibatches, num_samples, metrics_acc,
                                       best_target_metric, time.time() - start_time)

    def _report_validation(self, epoch, validation_loss, num_samples, metrics_acc, best_target_metric, elapsed):
        """Log the validation epoch, run its hooks; returns (target metric,
        improved, validation metrics)."""
        self.LOGGER.info("Validation complete in %.1fsec [%.2f samples/sec]", elapsed, num_samples / elapsed)
        self.LOGGER.info("Epoch %i: Valid Loss %.2f", epoch + 1, validation_loss)

        validation_metrics = self.neural_module.finalize_metrics(metrics_acc.totals())
        for hook in self._validation_epoch_end_hooks:
            hook(self._model, self.neural_module, epoch, validation_metrics)
        self.LOGGER.info("Validation Metrics: %s", json.dumps(validation_metrics, indent=2))

        target_metric = (
            validation_metrics[self._target_metric] if self._target_metric is not None else validation_loss
        )
        if self._target_metric_higher_is_better:
            improved = target_metric > best_target_metric
        else:
            improved = target_metric < best_target_metric
        return target_metric, improved, validation_metrics

    # ------------------------------------------------------------------
    def train(
        self,
        training_data: Iterable,
        validation_data: Iterable,
        *,
        validate_on_start: bool = True,
        patience: int = 5,
        initialize_metadata: bool = True,
        parallelize: bool = True,
        store_tensorized_data_in_memory: bool = False,
        shuffle_training_data: bool = True,
        start_epoch_idx: int = 0,
    ) -> None:
        if initialize_metadata:
            self.load_metadata_and_create_network(training_data, parallelize)

        def training_tensors():
            return self._model.tensorize_dataset(iter(training_data), parallelize=parallelize)

        def validation_tensors():
            return self._model.tensorize_dataset(iter(validation_data), parallelize=parallelize)

        if store_tensorized_data_in_memory:
            training_tensors = MemorizedDataIterable(
                training_tensors, shuffle=True, rng=random.Random(self._seed)
            )
            validation_tensors = MemorizedDataIterable(validation_tensors)

        optimizer, base_lrs = self._create_optimizer()
        if self._start_epoch_override is not None:
            start_epoch_idx = max(start_epoch_idx, self._start_epoch_override)
            self._start_epoch_override = None
        scheduler = None if self._scheduler_creator is None else self._scheduler_creator()
        for hook in self._training_start_hooks:
            hook(self._model, self.neural_module, optimizer)

        if self._target_metric_higher_is_better:
            best_target_metric = -math.inf
        else:
            best_target_metric = math.inf
        if validate_on_start:
            target_metric, _, _ = self._run_validation(
                validation_tensors, start_epoch_idx, best_target_metric, parallelize
            )
            self.LOGGER.info("Initial %s: %s", self._target_metric or "Loss", target_metric)
            best_target_metric = target_metric

        num_epochs_not_improved = 0
        for epoch in range(start_epoch_idx, self._max_num_epochs):
            self._run_training(
                training_tensors, epoch, optimizer, base_lrs, scheduler, parallelize, shuffle_training_data
            )
            self._save_optimizer_state(optimizer, epoch + 1)
            target_metric, improved, validation_metrics = self._run_validation(
                validation_tensors, epoch, best_target_metric, parallelize
            )
            if improved:
                self.LOGGER.info(
                    "Best performance so far (%s: %.3f from %.3f). Saving model checkpoint.",
                    self._target_metric or "Loss", target_metric, best_target_metric,
                )
                num_epochs_not_improved = 0
                self._save_checkpoint()
                best_target_metric = target_metric
                for hook in self._improved_epoch_end_hooks:
                    hook(self._model, self.neural_module, epoch, validation_metrics)
            else:
                num_epochs_not_improved += 1
                if num_epochs_not_improved > patience:
                    self.LOGGER.warning(
                        "The target metric has not improved for %s epochs. Stopping.",
                        num_epochs_not_improved,
                    )
                    break
        # Restore the best parameters found.
        self._restore_checkpoint()
