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
* The train step (:class:`TrainStep`: forward, backward, clip, optimizer;
  under accumulation its grad and apply pair) and the validation step are
  compiled (``core/compiled_step.py``): on the card each is captured as a
  CUDA graph per batch signature and replayed, as the JAX trainer jits them.
* ``prefetch_to_device`` minibatches are copied to the card ahead of their
  step (:func:`prefetch_to_device`), and with ``catch_device_ooms`` a device
  OOM raised by a copy or a step skips that minibatch (``utils/oom.py``).

The neural-module protocol: ``module(**minibatch, train=..., generator=...)``
returns ``(loss, metric accumulators)``; ``module.finalize_metrics(sums)``
reports them.
"""
from __future__ import annotations

import contextlib
import functools
import json
import logging
import math
import random
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Protocol, Sequence, Tuple

import torch

from ptgnn_tpu_torch.core import checkpoint as ckpt
from ptgnn_tpu_torch.core.compiled_step import CompiledStep
from ptgnn_tpu_torch.core.data import MemorizedDataIterable
from ptgnn_tpu_torch.core.metrics import MetricsAccumulator
from ptgnn_tpu_torch.core.model import AbstractNeuralModel
from ptgnn_tpu_torch.device import DeviceLike, resolve_device
from ptgnn_tpu_torch.graph.structs import tree_tensors, tree_to
from ptgnn_tpu_torch.utils.oom import is_oom_error, release_cached_memory

__all__ = [
    "ModelTrainer", "AbstractScheduler", "EndOfEpochHook", "clip_by_global_norm_",
    "module_loss", "optimizer_step", "prefetch_to_device", "make_capturable", "TrainStep",
]

LOGGER = logging.getLogger(__name__)

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
        set_learning_rate(group, base * lr_factor)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def set_learning_rate(group: Dict[str, Any], lr: float) -> None:
    """A parameter group's learning rate: filled in place where it is a
    device scalar (:func:`make_capturable`), else set."""
    if isinstance(group["lr"], torch.Tensor):
        group["lr"].fill_(lr)
    else:
        group["lr"] = lr


def make_capturable(optimizer: torch.optim.Optimizer, device: torch.device) -> List[float]:
    """Prepare ``optimizer`` for a step that a CUDA graph captures; returns
    the base learning rate of each parameter group. Every trainer's
    optimizer goes through it, compiled or not, so that all of them update
    with the same arithmetic. Under ZeRO-1 (``ZeroRedundancyOptimizer``)
    its local optimizer is the one prepared, and the global groups, which
    ZeRO copies into the local ones at every step, carry the same rates.

    On CUDA every group becomes ``capturable`` (the step count stays on the
    device) and its learning rate a device scalar, which the caller fills
    before each step; on the CPU, where torch refuses ``capturable`` and no
    graph exists, the rate stays a Python float, and a restored checkpoint's
    CUDA flags are taken back. Empty state is allocated now, as the
    optimizer's first step would (zeros), so a graph captures the update of
    state that exists. The base rate of a group is its ``initial_lr`` where
    a restored checkpoint holds one. Only Adam and AdamW are taken: another
    optimizer raises, naming it."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    local = optimizer.optim if isinstance(optimizer, ZeroRedundancyOptimizer) else optimizer
    if type(local) not in (torch.optim.Adam, torch.optim.AdamW):
        raise TypeError(
            f"{type(local).__name__} cannot run in a compiled (CUDA graph) step: use torch.optim.Adam or AdamW"
        )
    cuda = device.type == "cuda"
    base_lrs = []
    for group in optimizer.param_groups:
        # The base rate is kept as torch's schedulers keep it, so that a
        # checkpoint taken after a scaled step restores the base, not the
        # scaled rate.
        base = float(group.setdefault("initial_lr", float(group["lr"])))
        base_lrs.append(base)
        group["capturable"] = cuda
        group["lr"] = torch.tensor(base, dtype=torch.float32, device=device) if cuda else base
    for group, local_group in zip(optimizer.param_groups, local.param_groups):
        if local_group is not group:
            local_group.update({k: v for k, v in group.items() if k != "params"})
        for p in local_group["params"]:
            state = local.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                if local_group["amsgrad"]:
                    state["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            else:
                state["step"] = state["step"].to(device=p.device if cuda else "cpu", dtype=torch.float32)
    return base_lrs


class TrainStep:
    """The train step of ``module``: forward, backward, the clip and the
    optimizer, written once and compiled (``core/compiled_step.py``) as the
    JAX trainer jits its ``train_step``; with gradient accumulation, JAX's
    pair: :meth:`accumulate` (forward and backward, adding into the
    gradients) and :meth:`apply` (the mean of the accumulated gradients,
    clipped, applied).

    The gradients are static buffers (``p.grad``, allocated here), zero
    between steps: a step zeroes them in place after its update, never sets
    them to None. The optimizer goes through :func:`make_capturable`; the
    learning rates are filled with ``base x lr_factor`` before each step.
    Dropout draws from :attr:`generator`, which the caller seeds before each
    step; the compiled steps register it, so a replay draws what an eager
    step from the same seed draws. Each of :attr:`train_step`,
    :attr:`grad_step` and :attr:`apply_step` is a :class:`CompiledStep`; its
    ``fn`` runs the same step eagerly."""

    def __init__(self, module: torch.nn.Module, optimizer: torch.optim.Optimizer, *,
                 clip_gradient_norm: Optional[float] = None, amp: bool = False):
        self.module = module
        self.optimizer = optimizer
        self.device = next(module.parameters()).device
        self._clip = clip_gradient_norm
        self._amp = amp
        self._base_lrs = make_capturable(optimizer, self.device)
        params = [p for p in module.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._grads = [p.grad for p in params]
        self._divisor = torch.ones((), device=self.device)
        self.generator = torch.Generator(device=self.device)
        compile_kw = dict(state=self._state, generators=[self.generator])
        self.train_step = CompiledStep(self._train, self.device, **compile_kw)
        self.grad_step = CompiledStep(self._forward_backward, self.device, **compile_kw)
        self.apply_step = CompiledStep(self._apply, self.device, **compile_kw)

    def _state(self) -> List[torch.Tensor]:
        """Every tensor a step writes in place."""
        tensors = [*self.module.parameters(), *self.module.buffers(), *self._grads, self._divisor]
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                tensors.append(group["lr"])
        for state in self.optimizer.state.values():
            tensors.extend(v for v in state.values() if isinstance(v, torch.Tensor))
        return tensors

    def _forward_backward(self, minibatch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        loss, metrics = module_loss(self.module, minibatch, train=True, generator=self.generator, amp=self._amp)
        loss.backward()
        return loss.detach(), metrics

    def _update(self) -> None:
        if self._clip is not None:
            clip_by_global_norm_(self._grads, self._clip)
        self.optimizer.step()
        torch._foreach_zero_(self._grads)

    def _train(self, minibatch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        loss, metrics = self._forward_backward(minibatch)
        self._update()
        return loss, metrics

    @torch.no_grad()
    def _apply(self) -> None:
        torch._foreach_div_(self._grads, self._divisor)
        self._update()

    def set_lr(self, lr_factor: float) -> None:
        """Every group's learning rate to its base times ``lr_factor``."""
        for group, base in zip(self.optimizer.param_groups, self._base_lrs):
            set_learning_rate(group, base * lr_factor)

    def step(self, minibatch: Dict[str, Any], lr_factor: float = 1.0) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One step on a device-resident minibatch; returns (loss, metrics),
        device tensors that the next step overwrites. Nothing waits for the
        device."""
        self.set_lr(lr_factor)
        return self.train_step(minibatch)

    def accumulate(self, minibatch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Forward and backward of one microbatch, its gradients added to the
        accumulated ones; returns (loss, metrics) as :meth:`step` does."""
        return self.grad_step(minibatch)

    def apply(self, count: int, lr_factor: float = 1.0) -> None:
        """Apply the mean of the ``count`` microbatches' gradients."""
        self.set_lr(lr_factor)
        self._divisor.fill_(count)
        self.apply_step()

    @torch.no_grad()
    def zero_grad(self) -> None:
        """Drop the accumulated gradients (after a skipped microbatch)."""
        torch._foreach_zero_(self._grads)

    def clear(self) -> None:
        """Free the compiled steps' graphs and pools."""
        for compiled in (self.train_step, self.grad_step, self.apply_step):
            compiled.clear()


def shuffle_seed(seed: int, epoch: int, node: int = 0) -> int:
    """The seed of one epoch's shuffle; a data-parallel node folds its index
    in (node 0 keeps the single-device order)."""
    return seed * 1_000_003 + epoch + node * 0x9E3779B97F4A7C15


def step_seed(seed: int, epoch: int, step: int, rank: int = 0) -> int:
    """The dropout generator's seed of one step; a data-parallel rank folds
    its index in (rank 0 keeps the single-device seed)."""
    seed = ((seed * 1_000_003 + epoch) * 1_000_003 + step) % (1 << 63)
    return (seed + rank * 0x9E3779B97F4A7C15) % (1 << 63)


def prefetch_to_device(
    items: Iterable[Tuple[Any, ...]], device: torch.device, size: int, *, catch_oom: bool = False,
) -> Iterator[Tuple[Any, ...]]:
    """Yield the ``(minibatch, *rest)`` tuples of ``items`` in order with the
    minibatch moved to ``device``, keeping ``size`` of them in flight: the
    counterpart of the JAX trainer's ``_prefetch_device_batches``.

    At ``size`` 1 each minibatch is copied when it is asked for, on the
    current stream. From 2 on a CUDA device the copies run on a side stream
    from page-locked host memory, so the next minibatches' copies overlap
    the running step; the consumer's stream waits on a copy's event before
    it is handed over, and its tensors are recorded on that stream for the
    allocator. On the CPU the minibatches pass through in order. A ``None``
    minibatch stays ``None``. ``catch_oom``: a device OOM raised by a copy
    skips that minibatch (the copies run outside the step's own guard)."""
    if size < 1:
        raise ValueError("prefetch_to_device must be >= 1")
    side = torch.cuda.Stream(device) if size > 1 and device.type == "cuda" else None

    def copy(minibatch):
        if side is None:
            return tree_to(minibatch, device), None
        with torch.cuda.stream(side):
            moved = tree_to(minibatch, device, pin_memory=True)
            copied = torch.cuda.Event()
            copied.record(side)
        return moved, copied

    def hand_over(moved, copied):
        if copied is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(copied)
            for tensor in tree_tensors(moved):
                tensor.record_stream(stream)
        return moved

    in_flight: deque = deque()
    for item in items:
        skipped = False
        try:
            moved, copied = copy(item[0])
        except RuntimeError as error:
            if not (catch_oom and is_oom_error(error)):
                raise
            LOGGER.exception("A device OOM error was caught while copying a minibatch to the device; skipping it.")
            skipped = True
        if skipped:  # outside the handler, whose traceback holds the copies
            release_cached_memory()
            continue
        in_flight.append((moved, copied, item[1:]))
        if len(in_flight) >= size:
            moved, copied, rest = in_flight.popleft()
            yield (hand_over(moved, copied), *rest)
    while in_flight:
        moved, copied, rest = in_flight.popleft()
        yield (hand_over(moved, copied), *rest)


def _tqdm():
    """``tqdm.tqdm``, or None where ``tqdm`` is not installed (it is
    imported only when a bar is asked for)."""
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm


def with_progress_bar(items: Iterable, enabled: bool, desc: str, unit: str) -> Iterable:
    """``items`` counted by a ``tqdm`` bar when ``enabled`` and ``tqdm`` is
    installed; else ``items`` as they are."""
    bar = _tqdm() if enabled else None
    return items if bar is None else bar(items, desc=desc, unit=unit, leave=False)


class EpochProgress:
    """A training epoch's progress bar: minibatches, and the loss as an
    exponential moving average (0.97). A no-op unless ``enabled`` and
    ``tqdm`` is installed."""

    def __init__(self, enabled: bool, epoch: int):
        bar = _tqdm() if enabled else None
        self._bar = None if bar is None else bar(desc=f"epoch {epoch + 1}", unit="mb", leave=False)
        self._ema: Optional[float] = None

    def update(self, loss: float) -> None:
        if self._bar is not None:
            self._ema = loss if self._ema is None else 0.97 * self._ema + 0.03 * loss
            self._bar.update(1)
            self._bar.set_postfix(loss=f"{self._ema:.3f}")

    def close(self) -> None:
        if self._bar is not None:
            self._bar.close()


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
        prefetch_to_device: int = 2,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        if gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")
        if prefetch_to_device < 1:
            raise ValueError("prefetch_to_device must be >= 1")
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
        self._prefetch_to_device = prefetch_to_device
        self._seed = seed
        self._device = resolve_device(device)

        self._accumulated = 0  # microbatches whose gradients sit in .grad
        self._opt_steps_this_epoch = 0  # the schedule's step index
        self._last_lr_factor = 1.0
        self._step: Optional[TrainStep] = None  # the compiled train step of the current optimizer
        self._compiled_eval: Optional[Tuple[torch.nn.Module, CompiledStep]] = None
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
    def load_metadata_and_create_network(self, training_data: Iterable, parallelize: bool = True,
                                         show_progress_bar: bool = False) -> None:
        """The metadata pass over ``training_data`` (skipped when the model
        has its metadata already; ``show_progress_bar`` counts its samples),
        then the module, built from ``seed`` on the trainer's device, and
        the first checkpoint."""
        if not self._model.metadata_initialized:
            self._model.compute_metadata(with_progress_bar(iter(training_data), show_progress_bar, "metadata",
                                                           "sample"), parallelize)
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
        return optimizer, make_capturable(optimizer, self._device)

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def _train_step_for(self, optimizer: torch.optim.Optimizer) -> TrainStep:
        """The compiled train step of the current module and ``optimizer``."""
        step = self._step
        if step is None or step.optimizer is not optimizer or step.module is not self.neural_module:
            step = self._step = TrainStep(self.neural_module, optimizer, clip_gradient_norm=self._clip_gradient_norm,
                                          amp=self._enable_amp)
        return step

    def _eval_step(self, minibatch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The compiled validation step: (loss, metrics) without dropout."""
        module = self.neural_module
        if self._compiled_eval is None or self._compiled_eval[0] is not module:
            fn = functools.partial(module_loss, module, train=False, amp=self._enable_amp)
            self._compiled_eval = (module, CompiledStep(fn, self._device))
        return self._compiled_eval[1](minibatch)

    def _apply_accumulated(self, lr_factor: float) -> None:
        self._step.apply(self._accumulated, lr_factor)
        self._accumulated = 0
        self._opt_steps_this_epoch += 1

    def _device_minibatches(self, items: Iterable[Tuple[Any, ...]]) -> Iterator[Tuple[Any, ...]]:
        """The training pass's ``(minibatch, *rest)`` items with each
        minibatch on the device, ``prefetch_to_device`` ahead."""
        return prefetch_to_device(items, self._device, self._prefetch_to_device,
                                  catch_oom=self._catch_device_ooms)

    def _train_step(self, minibatch, generator, lr_factor: float):
        """One compiled step on a device-resident microbatch, its dropout
        drawn from ``generator`` (the step's, seeded by the caller); under
        accumulation every k-th applies the mean gradient of the last k.
        Returns (host loss, metrics)."""
        if self._grad_accum_steps == 1:
            loss, metrics = self._step.step(minibatch, lr_factor)
            loss_f = float(loss)  # waits for the step, so a device OOM raises here
            self._opt_steps_this_epoch += 1
            return loss_f, metrics
        loss, metrics = self._step.accumulate(minibatch)
        loss_f = float(loss)
        self._accumulated += 1
        self._last_lr_factor = lr_factor
        if self._accumulated >= self._grad_accum_steps:
            self._apply_accumulated(lr_factor)
        return loss_f, metrics

    # ------------------------------------------------------------------
    # Epoch loops
    # ------------------------------------------------------------------
    def _run_training(self, training_tensors, epoch, optimizer, base_lrs, scheduler, parallelize,
                      shuffle_input=True, show_progress_bar=False) -> None:
        sum_epoch_loss, num_minibatches, num_samples = 0.0, 0, 0
        metrics_acc = MetricsAccumulator()
        start_time = time.time()
        self._opt_steps_this_epoch = 0
        progress = EpochProgress(show_progress_bar, epoch)
        step = self._train_step_for(optimizer)
        generator = step.generator
        mb_iter = self._model.minibatch_iterator(
            training_tensors(),
            max_minibatch_size=self._minibatch_size,
            yield_partial_minibatches=False,
            shuffle_input=shuffle_input,
            parallelize=parallelize,
            # data order is part of the training seed: same seed -> same run
            shuffle_rng=random.Random(shuffle_seed(self._seed, epoch)),
        )
        for step_idx, (mb_data, raw_samples) in enumerate(self._device_minibatches(mb_iter)):
            # Schedules count optimizer steps: under gradient accumulation k
            # microbatches share one index.
            lr_factor = 1.0 if scheduler is None else scheduler.step(
                epoch, self._opt_steps_this_epoch if self._grad_accum_steps > 1 else step_idx
            )
            generator.manual_seed(step_seed(self._seed, epoch, step_idx))
            try:
                loss_f, metrics = self._train_step(mb_data, generator, lr_factor)
            except RuntimeError as error:
                if not (self._catch_device_ooms and is_oom_error(error)):
                    raise
                # Skip the minibatch, and the partial accumulation group
                # whose gradients it may have touched.
                self.LOGGER.exception("A device OOM error was caught; skipping minibatch.")
                step.zero_grad()
                self._accumulated = 0
                loss_f = None
            if loss_f is None:  # outside the handler, whose traceback holds the step's tensors
                del mb_data
                release_cached_memory()
                continue
            if not math.isfinite(loss_f):
                raise RuntimeError("Loss has a NaN value.")
            sum_epoch_loss += loss_f
            num_minibatches += 1
            num_samples += len(raw_samples)
            metrics_acc.update(metrics)
            progress.update(loss_f)
        progress.close()
        if self._accumulated:  # a trailing partial accumulation group
            self._apply_accumulated(self._last_lr_factor)
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
            loss, metrics = self._eval_step(tree_to(mb_data, self._device))
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
        use_multiprocessing: bool = True,
        store_tensorized_data_in_memory: bool = False,
        shuffle_training_data: bool = True,
        start_epoch_idx: int = 0,
        show_progress_bar: bool = False,
    ) -> None:
        """Train up to ``max_num_epochs`` with validation after each (and
        before the first, with ``validate_on_start``), early stopping after
        ``patience`` epochs without improvement, and the best checkpoint
        restored at the end. ``parallelize`` pipelines the host work in
        worker threads; with ``use_multiprocessing`` too (the default), a
        forked child tensorizes each pass
        (:meth:`AbstractNeuralModel.tensorize_dataset`).
        ``show_progress_bar`` shows each training epoch's minibatches and
        loss (with ``tqdm``, where it is installed)."""
        if initialize_metadata:
            self.load_metadata_and_create_network(training_data, parallelize, show_progress_bar)

        def training_tensors():
            return self._model.tensorize_dataset(iter(training_data), parallelize=parallelize,
                                                 use_multiprocessing=use_multiprocessing)

        def validation_tensors():
            return self._model.tensorize_dataset(iter(validation_data), parallelize=parallelize,
                                                 use_multiprocessing=use_multiprocessing)

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
                training_tensors, epoch, optimizer, base_lrs, scheduler, parallelize, shuffle_training_data,
                show_progress_bar,
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
