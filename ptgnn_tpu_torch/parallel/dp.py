"""Data parallelism over ``torch.distributed``: one process per GPU, NCCL on
the card, gloo on the CPU.

The counterpart of the JAX package's ``parallel/dp.py``. There, one
controller drives every device of a ``data`` mesh: ``stack_minibatches``
stacks a minibatch per device along a leading axis and one ``shard_map``
step runs them all. Here each process runs its own minibatch on its own
card, so nothing is stacked and ``stack_minibatches`` has no counterpart;
the distributed trainer hands each process its slot of every group.

The step is JAX's weighted one. Rank r's gradient g_r and loss are weighted
by w_r, its count of real samples:

    g = sum_r w_r g_r / max(sum_r w_r, 1e-9)

so a padding batch (w_r = 0) dilutes nothing, and metric accumulators are
summed over ranks. A rank with w_r = 0 still runs its forward and backward
and joins every collective, as JAX's padding batches do. The gradients go
through ``DistributedDataParallel``, whose bucketed all-reduce overlaps the
backward and averages over the world. So one all-reduce of the weight comes
first, and each rank scales its loss by w_r x world / sum_r w_r before the
backward. At world size 1 that factor is exactly 1, so the step is the
single-device trainer's bit for bit. The loss and the metrics follow in one
small all-reduce (metric counts are exact below 2**24).

Under edge or node sharding (``parallel/edge_sharding.py``,
``parallel/node_sharding.py``) the ranks of one model group share one
minibatch, and ``data_group`` names the ranks that hold different ones:
one rank of each model group (``LOCAL`` when there is no data axis). The
weights, the loss and the metrics are reduced over it, and each rank's
loss is scaled by w x data_world / sum w. DDP still sums over the whole
world and divides by its size: that sums each model group's partial
gradients, whose collectives carry the group size as a factor
(``parallel/collectives.py``), and leaves the weighted mean over the data
groups.

ZeRO-1 (:func:`zero1_optimizer`) is ``ZeroRedundancyOptimizer`` over the
trainer's optimizer class: each rank keeps the moments of about 1/world of
the parameters, updates them, and broadcasts them to the others. The
global-norm clip acts on the full all-reduced gradient, which every rank
holds, before the sharded update, as JAX's does.

The steps are compiled (``core/compiled_step.py``), as JAX jits its
``shard_map`` steps: :meth:`DataParallel.train_step`, the accumulation pair
:meth:`~DataParallel.grad_step` / :meth:`~DataParallel.apply_gradients` and
:meth:`~DataParallel.eval_step` are each a CUDA graph per batch signature on
the card, with DDP's bucketed all-reduce, the small all-reduces and ZeRO-1's
broadcasts inside it. What changes from call to call is never a Python
number in a graph: this rank's weight is a device scalar filled before each
call, the weight total of an accumulation window a device buffer, and the
learning rates device scalars (``core/trainer.make_capturable``, Adam and
AdamW) filled with ``base x lr_factor``. An optimizer whose rate stays a
Python number (plain SGD) keeps its hyperparameters in the signature, as
``jit`` keeps static arguments: another rate is another graph. DDP runs with
``static_graph=True``, is made on a side stream, and has
:data:`DDP_WARMUP_CALLS` eager iterations before a capture, as PyTorch's
CUDA graph notes ask. The comm hook counts in Python, which a replay does
not run, so its counters replay as the kernels' launch counters do: they
count the all-reduces that ran, warm-ups included. On the CPU the steps are
plain calls.
"""
from __future__ import annotations

import itertools
import weakref
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ptgnn_tpu_torch.core.compiled_step import CompiledStep
from ptgnn_tpu_torch.core.trainer import clip_by_global_norm_, make_capturable, module_loss, set_learning_rate
from ptgnn_tpu_torch.utils import tracing

__all__ = ["DataParallel", "DDP_WARMUP_CALLS", "LOCAL", "base_rates", "zero1_optimizer", "moment_elements"]

# ``DataParallel(data_group=LOCAL)``: this rank's minibatch is the only one
# (no data axis), so nothing is reduced over data groups.
LOCAL = "local"

# Eager DDP iterations before a capture of a step that runs DDP's backward:
# its first iteration finds the static graph, its second rebuilds the
# buckets, and PyTorch's CUDA graph notes ask for 11 in all.
DDP_WARMUP_CALLS = 11

# Each DataParallel's key for its counters in the counter table.
_COUNTER_KEYS = itertools.count()


def zero1_optimizer(
    params: Iterable[torch.nn.Parameter],
    optimizer_creator: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer],
    group: Any = None,
) -> torch.optim.Optimizer:
    """``ZeroRedundancyOptimizer`` with the class and hyperparameters of the
    optimizer that ``optimizer_creator`` makes (``torch.optim.Adam`` with
    the trainer's learning rate, say), its moments sharded over ``group``
    (the world when None). The probe optimizer holds no state: Adam
    allocates its moments at the first step."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    params = list(params)
    probe = optimizer_creator(params)
    return ZeroRedundancyOptimizer(params, optimizer_class=type(probe), process_group=group, **probe.defaults)


def moment_elements(optimizer: torch.optim.Optimizer) -> int:
    """Elements of the optimizer state tensors this rank holds (for ZeRO-1,
    its shard's moments)."""
    inner = getattr(optimizer, "optim", optimizer)
    return sum(v.numel() for state in inner.state.values() for v in state.values()
               if isinstance(v, torch.Tensor) and v.dim() > 0)


def base_rates(optimizer: torch.optim.Optimizer) -> List[float]:
    """Each parameter group's base learning rate: ``initial_lr`` where
    ``make_capturable`` (or a scheduler) kept one, else its rate."""
    return [float(g.get("initial_lr", g["lr"])) for g in optimizer.param_groups]


def _ratio(weight, total: torch.Tensor) -> torch.Tensor:
    """weight / max(total, 1e-9) as a true division (a Python number over a
    tensor multiplies by the reciprocal, which can miss 1 for w / w).
    ``weight``: a Python number or a tensor of ``total``'s dtype."""
    if not isinstance(weight, torch.Tensor):
        weight = torch.full_like(total, float(weight))
    return weight / total.clamp_min(1e-9)


def _counting_allreduce_hook(dp, bucket):
    """DDP's default all-reduce of one gradient bucket (divide by the world,
    sum), counted. No annotations: DDP checks them, and this module's are
    strings."""
    buffer = bucket.buffer()
    dp._count(buffer)
    buffer.div_(dist.get_world_size())
    return dist.all_reduce(buffer, async_op=True).get_future().then(lambda fut: fut.value()[0])


def _static_hyperparameters(optimizer: torch.optim.Optimizer) -> Hashable:
    """The hyperparameters of every parameter group that are Python values
    (a device-scalar rate is not among them): a compiled step bakes them,
    so they belong to its signature. ``initial_lr``, the base rate that the
    caller scales, is not read by a step."""
    return tuple(tuple(sorted((k, repr(v)) for k, v in group.items()
                              if k not in ("params", "initial_lr") and not isinstance(v, torch.Tensor)))
                 for group in optimizer.param_groups)


class DataParallel:
    """Weighted data-parallel steps of ``module`` (the trainer's protocol:
    ``module(**minibatch, train=..., generator=...) -> (loss, metrics)``)
    over the default process group. Every rank's module must use all of its
    parameters in every forward (DDP's rule without
    ``find_unused_parameters``).

    :meth:`grad_step` folds one minibatch's weighted mean gradient over all
    ranks into ``.grad``, kept as a running mean weighted by each step's
    weight total; :meth:`apply_gradients` runs one clipped optimizer step on
    it, so k grad steps then one apply equal one step on the weighted mean
    gradient of all k x world minibatches. Every grad step all-reduces, as
    JAX's does, so an accumulation window may end anywhere.
    ``allreduce_calls`` and ``allreduce_bytes`` count the collectives (in
    the counter table, ``utils/tracing.py``, under a key of this object's:
    compiled steps replay them as they replay the kernels' launches).

    The gradients are static buffers (``p.grad``, allocated here), zero
    between windows. Dropout draws from :attr:`generator`; a caller's
    generator is copied into it on the card (its seed and offset), so a
    replay draws what an eager step from the same seed draws. On the card
    the optimizer must be Adam or AdamW (made capturable here at its first
    step) or plain SGD without momentum. Each of :attr:`train_step_compiled`,
    :attr:`grad_step_compiled`, :attr:`apply_step_compiled` and
    :attr:`eval_step_compiled` is a :class:`CompiledStep`; its ``fn`` runs
    the step eagerly."""

    def __init__(self, module: torch.nn.Module, *, enable_amp: bool = False, data_group: Any = None):
        self.module = module
        self.enable_amp = enable_amp
        # the ranks whose minibatches differ: the world, a subgroup, or LOCAL
        self.data_group = data_group
        self.data_world = 1 if data_group == LOCAL else dist.get_world_size(data_group)
        self.device = next(module.parameters()).device
        params = [p for p in module.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._grads = [p.grad for p in params]
        if self.device.type == "cuda":
            # PyTorch's notes: a DDP whose backward is captured is made on a
            # side stream.
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._ddp = DistributedDataParallel(module, static_graph=True)
            torch.cuda.current_stream(self.device).wait_stream(side)
        else:
            self._ddp = DistributedDataParallel(module, static_graph=True)
        # The hook's state is a weak proxy: DDP's C++ reducer keeps its state
        # alive, and a strong reference would tie this object (its graphs,
        # which hold NCCL's persistent work, included) to the reducer in a
        # cycle the collector cannot see. NCCL's group destruction waits
        # for every graph that captured one of its collectives.
        self._ddp.register_comm_hook(weakref.proxy(self), _counting_allreduce_hook)
        self._weight = torch.zeros((), device=self.device)  # this rank's weight, filled before each call
        self._weight_acc = torch.zeros((), device=self.device)  # the weight total of the steps held in .grad
        self._held = 0  # grad steps held in .grad (host bookkeeping)
        self._optimizer: Optional[torch.optim.Optimizer] = None
        self.generator = torch.Generator(device=self.device)
        self._counter_key = next(_COUNTER_KEYS)
        ddp_kw = dict(state=self._state, generators=[self.generator], warmup_calls=DDP_WARMUP_CALLS)
        self.train_step_compiled = CompiledStep(self._train, self.device, **ddp_kw)
        self.grad_step_compiled = CompiledStep(self._grad, self.device, **ddp_kw)
        self.apply_step_compiled = CompiledStep(self._apply, self.device, state=self._state)
        self.eval_step_compiled = CompiledStep(self._eval, self.device)

    # ------------------------------------------------------------------
    @property
    def allreduce_calls(self) -> int:
        return tracing.tally("allreduce_calls").get(self._counter_key, 0)

    @property
    def allreduce_bytes(self) -> int:
        return tracing.tally("allreduce_bytes").get(self._counter_key, 0)

    def _count(self, flat: torch.Tensor) -> None:
        tracing.count("allreduce_calls", self._counter_key)
        tracing.count("allreduce_bytes", self._counter_key, flat.numel() * flat.element_size())

    def _all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum over the data group (a no-op for LOCAL)."""
        if self.data_group != LOCAL:
            dist.all_reduce(flat, group=self.data_group)
            self._count(flat)
        return flat

    def _reduce(self, loss: torch.Tensor, share: torch.Tensor, metrics: Dict[str, Any]):
        """All-reduce [share x loss, metrics] in one float32 buffer. Returns
        (weighted mean loss, summed metrics)."""
        keys = sorted(metrics)
        flat = self._all_reduce(torch.stack([loss.detach().float() * share]
                                            + [torch.as_tensor(metrics[k], device=loss.device).float() for k in keys]))
        return flat[0], {k: flat[1 + i] for i, k in enumerate(keys)}

    def _weight_total(self) -> torch.Tensor:
        """sum_r w_r: one all-reduce of one float."""
        return self._all_reduce(self._weight.reshape(1).clone())[0]

    def _state(self) -> List[torch.Tensor]:
        """Every tensor a step writes in place."""
        tensors = [*self.module.parameters(), *self.module.buffers(), *self._grads, self._weight_acc]
        if self._optimizer is not None:
            for group in self._optimizer.param_groups:
                if isinstance(group["lr"], torch.Tensor):
                    tensors.append(group["lr"])
            inner = getattr(self._optimizer, "optim", self._optimizer)  # ZeRO-1's local optimizer
            for state in inner.state.values():
                tensors.extend(v for v in state.values() if isinstance(v, torch.Tensor))
        return tensors

    def _use_generator(self, generator: Optional[torch.Generator]) -> None:
        if generator is not None and generator is not self.generator:
            self.generator.set_state(generator.get_state())

    def _bind(self, optimizer: torch.optim.Optimizer) -> None:
        """Take ``optimizer`` for the apply steps; on the card, make it
        capturable (once), or refuse one that a graph cannot replay."""
        if optimizer is self._optimizer:
            return
        if self.device.type == "cuda":
            prepared = all(isinstance(g["lr"], torch.Tensor) and g.get("capturable") for g in optimizer.param_groups)
            local = getattr(optimizer, "optim", optimizer)
            if type(local) is torch.optim.SGD:
                if any(g["momentum"] for g in optimizer.param_groups):
                    raise TypeError("SGD with momentum cannot run in a compiled (CUDA graph) data-parallel step: "
                                    "its first step differs from the later ones")
            elif not prepared:
                make_capturable(optimizer, self.device)
        self._optimizer = optimizer
        for compiled in (self.train_step_compiled, self.apply_step_compiled):
            if isinstance(compiled, CompiledStep):
                compiled.clear()  # they captured the previous optimizer

    # ------------------------------------------------------------------
    # The step functions (what the compiled steps capture)
    # ------------------------------------------------------------------
    def _grad(self, minibatch: Dict[str, Any], first: bool) -> Tuple[torch.Tensor, Dict[str, Any], torch.Tensor]:
        total = self._weight_total()
        if first:
            acc = total
        else:  # the running mean so far, reweighted to the new total
            acc = self._weight_acc + total
            torch._foreach_mul_(self._grads, self._weight_acc / acc.clamp_min(1e-9))
        self._weight_acc.copy_(acc)
        loss, metrics = module_loss(self._ddp, minibatch, train=True, generator=self.generator, amp=self.enable_amp)
        (loss * _ratio(self._weight * self.data_world, acc)).backward()
        mean_loss, summed = self._reduce(loss, _ratio(self._weight, total), metrics)
        return mean_loss, summed, total

    @torch.no_grad()
    def _apply(self, clip_gradient_norm: Optional[float], hyperparameters: Hashable) -> None:
        if clip_gradient_norm is not None:
            clip_by_global_norm_(self._grads, clip_gradient_norm)
        self._optimizer.step()
        torch._foreach_zero_(self._grads)

    def _train(self, minibatch: Dict[str, Any], clip_gradient_norm: Optional[float],
               hyperparameters: Hashable) -> Tuple[torch.Tensor, Dict[str, Any]]:
        loss, metrics, _ = self._grad(minibatch, True)
        self._apply(clip_gradient_norm, hyperparameters)
        return loss, metrics

    @torch.no_grad()
    def _eval(self, minibatch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any], torch.Tensor]:
        loss, metrics = module_loss(self.module, minibatch, train=False, amp=self.enable_amp)
        total = self._weight_total()
        mean_loss, summed = self._reduce(loss, _ratio(self._weight, total), metrics)
        return mean_loss, summed, total

    # ------------------------------------------------------------------
    # The steps
    # ------------------------------------------------------------------
    def _set_lr(self, optimizer: torch.optim.Optimizer, base_lrs: Sequence[float], lr_factor: float) -> None:
        for group, base in zip(optimizer.param_groups, base_lrs):
            set_learning_rate(group, base * lr_factor)

    def grad_step(self, minibatch: Dict[str, Any], weight: float,
                  generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, Any], torch.Tensor]:
        """Forward and backward of this rank's device-resident minibatch
        through DDP, dropout drawn from ``generator``'s state (else from
        :attr:`generator`). Returns the weighted mean loss over ranks, the
        metrics summed over ranks and the raw weight total (device tensors
        that the next step overwrites; nothing waits for the device)."""
        self._use_generator(generator)
        self._weight.fill_(float(weight))
        out = self.grad_step_compiled(minibatch, self._held == 0)
        self._held += 1
        return out

    def apply_gradients(self, optimizer: torch.optim.Optimizer, base_lrs: Sequence[float], *,
                        clip_gradient_norm: Optional[float] = None, lr_factor: float = 1.0) -> None:
        """One optimizer step on the accumulated weighted mean gradient
        (clipped on the full gradient first), then clear it."""
        if not self._held:
            raise RuntimeError("no accumulated gradient to apply")
        self._bind(optimizer)
        self._set_lr(optimizer, base_lrs, lr_factor)
        self.apply_step_compiled(clip_gradient_norm, _static_hyperparameters(optimizer))
        self._held = 0

    def train_step(self, minibatch: Dict[str, Any], weight: float, generator: Optional[torch.Generator],
                   optimizer: torch.optim.Optimizer, base_lrs: Sequence[float], *,
                   clip_gradient_norm: Optional[float] = None, lr_factor: float = 1.0):
        """:meth:`grad_step` then :meth:`apply_gradients` as one compiled
        step: JAX's ``build_train_step``. Returns (mean loss, summed
        metrics)."""
        if self._held:
            raise RuntimeError("a train step with gradients held: apply them first")
        self._bind(optimizer)
        self._use_generator(generator)
        self._weight.fill_(float(weight))
        self._set_lr(optimizer, base_lrs, lr_factor)
        return self.train_step_compiled(minibatch, clip_gradient_norm, _static_hyperparameters(optimizer))

    def eval_step(self, minibatch: Dict[str, Any], weight: float) -> Tuple[torch.Tensor, Dict[str, Any], torch.Tensor]:
        """(weighted mean loss, metrics summed over ranks, raw weight total)
        of this rank's minibatch, without dropout."""
        self._weight.fill_(float(weight))
        with torch.no_grad():
            return self.eval_step_compiled(minibatch)

    @torch.no_grad()
    def zero_grad(self) -> None:
        """Drop the accumulated gradients."""
        torch._foreach_zero_(self._grads)
        self._held = 0

    def clear(self) -> None:
        """Free the compiled steps' graphs and pools."""
        for compiled in (self.train_step_compiled, self.grad_step_compiled, self.apply_step_compiled,
                         self.eval_step_compiled):
            if isinstance(compiled, CompiledStep):
                compiled.clear()
