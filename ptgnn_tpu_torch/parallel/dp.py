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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ptgnn_tpu_torch.core.trainer import module_loss, optimizer_step

__all__ = ["DataParallel", "LOCAL", "zero1_optimizer", "moment_elements"]

# ``DataParallel(data_group=LOCAL)``: this rank's minibatch is the only one
# (no data axis), so nothing is reduced over data groups.
LOCAL = "local"


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


def _ratio(weight: float, total: torch.Tensor) -> torch.Tensor:
    """weight / max(total, 1e-9) as a true division (a Python number over a
    tensor multiplies by the reciprocal, which can miss 1 for w / w)."""
    return torch.full_like(total, float(weight)) / total.clamp_min(1e-9)


def _counting_allreduce_hook(dp, bucket):
    """DDP's default all-reduce of one gradient bucket (divide by the world,
    sum), counted. No annotations: DDP checks them, and this module's are
    strings."""
    buffer = bucket.buffer()
    dp._count(buffer)
    buffer.div_(dist.get_world_size())
    return dist.all_reduce(buffer, async_op=True).get_future().then(lambda fut: fut.value()[0])


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
    ``allreduce_calls`` and ``allreduce_bytes`` count the collectives."""

    def __init__(self, module: torch.nn.Module, *, enable_amp: bool = False, data_group: Any = None):
        self.module = module
        self.enable_amp = enable_amp
        # the ranks whose minibatches differ: the world, a subgroup, or LOCAL
        self.data_group = data_group
        self.data_world = 1 if data_group == LOCAL else dist.get_world_size(data_group)
        self._ddp = DistributedDataParallel(module)
        self._ddp.register_comm_hook(self, _counting_allreduce_hook)
        self._weight_acc: Optional[torch.Tensor] = None  # the weight total of the steps held in .grad
        self.allreduce_calls = 0
        self.allreduce_bytes = 0

    def _count(self, flat: torch.Tensor) -> None:
        self.allreduce_calls += 1
        self.allreduce_bytes += flat.numel() * flat.element_size()

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

    def _weight_total(self, weight: float, device: torch.device) -> torch.Tensor:
        """sum_r w_r: one all-reduce of one float."""
        return self._all_reduce(torch.tensor([float(weight)], device=device))[0]

    def grad_step(self, minibatch: Dict[str, Any], weight: float,
                  generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, Dict[str, Any], torch.Tensor]:
        """Forward and backward of this rank's device-resident minibatch
        through DDP. Returns the weighted mean loss over ranks, the metrics
        summed over ranks and the raw weight total (device tensors; nothing
        waits for the device)."""
        total = self._weight_total(weight, next(self.module.parameters()).device)
        held = self._weight_acc
        acc = total if held is None else held + total
        if held is None:
            self.module.zero_grad(set_to_none=True)
        else:  # the running mean so far, reweighted to the new total
            for p in self.module.parameters():
                if p.grad is not None:
                    p.grad.mul_(held / acc.clamp_min(1e-9))
        self._weight_acc = acc
        loss, metrics = module_loss(self._ddp, minibatch, train=True, generator=generator, amp=self.enable_amp)
        (loss * _ratio(float(weight) * self.data_world, acc)).backward()
        mean_loss, summed = self._reduce(loss, _ratio(weight, total), metrics)
        return mean_loss, summed, total

    def apply_gradients(self, optimizer: torch.optim.Optimizer, base_lrs: Sequence[float], *,
                        clip_gradient_norm: Optional[float] = None, lr_factor: float = 1.0) -> None:
        """One optimizer step on the accumulated weighted mean gradient
        (clipped on the full gradient first), then clear it."""
        if self._weight_acc is None:
            raise RuntimeError("no accumulated gradient to apply")
        self._weight_acc = None
        optimizer_step(self.module, optimizer, base_lrs, clip_gradient_norm=clip_gradient_norm, lr_factor=lr_factor)

    def train_step(self, minibatch: Dict[str, Any], weight: float, generator: Optional[torch.Generator],
                   optimizer: torch.optim.Optimizer, base_lrs: Sequence[float], *,
                   clip_gradient_norm: Optional[float] = None, lr_factor: float = 1.0):
        """:meth:`grad_step` then :meth:`apply_gradients`: JAX's
        ``build_train_step``. Returns (mean loss, summed metrics)."""
        loss, metrics, _ = self.grad_step(minibatch, weight, generator)
        self.apply_gradients(optimizer, base_lrs, clip_gradient_norm=clip_gradient_norm, lr_factor=lr_factor)
        return loss, metrics

    @torch.no_grad()
    def eval_step(self, minibatch: Dict[str, Any], weight: float) -> Tuple[torch.Tensor, Dict[str, Any], torch.Tensor]:
        """(weighted mean loss, metrics summed over ranks, raw weight total)
        of this rank's minibatch, without dropout."""
        loss, metrics = module_loss(self.module, minibatch, train=False, amp=self.enable_amp)
        total = self._weight_total(weight, loss.device)
        mean_loss, summed = self._reduce(loss, _ratio(weight, total), metrics)
        return mean_loss, summed, total
