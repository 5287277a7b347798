"""Ready-made learning-rate schedules for the trainer's AbstractScheduler
protocol (the counterpart of the JAX package's ``core/schedulers.py``).

Every schedule returns a multiplicative FACTOR on the optimizer's base
update, queried once per optimizer step as ``step(epoch_idx, epoch_step)``.
The trainer scales each parameter group's learning rate by the factor,
which scales Adam's update by the same factor.

Schedules that need a global step count take ``steps_per_epoch`` so
``(epoch_idx, epoch_step)`` can be linearized.
"""
from __future__ import annotations

import math


class ConstantScheduler:
    """factor = value, always (explicit no-op)."""

    def __init__(self, value: float = 1.0):
        self.value = float(value)

    def step(self, epoch_idx: int, epoch_step: int) -> float:
        return self.value


class LinearWarmupScheduler:
    """Ramp 0 -> 1 over ``warmup_steps`` optimizer steps, then 1."""

    def __init__(self, warmup_steps: int, steps_per_epoch: int):
        if warmup_steps < 1 or steps_per_epoch < 1:
            raise ValueError("warmup_steps and steps_per_epoch must be >= 1")
        self.warmup_steps = warmup_steps
        self.steps_per_epoch = steps_per_epoch

    def step(self, epoch_idx: int, epoch_step: int) -> float:
        t = epoch_idx * self.steps_per_epoch + epoch_step
        return min(1.0, (t + 1) / self.warmup_steps)


class WarmupCosineScheduler:
    """Linear warmup then cosine decay to ``final_factor`` at
    ``total_steps`` (the transformer-training default shape)."""

    def __init__(
        self,
        warmup_steps: int,
        total_steps: int,
        steps_per_epoch: int,
        final_factor: float = 0.0,
    ):
        if not 0 < warmup_steps < total_steps:
            raise ValueError("need 0 < warmup_steps < total_steps")
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.steps_per_epoch = steps_per_epoch
        self.final_factor = float(final_factor)

    def step(self, epoch_idx: int, epoch_step: int) -> float:
        t = epoch_idx * self.steps_per_epoch + epoch_step
        if t < self.warmup_steps:
            return (t + 1) / self.warmup_steps
        frac = min(1.0, (t - self.warmup_steps) / (self.total_steps - self.warmup_steps))
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return self.final_factor + (1.0 - self.final_factor) * cos


class StepDecayScheduler:
    """Multiply the factor by ``gamma`` every ``epochs_per_decay`` epochs
    (torch ``StepLR`` shape, per-epoch granularity)."""

    def __init__(self, gamma: float = 0.1, epochs_per_decay: int = 30):
        if not (0 < gamma <= 1 and epochs_per_decay >= 1):
            raise ValueError("need 0 < gamma <= 1 and epochs_per_decay >= 1")
        self.gamma = float(gamma)
        self.epochs_per_decay = epochs_per_decay

    def step(self, epoch_idx: int, epoch_step: int) -> float:
        return self.gamma ** (epoch_idx // self.epochs_per_decay)
