"""Weight initialisers with torch.nn.init semantics, drawn from an explicit
``torch.Generator``.

Each initialiser is a small picklable callable ``init(tensor, generator)``
that fills ``tensor`` in place. Shapes are torch layouts (Linear weight
``[out, in]``), as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def _fan_in_out(shape: Sequence[int]) -> Tuple[int, int]:
    if len(shape) < 2:
        raise ValueError("fan in/out undefined for <2D shapes")
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, tensor: torch.Tensor, generator: Optional[torch.Generator]) -> None:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({vars(self)})"


class zeros(Initializer):
    def __call__(self, tensor, generator):
        tensor.zero_()


class uniform(Initializer):
    """torch.nn.init.uniform_(a=low, b=high)."""

    def __init__(self, low: float = 0.0, high: float = 1.0):
        self.low = low
        self.high = high

    def __call__(self, tensor, generator):
        tensor.uniform_(self.low, self.high, generator=generator)


class normal(Initializer):
    """torch.nn.init.normal_."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean = mean
        self.std = std

    def __call__(self, tensor, generator):
        tensor.normal_(self.mean, self.std, generator=generator)


class xavier_uniform(Initializer):
    """torch.nn.init.xavier_uniform_: U(-a, a), a = gain*sqrt(6/(fan_in+fan_out))."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, tensor, generator):
        fan_in, fan_out = _fan_in_out(tensor.shape)
        a = self.gain * math.sqrt(6.0 / (fan_in + fan_out))
        tensor.uniform_(-a, a, generator=generator)


class xavier_normal(Initializer):
    """torch.nn.init.xavier_normal_: N(0, std), std = gain*sqrt(2/(fan_in+fan_out))."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, tensor, generator):
        fan_in, fan_out = _fan_in_out(tensor.shape)
        tensor.normal_(0.0, self.gain * math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)


class orthogonal(Initializer):
    """torch.nn.init.orthogonal_: the Q of a gaussian's QR, sign-corrected so
    the draw is uniform over the orthogonal matrices."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, tensor, generator):
        if tensor.ndim < 2:
            raise ValueError("orthogonal requires a >=2D shape")
        rows = tensor.shape[0]
        cols = tensor.numel() // rows
        flat = torch.empty(max(rows, cols), min(rows, cols), dtype=torch.float32)
        flat.normal_(0.0, 1.0, generator=generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if rows < cols:
            q = q.T
        tensor.copy_((self.gain * q).reshape(tensor.shape))


class kaiming_uniform(Initializer):
    """torch.nn.init.kaiming_uniform_ with the leaky_relu gain (torch's
    Linear and Conv1d default): U(-b, b), b = gain * sqrt(3 / fan_in)."""

    def __init__(self, a: float = math.sqrt(5.0)):
        self.a = a

    def __call__(self, tensor, generator):
        fan_in, _ = _fan_in_out(tensor.shape)
        bound = math.sqrt(2.0 / (1.0 + self.a * self.a)) * math.sqrt(3.0 / fan_in)
        tensor.uniform_(-bound, bound, generator=generator)


def torch_linear_bias(fan_in: int) -> uniform:
    """torch.nn.Linear default bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return uniform(-bound, bound)
