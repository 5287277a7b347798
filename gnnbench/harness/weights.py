"""The benchmark's weights: made on the device from the run's seed, in one
draw, by the names and shapes of the program's parameters, and loaded into
the program's module; the reference reads the same tensors by name.

Each leaf is uniform: a matrix or a stack of them within the Glorot bound
of its fan-in and fan-out ([out, in] for a linear layer or an embedding
table, [types, in, out] for a typed weight stack), a LayerNorm scale in
1 +- 0.1, any other vector (a bias, a LayerNorm shift) in +- 0.1.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .pool import SALT_WEIGHTS, sub_seed


def _scaled(name: str, u: torch.Tensor) -> torch.Tensor:
    if u.dim() == 1:
        return 1.0 + 0.1 * u if name.endswith("norm.weight") else 0.1 * u
    if u.dim() == 2:
        fan_out, fan_in = u.shape
    else:
        fan_in, fan_out = u.shape[-2], u.shape[-1]
    return u * math.sqrt(6.0 / (fan_in + fan_out))


def make(module: torch.nn.Module, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every parameter of ``module``."""
    shapes = [(n, tuple(p.shape)) for n, p in module.named_parameters()]
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, SALT_WEIGHTS))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, offset = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        out[name] = _scaled(name, flat[offset:offset + n].view(shape))
        offset += n
    return out


@torch.no_grad()
def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    for name, p in module.named_parameters():
        p.copy_(weights[name])
