"""The neural primitives the ported paths use.

Weights keep the torch layouts of the JAX package (Linear weight
``[out, in]``), so parameters convert one to one (see ``convert.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ptgnn_tpu_torch.nn import initializers as init


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as the JAX package's ``gelu_exact``."""
    return F.gelu(x, approximate="none")


def dropout(x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    """Inverted dropout; identity when not training or ``rate == 0``."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty_like(x).bernoulli_(keep).bool()
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Linear(torch.nn.Module):
    """y = x @ W.T + b with W ``[out, in]``; computes in the input's dtype."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        weight_init: init.Initializer,
        use_bias: bool = True,
        bias_init: Optional[init.Initializer] = None,
    ):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self._weight_init = weight_init
        self._bias_init = bias_init or init.torch_linear_bias(in_features)
        self.weight = torch.nn.Parameter(torch.empty(out_features, in_features))
        self.bias = torch.nn.Parameter(torch.empty(out_features)) if use_bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self._weight_init(self.weight.data, generator)
        if self.bias is not None:
            self._bias_init(self.bias.data, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        return F.linear(x, self.weight.to(x.dtype), bias)


class Embedding(torch.nn.Module):
    """Token embedding table ``[V, D]``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *, weight_init: init.Initializer):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self._weight_init = weight_init
        self.weight = torch.nn.Parameter(torch.empty(num_embeddings, embedding_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self._weight_init(self.weight.data, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight)


class LayerNorm(torch.nn.Module):
    """LayerNorm over the last dim (eps 1e-5, affine), computed in float32
    with the JAX package's formula and cast back."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(dim))
        self.bias = torch.nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        normed = (xf - mean) * torch.rsqrt(var + self.eps)
        return (normed * self.weight + self.bias).to(x.dtype)
