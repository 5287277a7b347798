"""The neural primitives the ported paths use.

Weights keep the torch layouts of the JAX package (Linear weight
``[out, in]``), so parameters convert one to one (see ``convert.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ptgnn_tpu_torch.nn import initializers as init


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as the JAX package's ``gelu_exact``."""
    return F.gelu(x, approximate="none")


def dropout(
    x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Inverted dropout; identity when not training or ``rate == 0``. The mask
    comes from ``generator`` (on ``x``'s device), never from PyTorch's global
    generator, so a seeded caller gets the same masks on every run."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout during training needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
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


class _EmbeddingLookup(torch.autograd.Function):
    """``F.embedding`` whose backward sums each id's rows in a fixed order, so
    the table's gradient is the same bits on every run; PyTorch's CUDA
    embedding backward adds float32 rows in atomic order.

    The rows are sorted stably by id and summed in two levels of sequential
    segment sums: chunks of at most ``_CHUNK`` rows of one id, then each id's
    chunks. One level would sum the padding id's tens of thousands of rows in
    one sequential chain. Every shape is fixed by the input sizes, so nothing
    waits for the device."""

    _CHUNK = 128

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.num_embeddings = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        num_ids, chunk = ctx.num_embeddings, _EmbeddingLookup._CHUNK
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        sorted_ids = flat[order]
        rows = g.reshape(-1, g.shape[-1])[order].float()  # bf16 rows summed in float32
        counts = torch.bincount(flat, minlength=num_ids)
        chunks = (counts + chunk - 1) // chunk  # chunks of each id
        rank = torch.arange(flat.numel(), device=flat.device) - (torch.cumsum(counts, 0) - counts)[sorted_ids]
        slot = (torch.cumsum(chunks, 0) - chunks)[sorted_ids] + rank // chunk  # non-decreasing
        num_slots = num_ids + flat.numel() // chunk + 1  # > the chunks of all ids
        partial = torch.segment_reduce(rows, "sum", lengths=torch.bincount(slot, minlength=num_slots))
        lengths = torch.cat([chunks, (num_slots - chunks.sum()).reshape(1)])
        return None, torch.segment_reduce(partial, "sum", lengths=lengths)[:num_ids].to(g.dtype)


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
        return _EmbeddingLookup.apply(ids.long(), self.weight)


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


class GRUCell(torch.nn.Module):
    """torch.nn.GRUCell-compatible cell (gate order r, z, n), with the JAX
    package's dtype handling: each gate product accumulates in float32 at
    least, is cast to its input's dtype, then gets its bias (bf16 under
    AMP). Defaults are torch's U(-1/sqrt(H), 1/sqrt(H)); the GGNN state
    update overrides them."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        weight_ih_init: Optional[init.Initializer] = None,
        weight_hh_init: Optional[init.Initializer] = None,
        bias_ih_init: Optional[init.Initializer] = None,
        bias_hh_init: Optional[init.Initializer] = None,
    ):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        k = 1.0 / math.sqrt(hidden_size)
        default = init.uniform(-k, k)
        self._inits = (
            weight_ih_init or default, weight_hh_init or default,
            bias_ih_init or default, bias_hh_init or default,
        )
        self.weight_ih = torch.nn.Parameter(torch.empty(3 * hidden_size, input_size))
        self.weight_hh = torch.nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.bias_ih = torch.nn.Parameter(torch.empty(3 * hidden_size))
        self.bias_hh = torch.nn.Parameter(torch.empty(3 * hidden_size))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for fill, p in zip(self._inits, (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)):
            fill(p.data, generator)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        gi = F.linear(x, self.weight_ih.to(x.dtype)) + self.bias_ih
        gh = F.linear(h, self.weight_hh.to(h.dtype)) + self.bias_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h
