"""The neural primitives the ported paths use.

Weights keep the torch layouts of the JAX package (Linear weight
``[out, in]``), so parameters convert one to one (see ``convert.py``).
"""
from __future__ import annotations

import logging
import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ptgnn_tpu_torch.nn import initializers as init


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as the JAX package's ``gelu_exact``."""
    return F.gelu(x, approximate="none")


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": gelu_exact,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "leaky_relu": F.leaky_relu,
    "elu": F.elu,
    "identity": identity,
    None: identity,
}


class Activation:
    """An activation by name (one of ``ACTIVATIONS``), which pickles with the
    model that holds it."""

    def __init__(self, name: Optional[str]):
        if name not in ACTIVATIONS:
            raise ValueError(f"Unknown activation '{name}'")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return ACTIVATIONS[self.name](x)

    def __repr__(self):
        return f"Activation({self.name!r})"


def get_activation(name: Optional[str]) -> Activation:
    """The activation of a name, or the identity for None."""
    return Activation(name)


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
    one sequential chain. Every shape is fixed by the input sizes and no
    value is read on the host, so nothing waits for the device and a CUDA
    graph captures the backward."""

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
        counts = _count(flat, num_ids)
        chunks = (counts + chunk - 1) // chunk  # chunks of each id
        rank = torch.arange(flat.numel(), device=flat.device) - (torch.cumsum(counts, 0) - counts)[sorted_ids]
        slot = (torch.cumsum(chunks, 0) - chunks)[sorted_ids] + rank // chunk  # non-decreasing
        num_slots = num_ids + flat.numel() // chunk + 1  # > the chunks of all ids
        # ``unsafe``: the lengths sum to the rows by construction; the checks
        # would read them on the host.
        partial = torch.segment_reduce(rows, "sum", lengths=_count(slot, num_slots), unsafe=True)
        lengths = torch.cat([chunks, (num_slots - chunks.sum()).reshape(1)])
        return None, torch.segment_reduce(partial, "sum", lengths=lengths, unsafe=True)[:num_ids].to(g.dtype)


def _count(values: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(values, minlength=n)`` for values in [0, n), with no
    host read of the largest value (bincount sizes its output on the host)."""
    return torch.zeros(n, dtype=torch.long, device=values.device).scatter_add_(0, values, torch.ones_like(values))


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


class Conv1d(torch.nn.Module):
    """torch.nn.Conv1d at stride 1 with VALID padding: [B, C_in, L] ->
    [B, C_out, L - k + 1], weight ``[out, in, k]`` (kaiming-uniform), bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)). As the JAX package's, it convolves in
    float32 (under bf16 AMP too), casts back to the input's dtype, then adds
    the bias in that dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, use_bias: bool = True):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self._bias_init = init.torch_linear_bias(in_channels * kernel_size)
        self.weight = torch.nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = torch.nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init.kaiming_uniform()(self.weight.data, generator)
        if self.bias is not None:
            self._bias_init(self.bias.data, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.float(), self.weight.float()).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[None, :, None]
        return y


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


class GRU(GRUCell):
    """A single-layer batch-first GRU (torch.nn.GRU(num_layers=1,
    batch_first=True)): the cell, stepped over time. It holds the cell's
    parameters under the cell's names, as the JAX package's GRU does, so a
    converted ``gru`` entry loads as a gated layer's ``state_update``."""

    def forward(self, x: torch.Tensor, h0: torch.Tensor):
        """x: [B, T, I]; h0: [B, H] -> (outputs [B, T, H], final state [B, H])."""
        outputs = []
        h = h0
        for t in range(x.shape[1]):
            h = super().forward(x[:, t], h)
            outputs.append(h)
        return torch.stack(outputs, dim=1), h


class MLP(torch.nn.Module):
    """The JAX package's ``MLP``: ``hidden_layers`` is an int (that many
    hidden layers of ``output_dimension`` units; a size-1 output widens them
    to 32) or a list of sizes. Xavier-uniform ``Linear``s (bias-free unless
    ``use_biases``) held as ``layer_{i}``, dropout before every layer, the
    activation between layers and none after the last."""

    def __init__(
        self,
        input_dimension: int,
        output_dimension: int,
        hidden_layers: Union[int, Sequence[int]] = 1,
        use_biases: bool = False,
        activation="relu",
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        if isinstance(hidden_layers, int):
            if output_dimension == 1:
                logging.getLogger(__name__).warning(
                    "MLP was created with %d layers of size 1, which is most likely wrong. Switching to "
                    "%d layers of size 32; to get hidden layers of size 1, use hidden_layers=[1,...,1] "
                    "explicitly.", hidden_layers, hidden_layers,
                )
                hidden_sizes = [32] * hidden_layers
            else:
                hidden_sizes = [output_dimension] * hidden_layers
        else:
            hidden_sizes = list(hidden_layers)
        # A single hidden layer without an activation is allowed.
        if len(hidden_sizes) > 1 and activation is None:
            raise ValueError("Multiple linear layers without an activation")
        self.input_dimension = input_dimension
        self.output_dimension = output_dimension
        self.dropout_rate = dropout_rate
        self.activation = get_activation(activation)
        self._has_activation = activation is not None
        sizes = [input_dimension] + hidden_sizes + [output_dimension]
        self.num_layers = len(sizes) - 1
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", Linear(sizes[i], sizes[i + 1], use_bias=use_biases,
                                                 weight_init=init.xavier_uniform()))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = dropout(x, self.dropout_rate, train, generator)
            x = getattr(self, f"layer_{i}")(x)
            if self._has_activation and i < self.num_layers - 1:
                x = self.activation(x)
        return x
