"""Variable-sized set -> summary representation reductions.

The counterpart of the JAX package's ``reduceops/varsizedsummary.py``: every
reduce is a masked segment op (``ops/segment.py``) over a statically shaped,
padded element array. The softmax-weighted reduces build on
``segment_log_softmax`` (eps=0: an empty set gives a zero summary, and an
impossible element is excluded exactly through -inf).

Each module's parameters sit under the JAX package's param keys
(``weights``, ``attention``, ``query``, ``key``, ``value``, ``output``), so
``convert.py`` loads JAX params without a rename.

Sharded inputs. Under node sharding each rank holds its own element rows,
and ``ElementsToSummaryRepresentationInput.shard_group`` (the JAX package's
``shard_axis``) names the group they are split over: every reduce here then
reduces its rows and combines across ranks with one collective per
reduction (a sum, or a max or min whose backward splits ties across ranks;
the softmax through a global shift and a global denominator). A reduce that
does not implement this keeps ``supports_sharded_inputs`` False and raises
on sharded input (the JAX package marks the abstract class True).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import Linear
from ptgnn_tpu_torch.ops.segment import (
    _promote,
    masked_take,
    segment_count,
    segment_log_softmax,
    segment_max,
    segment_min,
    segment_reduce,
    segment_sum,
)


class ElementsToSummaryRepresentationInput(NamedTuple):
    """A reduce's input: element rows, each row's sample, the padded sample
    budget, an optional validity mask, and the process group the rows are
    split over (None: all rows are here)."""

    element_embeddings: Any  # [num_elements, D] float
    element_to_sample_map: Any  # [num_elements] int in [0, num_samples); padding: num_samples
    num_samples: int  # the padded sample budget
    mask: Optional[Any] = None  # [num_elements] bool; None: all valid
    shard_group: Any = None


class AbstractVarSizedElementReduce(torch.nn.Module):
    """forward(inputs) -> [num_samples, D'] summaries of variable-sized sets."""

    supports_sharded_inputs: bool = False

    def __call__(self, inputs: ElementsToSummaryRepresentationInput, *args, **kwargs) -> torch.Tensor:
        if inputs.shard_group is not None and not self.supports_sharded_inputs:
            raise NotImplementedError(f"{type(self).__name__} does not reduce rows split over ranks")
        return super().__call__(inputs, *args, **kwargs)

    def forward(self, inputs: ElementsToSummaryRepresentationInput) -> torch.Tensor:
        raise NotImplementedError


def _sharded_segment_reduce(data, sample_map, num_samples: int, reduction: str, mask, group) -> torch.Tensor:
    """Per-sample reduce of rows split over ``group``: this rank's segment
    reduce, then one collective (None: the plain segment reduce)."""
    if group is None:
        return segment_reduce(data, sample_map, num_samples, reduction, mask)
    from ptgnn_tpu_torch.parallel.collectives import all_reduce_extremum, all_reduce_sum, all_reduce_sum_

    if reduction in ("sum", "add"):
        return all_reduce_sum(segment_sum(data, sample_map, num_samples, mask), group)
    if reduction == "mean":
        total = all_reduce_sum(segment_sum(data, sample_map, num_samples, mask), group)
        cnt = all_reduce_sum_(segment_count(sample_map, num_samples, mask, dtype=torch.float32), group)
        return total / cnt.clamp_min(1.0).reshape(cnt.shape + (1,) * (total.ndim - 1)).to(total.dtype)
    local_fn = segment_max if reduction == "max" else segment_min
    # the neutral (+-inf) in samples without local rows: they lose the
    # cross-rank combine; samples without any row read 0 after it
    local = local_fn(data, sample_map, num_samples, mask, empty_fill=None)
    out = all_reduce_extremum(local.float(), group, reduction == "max")
    cnt = all_reduce_sum_(segment_count(sample_map, num_samples, mask), group)
    cnt = cnt.reshape(cnt.shape + (1,) * (out.ndim - 1))
    return torch.where(cnt > 0, out, torch.zeros((), device=out.device)).to(data.dtype)


def _sharded_segment_log_softmax(scores, sample_map, num_samples: int, mask, group) -> torch.Tensor:
    """segment_log_softmax over rows split over ``group``: the shift is the
    global max (no gradient, as the local shift), the denominator the
    global sum; the guards of ``ops/segment.py``."""
    if group is None:
        return segment_log_softmax(scores, sample_map, num_samples, mask)
    import torch.distributed as dist

    from ptgnn_tpu_torch.parallel.collectives import all_reduce_sum

    data, orig = _promote(scores)
    shift = segment_max(data.detach(), sample_map, num_samples, mask, empty_fill=None).float()
    dist.all_reduce(shift, op=dist.ReduceOp.MAX, group=group)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    shift = torch.where(torch.isfinite(shift), shift.to(data.dtype), zero)
    shifted = data - masked_take(shift, sample_map, 0.0)
    expd = torch.where(torch.isnan(shifted), zero, torch.exp(shifted))
    if mask is not None:
        expd = torch.where(mask.reshape(mask.shape + (1,) * (expd.ndim - 1)), expd, zero)
    denom = all_reduce_sum(segment_sum(expd, sample_map, num_samples), group)
    nonempty = denom > 0
    log_denom = torch.where(nonempty, torch.log(torch.where(nonempty, denom, torch.ones((), dtype=denom.dtype,
                                                                                         device=denom.device))),
                            torch.full((), -torch.inf, dtype=denom.dtype, device=denom.device))
    lse = log_denom + shift
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros((), dtype=lse.dtype, device=lse.device))
    out = data - masked_take(lse_safe, sample_map, 0.0)
    if mask is not None:
        out = torch.where(mask.reshape(mask.shape + (1,) * (out.ndim - 1)), out,
                          torch.full((), -torch.inf, dtype=out.dtype, device=out.device))
    return out.to(orig) if orig is not None else out


def _xavier_linear(in_features: int, out_features: int) -> Linear:
    return Linear(in_features, out_features, use_bias=False, weight_init=init.xavier_uniform())


class SimpleVarSizedElementReduce(AbstractVarSizedElementReduce):
    """sum, mean, max or min per set."""

    supports_sharded_inputs = True

    def __init__(self, summarization_type: str):
        super().__init__()
        if summarization_type not in {"sum", "mean", "max", "min"}:
            raise ValueError(f"unknown summarization {summarization_type!r}")
        self.summarization_type = summarization_type

    def forward(self, inputs: ElementsToSummaryRepresentationInput) -> torch.Tensor:
        return _sharded_segment_reduce(inputs.element_embeddings, inputs.element_to_sample_map, inputs.num_samples,
                                       self.summarization_type, inputs.mask, inputs.shard_group)


def _attention_weighted_sum(scores, values, sample_map, num_samples: int, mask, group=None) -> torch.Tensor:
    """softmax(scores) within each set, then the weighted sum of values.
    scores [E] or [E, H]; values [E, ...] broadcastable. An empty set gives
    a zero row."""
    probs = torch.exp(_sharded_segment_log_softmax(scores, sample_map, num_samples, mask, group))  # -inf -> 0
    weighted = values * probs.reshape(probs.shape + (1,) * (values.ndim - probs.ndim))
    return _sharded_segment_reduce(weighted, sample_map, num_samples, "sum", mask, group)


class NormalizedWeightsVarSizedElementReduce(AbstractVarSizedElementReduce):
    """Softmax-attention weighted sum (the reference's scatter-index bug
    fixed as intended, as in the JAX package)."""

    supports_sharded_inputs = True

    def __init__(self, input_representation_size: int, output_representation_size: int):
        super().__init__()
        self.attention = _xavier_linear(input_representation_size, 1)
        self.output = _xavier_linear(input_representation_size, output_representation_size)

    def forward(self, inputs: ElementsToSummaryRepresentationInput) -> torch.Tensor:
        scores = self.attention(inputs.element_embeddings)[..., 0]
        values = self.output(inputs.element_embeddings)
        return _attention_weighted_sum(scores, values, inputs.element_to_sample_map, inputs.num_samples,
                                       inputs.mask, inputs.shard_group)


class WeightedSumVarSizedElementReduce(AbstractVarSizedElementReduce):
    """Sigmoid-gated sum: sum over the set of x * sigmoid(w . x)."""

    supports_sharded_inputs = True

    def __init__(self, representation_size: int):
        super().__init__()
        self.weights = _xavier_linear(representation_size, 1)

    def forward(self, inputs: ElementsToSummaryRepresentationInput) -> torch.Tensor:
        gates = torch.sigmoid(self.weights(inputs.element_embeddings))
        return _sharded_segment_reduce(inputs.element_embeddings * gates, inputs.element_to_sample_map,
                                       inputs.num_samples, "sum", inputs.mask, inputs.shard_group)


class SelfAttentionVarSizedElementReduce(AbstractVarSizedElementReduce):
    """Single-head attention whose per-set query comes from another reduce."""

    supports_sharded_inputs = True

    def __init__(
        self,
        input_representation_size: int,
        hidden_size: int,
        output_representation_size: int,
        query_representation_summarizer: AbstractVarSizedElementReduce,
    ):
        super().__init__()
        self.query = query_representation_summarizer
        self.key = _xavier_linear(input_representation_size, hidden_size)
        self.output = _xavier_linear(input_representation_size, output_representation_size)

    def forward(self, inputs: ElementsToSummaryRepresentationInput) -> torch.Tensor:
        queries = self.query(inputs)  # [S, H]
        # Padding elements carry out-of-range sample ids: 0 (their scores are masked).
        queries_all = masked_take(queries, inputs.element_to_sample_map, 0.0)  # [E, H]
        scores = (queries_all * self.key(inputs.element_embeddings)).sum(dim=-1)  # [E]
        values = self.output(inputs.element_embeddings)
        return _attention_weighted_sum(scores, values, inputs.element_to_sample_map, inputs.num_samples,
                                       inputs.mask, inputs.shard_group)


class MultiheadSelfAttentionVarSizedElementReduce(AbstractVarSizedElementReduce):
    """Multi-head attention reduce with an optional value projection."""

    supports_sharded_inputs = True

    def __init__(
        self,
        input_representation_size: int,
        hidden_size: int,
        output_representation_size: int,
        num_heads: int,
        query_representation_summarizer: AbstractVarSizedElementReduce,
        use_value_layer: bool = False,
    ):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError("Hidden size must be divisible by the number of heads.")
        self.num_heads = num_heads
        self.use_value_layer = use_value_layer
        self.query = query_representation_summarizer
        self.key = _xavier_linear(input_representation_size, hidden_size)
        if use_value_layer:
            self.value = _xavier_linear(input_representation_size, hidden_size)
            self.output = _xavier_linear(hidden_size, output_representation_size)
        else:
            self.output = _xavier_linear(input_representation_size * num_heads, output_representation_size)

    def forward(self, inputs: ElementsToSummaryRepresentationInput) -> torch.Tensor:
        h = self.num_heads
        sample_map = inputs.element_to_sample_map
        q_el = masked_take(self.query(inputs), sample_map, 0.0)  # [E, H]
        q_el = q_el.reshape(q_el.shape[0], h, -1)
        keys = self.key(inputs.element_embeddings)
        keys = keys.reshape(keys.shape[0], h, -1)  # [E, h, H/h]
        scores = (q_el * keys).sum(dim=-1) / math.sqrt(keys.shape[-1])  # [E, h]
        probs = torch.exp(_sharded_segment_log_softmax(scores, sample_map, inputs.num_samples, inputs.mask,
                                                       inputs.shard_group))
        if self.use_value_layer:
            values = self.value(inputs.element_embeddings)
            outputs = probs[..., None] * values.reshape(values.shape[0], h, -1)
        else:
            outputs = probs[..., None] * inputs.element_embeddings[:, None, :]  # [E, h, D]
        per_sample = _sharded_segment_reduce(outputs.reshape(outputs.shape[0], -1), sample_map, inputs.num_samples,
                                             "sum", inputs.mask, inputs.shard_group)
        return self.output(per_sample)
