"""Variable-sized set -> summary representation reductions.

The counterpart of the JAX package's ``reduceops/varsizedsummary.py``: every
reduce is a masked segment op (``ops/segment.py``) over a statically shaped,
padded element array. The softmax-weighted reduces build on
``segment_log_softmax`` (eps=0: an empty set gives a zero summary, and an
impossible element is excluded exactly through -inf).

Each module's parameters sit under the JAX package's param keys
(``weights``, ``attention``, ``query``, ``key``, ``value``, ``output``), so
``convert.py`` loads JAX params without a rename.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import Linear
from ptgnn_tpu_torch.ops.segment import masked_take, segment_log_softmax, segment_reduce, segment_sum


class ElementsToSummaryRepresentationInput(NamedTuple):
    """A reduce's input: element rows, each row's sample, the padded sample
    budget and an optional validity mask."""

    element_embeddings: Any  # [num_elements, D] float
    element_to_sample_map: Any  # [num_elements] int in [0, num_samples); padding: num_samples
    num_samples: int  # the padded sample budget
    mask: Optional[Any] = None  # [num_elements] bool; None: all valid


class AbstractVarSizedElementReduce(torch.nn.Module):
    """forward(inputs) -> [num_samples, D'] summaries of variable-sized sets."""

    def forward(self, inputs: ElementsToSummaryRepresentationInput) -> torch.Tensor:
        raise NotImplementedError


def _xavier_linear(in_features: int, out_features: int) -> Linear:
    return Linear(in_features, out_features, use_bias=False, weight_init=init.xavier_uniform())


class SimpleVarSizedElementReduce(AbstractVarSizedElementReduce):
    """sum, mean, max or min per set."""

    def __init__(self, summarization_type: str):
        super().__init__()
        if summarization_type not in {"sum", "mean", "max", "min"}:
            raise ValueError(f"unknown summarization {summarization_type!r}")
        self.summarization_type = summarization_type

    def forward(self, inputs: ElementsToSummaryRepresentationInput) -> torch.Tensor:
        return segment_reduce(inputs.element_embeddings, inputs.element_to_sample_map, inputs.num_samples,
                              self.summarization_type, inputs.mask)


def _attention_weighted_sum(scores, values, sample_map, num_samples: int, mask) -> torch.Tensor:
    """softmax(scores) within each set, then the weighted sum of values.
    scores [E] or [E, H]; values [E, ...] broadcastable. An empty set gives
    a zero row."""
    probs = torch.exp(segment_log_softmax(scores, sample_map, num_samples, mask))  # -inf -> 0
    weighted = values * probs.reshape(probs.shape + (1,) * (values.ndim - probs.ndim))
    return segment_sum(weighted, sample_map, num_samples, mask)


class NormalizedWeightsVarSizedElementReduce(AbstractVarSizedElementReduce):
    """Softmax-attention weighted sum (the reference's scatter-index bug
    fixed as intended, as in the JAX package)."""

    def __init__(self, input_representation_size: int, output_representation_size: int):
        super().__init__()
        self.attention = _xavier_linear(input_representation_size, 1)
        self.output = _xavier_linear(input_representation_size, output_representation_size)

    def forward(self, inputs: ElementsToSummaryRepresentationInput) -> torch.Tensor:
        scores = self.attention(inputs.element_embeddings)[..., 0]
        values = self.output(inputs.element_embeddings)
        return _attention_weighted_sum(scores, values, inputs.element_to_sample_map, inputs.num_samples,
                                       inputs.mask)


class WeightedSumVarSizedElementReduce(AbstractVarSizedElementReduce):
    """Sigmoid-gated sum: sum over the set of x * sigmoid(w . x)."""

    def __init__(self, representation_size: int):
        super().__init__()
        self.weights = _xavier_linear(representation_size, 1)

    def forward(self, inputs: ElementsToSummaryRepresentationInput) -> torch.Tensor:
        gates = torch.sigmoid(self.weights(inputs.element_embeddings))
        return segment_sum(inputs.element_embeddings * gates, inputs.element_to_sample_map,
                           inputs.num_samples, inputs.mask)


class SelfAttentionVarSizedElementReduce(AbstractVarSizedElementReduce):
    """Single-head attention whose per-set query comes from another reduce."""

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
                                       inputs.mask)


class MultiheadSelfAttentionVarSizedElementReduce(AbstractVarSizedElementReduce):
    """Multi-head attention reduce with an optional value projection."""

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
        probs = torch.exp(segment_log_softmax(scores, sample_map, inputs.num_samples, inputs.mask))
        if self.use_value_layer:
            values = self.value(inputs.element_embeddings)
            outputs = probs[..., None] * values.reshape(values.shape[0], h, -1)
        else:
            outputs = probs[..., None] * inputs.element_embeddings[:, None, :]  # [E, h, D]
        per_sample = segment_sum(outputs.reshape(outputs.shape[0], -1), sample_map, inputs.num_samples,
                                 inputs.mask)
        return self.output(per_sample)
