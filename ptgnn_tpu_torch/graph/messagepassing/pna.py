"""Principal Neighbourhood Aggregation (Corso et al. 2020): sum, mean, max,
min and std aggregations times the scalers {1, log-degree, 1/log-degree},
a 15 x message-width output. The counterpart of the JAX package's
``graph/messagepassing/pna.py``: every reduction goes through the
aggregation dispatch (``base.masked_segment_aggregate``), in float32."""
from __future__ import annotations

import torch

from ptgnn_tpu_torch.graph.messagepassing.base import (
    AbstractMessageAggregation,
    GraphContext,
    masked_segment_aggregate,
    masked_segment_degree,
)
from ptgnn_tpu_torch.ops.segment import masked_take


class PnaMessageAggregation(AbstractMessageAggregation):
    def __init__(self, delta: float = 1.0):
        super().__init__()
        self._delta = delta  # Eq 5 of the paper

    def forward(self, messages: torch.Tensor, ctx: GraphContext, num_nodes: int) -> torch.Tensor:
        degree = masked_segment_degree(ctx, num_nodes)[:, None]  # [N, 1] float32
        msg_dtype = messages.dtype
        messages = messages.float()
        sum_agg = masked_segment_aggregate(messages, ctx, num_nodes, "sum")
        mean_agg = sum_agg / (degree + 1e-5)
        max_agg = masked_segment_aggregate(messages, ctx, num_nodes, "max")
        min_agg = masked_segment_aggregate(messages, ctx, num_nodes, "min")

        # std via E[m^2] - mean^2, relu-clamped per element. A node without a
        # live in-slot sums to 0, where sqrt's derivative is infinite: the
        # dispatch masks slots with torch.where, so none of it reaches a
        # message's gradient.
        mean_per_slot = masked_take(mean_agg, ctx.adjacency.receivers, 0.0)
        std_components = torch.relu(messages.square() - mean_per_slot.square()) + 1e-10
        std = torch.sqrt(masked_segment_aggregate(std_components, ctx, num_nodes, "sum"))

        all_aggregations = torch.cat([sum_agg, mean_agg, max_agg, min_agg, std], dim=-1).to(msg_dtype)
        scaler_p1 = torch.log(degree + 1.0) / self._delta
        scaler_m1 = 1.0 / (scaler_p1 + 1e-3)
        return torch.cat(
            [all_aggregations, all_aggregations * scaler_p1.to(msg_dtype), all_aggregations * scaler_m1.to(msg_dtype)],
            dim=-1,
        )

    def output_state_size(self, message_input_size: int) -> int:
        return message_input_size * 5 * 3
