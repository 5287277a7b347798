"""Message-passing layer interface over the fused, type-blocked edge layout.

A layer receives one ``GraphContext`` holding the batch's AdjacencyStruct
and per-graph structure. Messages take the fused route of
``ops/fused_mp.py`` over the batcher's aggregation plan; the tensor's
device picks kernel or plain version.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ptgnn_tpu_torch.graph.structs import AdjacencyStruct, ReferenceSet


class GraphContext(NamedTuple):
    """Everything a message-passing layer may need besides node states."""

    adjacency: AdjacencyStruct
    node_graph: Any  # [N_pad] int32
    node_mask: Any  # [N_pad] bool
    graph_mask: Any  # [G_pad] bool
    references: Dict[str, ReferenceSet]


class AbstractMessagePassingLayer(torch.nn.Module):
    """forward(node_states [N, D], ctx, train=False, generator=None) -> [N, D']
    node states; ``generator`` draws the layer's dropout when training."""

    def forward(self, node_states: torch.Tensor, ctx: GraphContext, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    @property
    def input_state_dimension(self) -> int:
        raise NotImplementedError

    @property
    def output_state_dimension(self) -> int:
        raise NotImplementedError
