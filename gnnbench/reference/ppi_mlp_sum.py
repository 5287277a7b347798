"""Plain reference of PPI node classification (microsoft/ptgnn
``ppi/train.py``): from raw PPI-like graphs to the multi-label loss.

One edge type, with backward and self edges; a bias-free linear embedder
of the 50 features with tanh; the stack of sum-aggregation MLP message
passing in two mean-residual blocks; a linear head to the 121 labels and
binary cross-entropy with logits, summed over the labels and averaged over
the nodes.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from .common import dropout_draws, flatten_edges, linear, run_stack


class Context:
    def __init__(self, config: Dict[str, Any], meta_graphs: Sequence[Dict]):
        self.config = config


class Batch:
    def __init__(self, ctx: Context, graphs: Sequence[Dict], device: torch.device):
        per_graph = []
        for g in graphs:
            arr = np.asarray(g["edges"], np.int64).reshape(-1, 2)
            per_graph.append((len(g["features"]), [(arr[:, 0], arr[:, 1])]))
        self.num_nodes, self.edges = flatten_edges(per_graph, backward=ctx.config["backward_edges"],
                                                   self_edges=ctx.config["self_edges"], device=device)
        self.features = torch.from_numpy(np.concatenate([g["features"] for g in graphs])).float().to(device)
        self.labels = torch.from_numpy(np.concatenate([g["labels"] for g in graphs])).float().to(device)
        self.padded_rows = ctx.config["padding"]["max_nodes"]


def loss(ctx: Context, batch: Batch, params: Dict[str, torch.Tensor], seed: int, fmt: str = "fp32",
         half: bool = False) -> torch.Tensor:
    """The minibatch's training loss with the dropout of generator seed
    ``seed``. ``half`` (a planted fault) averages over the first half of the
    nodes only."""
    draw = dropout_draws(seed, batch.num_nodes, batch.padded_rows, batch.features.device)
    x = torch.tanh(linear(batch.features, params["gnn.node_embedder.linear.weight"], None, fmt))
    x = run_stack(x, batch.edges, params, ctx.config, draw, fmt)
    logits = linear(x, params["to_logits.weight"], params["to_logits.bias"], fmt)
    per_element = logits.clamp_min(0.0) - logits * batch.labels + torch.log1p(torch.exp(-logits.abs()))
    per_node = per_element.sum(dim=-1)
    if half:
        per_node = per_node[: max(1, per_node.shape[0] // 2)]
    return per_node.mean()
