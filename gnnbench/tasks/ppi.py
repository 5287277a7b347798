"""PPI through the program: the model its factory builds for the
configuration, and a minibatch of given graphs through its tensorize,
minibatch and finalize path. ``layout`` and the counts are the
benchmark's own, worked out from the raw graphs."""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from . import graph2class
from .graph2class import _padding, num_edge_types


def edge_types(meta_graphs: Sequence[Dict]) -> List[str]:
    return ["e0"]  # the program names a PPI graph's one adjacency list so


def layout(config: Dict[str, Any], graph: Dict, type_index: Dict[str, int]) -> Tuple[int, np.ndarray, np.ndarray,
                                                                                    Dict[str, int]]:
    n = len(graph["features"])
    arr = np.asarray(graph["edges"], np.int64).reshape(-1, 2)
    recv, types = [arr[:, 1]], [np.zeros(len(arr), np.int64)]
    if config["backward_edges"]:
        recv.append(arr[:, 0])
        types.append(np.ones(len(arr), np.int64))
    if config["self_edges"]:
        recv.append(np.arange(n))
        types.append(np.full(n, num_edge_types(config, 1) - 1))
    return n, np.concatenate(recv).astype(np.int64), np.concatenate(types).astype(np.int64), {}


def build(config: Dict[str, Any], meta_graphs: Sequence[Dict], device):
    from ptgnn_tpu_torch.implementations.ppi.train import create_ppi_gnn_model

    model = create_ppi_gnn_model(hidden_state_size=config["hidden_state_size"], padding=_padding(config))
    model.compute_metadata(iter([datapoint(g) for g in meta_graphs]), parallelize=False)
    return model, model.build_neural_module(device=device)


def datapoint(graph: Dict):
    from ptgnn_tpu_torch.implementations.ppi.dataloader import PPIGraphSample

    return PPIGraphSample.from_synthetic(graph)


def minibatch(model, graphs: Sequence[Dict]) -> Dict[str, Any]:
    return graph2class.minibatch(model, graphs, datapoint)
