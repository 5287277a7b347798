"""Graph2Class through the program: the model its factory builds for the
configuration, and a minibatch of given graphs through its tensorize,
minibatch and finalize path. ``layout`` and the counts are the
benchmark's own, worked out from the raw graphs."""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


def num_edge_types(config: Dict[str, Any], num_fwd: int) -> int:
    return num_fwd * (2 if config["backward_edges"] else 1) + (1 if config["self_edges"] else 0)


def edge_types(meta_graphs: Sequence[Dict]) -> List[str]:
    return sorted({et for g in meta_graphs for et in g["edges"]})


def layout(config: Dict[str, Any], graph: Dict, type_index: Dict[str, int]) -> Tuple[int, np.ndarray, np.ndarray,
                                                                                    Dict[str, int]]:
    """(nodes, receivers, types, reference counts) of the graph's
    materialized edges: forward type t, backward T + t, self 2T."""
    n = len(graph["nodes"])
    num_fwd = len(type_index)
    recv, types = [], []
    for et, nested in graph["edges"].items():
        t = type_index.get(et)
        if t is None:
            continue
        src = np.fromiter((int(s) for s, dsts in nested.items() for _ in dsts), np.int64)
        dst = np.fromiter((d for dsts in nested.values() for d in dsts), np.int64)
        recv.append(dst)
        types.append(np.full(len(dst), t))
        if config["backward_edges"]:
            recv.append(src)
            types.append(np.full(len(src), num_fwd + t))
    if config["self_edges"]:
        recv.append(np.arange(n))
        types.append(np.full(n, num_edge_types(config, num_fwd) - 1))
    labelled = sum(1 for info in graph["supernodes"].values()
                   if info.get("annotation") is not None and info.get("annotation") not in _IGNORED)
    refs = {"supernodes": labelled, "token-sequence": len(graph["token-sequence"])}
    return n, np.concatenate(recv).astype(np.int64), np.concatenate(types).astype(np.int64), refs


_IGNORED = {
    "typing.Any", "Any", "", "typing.NoReturn", "NoReturn", "nothing", "None",
    "T", "_T", "_T0", "_T1", "_T2", "_T3", "_T4", "_T5", "_T6", "_T7",
}


def _padding(config: Dict[str, Any]):
    from ptgnn_tpu_torch.graph.structs import BatchPadding

    p = config["padding"]
    return BatchPadding(
        max_nodes=p["max_nodes"], max_edge_slots=p["max_edge_slots"], max_graphs=p["max_graphs"],
        edge_tile=p["edge_tile"], agg_rows=p["agg_rows"], agg_sum_tile=p["agg_sum_tile"],
        reference_budgets=tuple(p["reference_budgets"].items()),
        default_reference_budget=p["default_reference_budget"],
    )


def build(config: Dict[str, Any], meta_graphs: Sequence[Dict], device):
    """(model with metadata from ``meta_graphs``, module on ``device``) by
    the program's factory."""
    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model

    emb = config["embedder"]
    model = create_graph2class_gnn_model(
        hidden_state_size=config["hidden_state_size"], dropout_rate=config["dropout_rate"],
        padding=_padding(config), architecture=config["architecture"], min_freq_threshold=emb["min_freq_threshold"],
    )
    model.compute_metadata(iter(meta_graphs), parallelize=False)
    return model, model.build_neural_module(device=device)


def minibatch(model, graphs: Sequence[Dict], datapoint=lambda graph: graph) -> Dict[str, Any]:
    """The host minibatch of ``graphs`` (each made the model's datapoint by
    ``datapoint``) by the program's path; raises where the program would
    not take a graph into it."""
    mb = model.initialize_minibatch()
    for g in graphs:
        t = model.tensorize(datapoint(g))
        if t is None or not model.can_add_to_minibatch(t, mb):
            raise RuntimeError("the program does not take a graph of the benchmark's minibatch")
        model.extend_minibatch_with(t, mb)
    return model.finalize_minibatch(mb)
