"""Graph2Seq through the program: the model its factory builds for the
configuration, its metadata pass, and a minibatch of given graphs through
its tensorize, minibatch and finalize path. ``layout`` and the counts are
the benchmark's own, worked out from the raw graphs.

The metadata pass sees each metadata graph, then the names of its
``corpus_names`` (``generators/code_graph2seq.py``) as datapoints with no
graph: the published run builds its output vocabulary from the names of its
whole training set. The reference (``reference/g2s_ggnn_copy.py``) counts
in the same order."""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from . import graph2class
from .graph2class import _padding, num_edge_types

NAME_ONLY = {"backbone_sequence": [], "node_labels": [], "edges": {}}


def edge_types(meta_graphs: Sequence[Dict]) -> List[str]:
    return sorted({et for g in meta_graphs for et in g["edges"]})


def layout(config: Dict[str, Any], graph: Dict, type_index: Dict[str, int]) -> Tuple[int, np.ndarray, np.ndarray,
                                                                                    Dict[str, int]]:
    """(nodes, receivers, types, reference counts) of the graph's
    materialized edges (forward type t, backward T + t); the counts are its
    memories (``backbone_nodes``) and its one target sequence."""
    n = len(graph["node_labels"])
    num_fwd = len(type_index)
    recv, types = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for et, pairs in graph["edges"].items():
        t = type_index.get(et)
        if t is None or not pairs:
            continue
        arr = np.asarray(pairs, np.int64).reshape(-1, 2)
        recv.append(arr[:, 1])
        types.append(np.full(len(arr), t))
        if config["backward_edges"]:
            recv.append(arr[:, 0])
            types.append(np.full(len(arr), num_fwd + t))
    if config["self_edges"]:
        recv.append(np.arange(n))
        types.append(np.full(n, num_edge_types(config, num_fwd) - 1))
    refs = {"backbone_nodes": len(graph["backbone_sequence"]), "target_sequences": 1}
    return n, np.concatenate(recv).astype(np.int64), np.concatenate(types).astype(np.int64), refs


def datapoint(graph: Dict) -> Dict[str, Any]:
    """The program's CodeGraph2Seq sample of a raw graph."""
    return {k: graph[k] for k in ("backbone_sequence", "node_labels", "edges", "method_name")}


def metadata_datapoints(meta_graphs: Sequence[Dict]) -> Iterator[Dict[str, Any]]:
    """Each metadata graph's sample, then a graph-free sample of each name
    of its corpus."""
    for g in meta_graphs:
        yield datapoint(g)
        for name in g.get("corpus_names", ()):
            yield dict(NAME_ONLY, method_name=name)


def _check(model, config: Dict[str, Any]) -> None:
    """The factory's fixed settings are the configuration's."""
    emb, dec = model.gnn_model.node_embedding_model, model.decoder_model
    found = {
        ("embedder", "min_freq_threshold"): emb.min_freq_threshold,
        ("embedder", "dropout_rate"): emb.dropout_rate,
        ("decoder", "vocabulary_size"): dec.vocabulary_max_size,
        ("decoder", "min_freq_threshold"): dec.vocabulary_count_threshold,
        ("decoder", "dropout_rate"): dec.dropout_rate,
        ("summarizer", "num_heads"): model.num_summarization_heads,
    }
    wrong = {k: v for k, v in found.items() if config[k[0]][k[1]] != v}
    if wrong or model.gnn_model.add_self_edges != config["self_edges"] or \
            model.gnn_model.introduce_backwards_edges != config["backward_edges"]:
        raise ValueError(f"the program's Graph2Seq factory differs from the configuration: {wrong}")


def build(config: Dict[str, Any], meta_graphs: Sequence[Dict], device):
    """(model with metadata from ``meta_graphs``, module on ``device``) by
    the program's factory."""
    from ptgnn_tpu_torch.implementations.graph2seq.train import create_graph2seq_model

    dec = config["decoder"]
    model = create_graph2seq_model(
        embedding_size=config["hidden_state_size"], dropout_rate=config["dropout_rate"], padding=_padding(config),
        max_seq_len=dec["max_seq_len"], token_vocabulary_size=config["embedder"]["vocabulary_size"],
        decoder_hidden_size=dec["hidden_size"], decoder_embedding_size=dec["embedding_size"],
    )
    _check(model, config)
    model.compute_metadata(metadata_datapoints(meta_graphs), parallelize=False)
    return model, model.build_neural_module(device=device)


def minibatch(model, graphs: Sequence[Dict]) -> Dict[str, Any]:
    return graph2class.minibatch(model, graphs, datapoint)
