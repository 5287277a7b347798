"""PPI (GraphSAGE-format) dataset loading from a local or remote directory.

Reads ``{fold}_graph.json`` (node-link JSON), ``{fold}_feats.npy``,
``{fold}_labels.npy`` and ``{fold}_graph_id.npy``, and splits the disjoint
union into per-graph samples with node ids rebased to 0 and one forward edge
type. A path containing ``://`` is read through fsspec (``utils/io.py``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Union

import numpy as np

from ptgnn_tpu_torch.utils.io import is_remote_path, join_path, open_binary


class PPIGraphSample:
    """A single PPI graph."""

    def __init__(
        self,
        adjacency_lists: List[np.ndarray],
        node_features: np.ndarray,
        node_labels: np.ndarray,
    ):
        self._adjacency_lists = adjacency_lists
        self._node_features = node_features
        self._node_labels = node_labels

    @property
    def node_labels(self) -> np.ndarray:
        """[V, C] bool labels."""
        return self._node_labels

    @property
    def adjacency_lists(self) -> List[np.ndarray]:
        """Per-edge-type [E, 2] int arrays."""
        return self._adjacency_lists

    @property
    def node_features(self) -> np.ndarray:
        """[V, F] float features."""
        return self._node_features

    @classmethod
    def from_synthetic(cls, graph: Dict) -> "PPIGraphSample":
        """A sample from one ``utils.synthetic.synthetic_ppi_graphs`` graph."""
        return cls(
            adjacency_lists=[np.asarray(graph["edges"], np.int32).reshape(-1, 2)],
            node_features=graph["features"],
            node_labels=graph["labels"].astype(bool),
        )


class PPIDatasetLoader:
    @classmethod
    def load_data(cls, data_dir: Union[str, Path], data_fold: str) -> List[PPIGraphSample]:
        if not is_remote_path(data_dir):
            data_dir = Path(data_dir)
        with open_binary(join_path(data_dir, f"{data_fold}_graph.json")) as f:
            graph_json_data = json.load(f)
        arrays = []
        for name in ("feats", "labels", "graph_id"):
            with open_binary(join_path(data_dir, f"{data_fold}_{name}.npy")) as f:
                arrays.append(np.load(f))
        node_to_features, node_to_labels, node_to_graph_id = arrays

        # Graph ids cover contiguous node ranges in the GraphSAGE dump: find
        # each graph's first node, then rebase edges so each graph starts at 0.
        graph_id_to_node_offset: Dict[int, int] = {}
        graph_id_to_edges: Dict[int, List] = {}
        order: List[int] = []
        for node_id in range(node_to_features.shape[0]):
            graph_id = int(node_to_graph_id[node_id])
            if graph_id not in graph_id_to_node_offset:
                graph_id_to_node_offset[graph_id] = node_id
                graph_id_to_edges[graph_id] = []
                order.append(graph_id)

        for edge_info in graph_json_data["links"]:
            src_node, tgt_node = edge_info["source"], edge_info["target"]
            graph_id = int(node_to_graph_id[src_node])
            offset = graph_id_to_node_offset[graph_id]
            graph_id_to_edges[graph_id].append((src_node - offset, tgt_node - offset))

        final_graphs: List[PPIGraphSample] = []
        for i, graph_id in enumerate(order):
            start = graph_id_to_node_offset[graph_id]
            end = graph_id_to_node_offset[order[i + 1]] if i + 1 < len(order) else node_to_features.shape[0]
            final_graphs.append(
                PPIGraphSample(
                    adjacency_lists=[np.asarray(graph_id_to_edges[graph_id], np.int32).reshape(-1, 2)],
                    node_features=np.asarray(node_to_features[start:end], np.float32),
                    node_labels=np.asarray(node_to_labels[start:end], bool),
                )
            )
        return final_graphs
