"""PPI-like graphs: a frozen copy of the port's
``utils/synthetic.synthetic_ppi_graphs`` (float node features, multi-hot
labels, one edge type), kept here so that the program cannot change the
traffic it is measured on.

One change from the copy: a graph's node count is drawn from ``size_rng``,
whose seed the traffic file fixes, and everything else (features, labels,
endpoints) from ``rng``, the run's seed. The edge count follows from the
node count, so every seed offers the same amount of work, in other graphs.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def generate(size_rng: np.random.RandomState, rng: np.random.RandomState, *, mean_nodes: int = 300,
             num_features: int = 50, num_labels: int = 121, edges_per_node: float = 10.0) -> Iterator[Dict]:
    """An endless stream of ``{"features": [N, F] float32, "labels": [N, L]
    float32 0/1, "edges": [(u, v), ...]}``."""
    # A feature -> label projection fixed across seeds, as in the copy.
    w = np.random.RandomState(12345).randn(num_features, num_labels).astype(np.float32)
    while True:
        n = int(np.clip(size_rng.poisson(mean_nodes), 32, 4 * mean_nodes))
        feats = rng.randn(n, num_features).astype(np.float32)
        logits = feats @ w + 0.5 * rng.randn(n, num_labels).astype(np.float32)
        labels = (logits > 0).astype(np.float32)
        num_e = int(edges_per_node * n)
        edges = list(zip(rng.randint(0, n, num_e).tolist(), rng.randint(0, n, num_e).tolist()))
        yield {"features": feats, "labels": labels, "edges": edges}
