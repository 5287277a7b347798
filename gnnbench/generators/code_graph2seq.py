"""CodeGraph2Seq-schema graphs, after the port's
``utils/synthetic.synthetic_graph2seq_samples`` (labelled nodes, three random
edge families, a sorted backbone of nodes, a method name that the graph
determines: node 0 is a root that points at the name's source nodes over a
``RETURNS_TO`` family), kept here so that the program cannot change the
traffic it is measured on.

Changes from that copy, so that the model's vocabularies fill as the
published run's corpus fills them (the traffic file cites each figure):

- node labels and name tokens are words of a lexicon of ``lexicon_size``
  drawn with a Zipf-Mandelbrot law (p(rank r) proportional to
  1 / (r + ``lexicon_shift``)); the root's label is fixed;
- every graph carries ``corpus_names``: the method names of
  ``corpus_names_per_graph`` other methods of the training corpus, drawn
  as the graph's own name is (1 to 3 copyable tokens and, with chance
  ``extra_token_chance``, one more from the lexicon). The metadata pass
  counts them as the published run counts the names of its whole training
  set, whose graphs the run never trains on; a batch ignores them.

Sizes (a graph's node count, each edge family's count, the name's length
and whether it has an extra token) come from ``size_rng``, whose seed the
traffic file fixes; everything else (labels, endpoints, the backbone, which
nodes the name copies, the corpus's names) from ``rng``, the run's seed. So
every seed offers the same amount of work, in other graphs.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

from .typilus_ast import word

ROOT_LABEL = "method_root"


def _cdf(size: int, shift: float) -> np.ndarray:
    p = 1.0 / (np.arange(1, size + 1) + shift)
    return np.cumsum(p / p.sum())


def _draw(rng: np.random.RandomState, cdf: np.ndarray, count: int) -> np.ndarray:
    return np.minimum(np.searchsorted(cdf, rng.random_sample(count), side="right"), len(cdf) - 1)


def _corpus_names(rng, cdf, words: Sequence[str], count: int, name_len: int, extra_chance: float) -> List[List[str]]:
    lengths = rng.randint(1, name_len + 1, count) + (rng.random_sample(count) < extra_chance)
    drawn = _draw(rng, cdf, int(lengths.sum())).tolist()
    names, at = [], 0
    for k in lengths.tolist():
        names.append([words[j] for j in drawn[at:at + k]])
        at += k
    return names


def generate(size_rng: np.random.RandomState, rng: np.random.RandomState, *, mean_nodes: int, max_nodes: int,
             min_nodes: int, edge_kinds: Sequence[str], edges_per_node_per_kind: float, backbone_fraction: float,
             name_len: int, extra_token_chance: float, lexicon_size: int, lexicon_shift: float,
             corpus_names_per_graph: int) -> Iterator[Dict]:
    """An endless stream of CodeGraph2Seq graphs."""
    words = [word(i) for i in range(lexicon_size)]
    cdf = _cdf(lexicon_size, lexicon_shift)
    while True:
        n = int(np.clip(size_rng.poisson(mean_nodes), min_nodes, max_nodes))
        counts = [int(size_rng.poisson(edges_per_node_per_kind * n)) for _ in edge_kinds]
        backbone_size = min(max(2, int(n * backbone_fraction)), n - 1)  # node 0 is never a memory
        k = min(int(size_rng.randint(1, name_len + 1)), backbone_size)
        extra = bool(size_rng.random_sample() < extra_token_chance)

        labels = [words[j] for j in _draw(rng, cdf, n).tolist()]
        labels[0] = ROOT_LABEL
        edges: Dict[str, List] = {}
        for kind, num_e in zip(edge_kinds, counts):
            if num_e:
                edges[kind] = list(zip(rng.randint(0, n, num_e).tolist(), rng.randint(0, n, num_e).tolist()))
        backbone = np.sort(rng.choice(np.arange(1, n), size=backbone_size, replace=False))
        name_nodes = np.sort(rng.choice(backbone, size=k, replace=False)).tolist()
        edges["RETURNS_TO"] = [(0, v) for v in name_nodes]
        name = [labels[v] for v in name_nodes]
        if extra:
            name.append(words[int(_draw(rng, cdf, 1)[0])])
        yield {
            "backbone_sequence": backbone.tolist(),
            "node_labels": labels,
            "edges": edges,
            "method_name": name,
            "corpus_names": _corpus_names(rng, cdf, words, corpus_names_per_graph, name_len, extra_token_chance),
        }
