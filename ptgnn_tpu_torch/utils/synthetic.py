"""Synthetic Typilus-schema graphs, Graph2Seq and VarMisuse samples and
PPI-like graphs for tests and the chip smoke run.

The same generators as the JAX package's ``synthetic_typilus_graphs``,
``synthetic_graph2seq_samples``, ``synthetic_varmisuse_samples`` and
``synthetic_ppi_graphs``: for a seed both packages see the same data, so
their batches can be compared bitwise.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

_TYPE_NAMES = [
    "int", "str", "bool", "float", "bytes", "List[int]", "List[str]",
    "Dict[str, int]", "Dict[str, Any]", "Optional[int]", "Optional[str]",
    "Tuple[int, int]", "Set[str]", "Iterator[str]", "Callable", "Path",
    "np.ndarray", "torch.Tensor", "Dict[int, List[str]]", "Sequence[float]",
]

_IDENTIFIERS = [
    "foo", "bar", "baz", "value", "result", "index", "count", "name", "data",
    "items", "node", "graph", "edge", "config", "parse", "load", "save",
    "get_value", "setItem", "maxCount", "numNodes", "fileName", "toString",
    "run_loop", "batchSize", "learningRate", "outputDir", "inputPath",
]

_EDGE_TYPES = ["NEXT", "CHILD", "OCCURRENCE_OF", "COMPUTED_FROM", "RETURNS_TO"]


def _to_adj(src, dst) -> Dict[str, List[int]]:
    adj: Dict[str, List[int]] = {}
    for s, d in zip(src, dst):
        adj.setdefault(str(int(s)), []).append(int(d))
    return adj


def _ast_like_edges(rng, n: int, token_len: int, edges_per_node: float):
    """Token chain + banded AST tree + geometric-offset semantic edges."""
    edges: Dict[str, Dict[str, List[int]]] = {}
    if token_len > 1:
        toks = np.arange(token_len)
        edges["NEXT"] = _to_adj(toks[:-1], toks[1:])
    if n > 1:
        kids = np.arange(1, n)
        parents = kids - 1 - rng.randint(0, np.minimum(kids, 32))
        edges["CHILD"] = _to_adj(parents, kids)
    remaining = max(0, int(edges_per_node * n) - (token_len - 1) - (n - 1))
    for et in ("OCCURRENCE_OF", "COMPUTED_FROM", "RETURNS_TO"):
        num_e = rng.poisson(remaining // 3) if remaining else 0
        if num_e == 0 or n < 2:
            continue
        src = rng.randint(0, n, num_e)
        off = rng.geometric(1.0 / 24.0, num_e) * rng.choice([-1, 1], num_e)
        dst = np.clip(src + off, 0, n - 1)
        keep = dst != src
        if keep.any():
            edges[et] = _to_adj(src[keep], dst[keep])
    return edges


def synthetic_typilus_graphs(
    num_graphs: int,
    seed: int = 0,
    mean_nodes: int = 200,
    max_nodes: int = 2000,
    edges_per_node: float = 2.0,
    supernode_fraction: float = 0.05,
    topology: str = "random",
) -> Iterator[Dict]:
    """Typilus-schema graphs: string nodes, nested ``{edge_type: {src:
    [dsts]}}`` adjacency, annotated supernodes, a token-sequence backbone.
    ``topology`` is "random" (uniform pairs) or "ast" (program-graph-like)."""
    if topology not in ("random", "ast"):
        raise ValueError(f"unknown topology {topology!r}")
    rng = np.random.RandomState(seed)
    type_probs = 1.0 / np.arange(1, len(_TYPE_NAMES) + 1)
    type_probs /= type_probs.sum()

    for gi in range(num_graphs):
        n = int(np.clip(rng.poisson(mean_nodes), 16, max_nodes))
        nodes = [str(_IDENTIFIERS[rng.randint(len(_IDENTIFIERS))]) for _ in range(n)]
        token_len = max(4, n // 2)
        token_sequence = list(range(token_len))

        edges: Dict[str, Dict[str, List[int]]] = {}
        if topology == "random":
            for et in _EDGE_TYPES:
                num_e = rng.poisson(edges_per_node * n / len(_EDGE_TYPES))
                if num_e == 0:
                    continue
                src = rng.randint(0, n, num_e)
                dst = rng.randint(0, n, num_e)
                edges[et] = _to_adj(src, dst)
        else:
            edges = _ast_like_edges(rng, n, token_len, edges_per_node)

        num_supernodes = max(1, int(n * supernode_fraction))
        supernode_idxs = rng.choice(n, size=num_supernodes, replace=False)
        supernodes = {
            str(int(idx)): {
                "name": nodes[idx],
                "annotation": _TYPE_NAMES[rng.choice(len(_TYPE_NAMES), p=type_probs)],
            }
            for idx in supernode_idxs
        }

        yield {
            "nodes": nodes,
            "edges": edges,
            "token-sequence": token_sequence,
            "supernodes": supernodes,
            "filename": f"synthetic_{gi}.py",
        }


def synthetic_graph2seq_samples(
    num_samples: int,
    seed: int = 0,
    mean_nodes: int = 60,
    max_nodes: int = 150,
    backbone_fraction: float = 0.4,
    name_len: int = 3,
) -> Iterator[Dict]:
    """CodeGraph2Seq-schema samples: labelled nodes, three random edge
    families, a sorted backbone of nodes, and a method name that the graph
    determines. Node 0 is a fixed-label root that points at the name's source
    nodes over a ``RETURNS_TO`` edge family, so message passing can mark them
    and the copy attention can pick them out. Name tokens are lowercased, as
    the Graph2Seq model lowercases node labels; with probability 0.2 a token
    that may not be copyable is appended, so the vocabulary and UNK paths run
    too."""
    rng = np.random.RandomState(seed)
    for _ in range(num_samples):
        n = int(np.clip(rng.poisson(mean_nodes), 12, max_nodes))
        node_labels = [_IDENTIFIERS[rng.randint(len(_IDENTIFIERS))] for _ in range(n)]
        node_labels[0] = "method_root"
        edges: Dict[str, List] = {}
        for et in _EDGE_TYPES[:3]:
            num_e = rng.poisson(1.5 * n / 3)
            if num_e:
                edges[et] = [(int(a), int(b)) for a, b in zip(rng.randint(0, n, num_e), rng.randint(0, n, num_e))]
        # node 0 is excluded, so at most n - 1 backbone nodes
        backbone_size = min(max(2, int(n * backbone_fraction)), n - 1)
        backbone = sorted(rng.choice(np.arange(1, n), size=backbone_size, replace=False).tolist())
        k = min(rng.randint(1, name_len + 1), len(backbone))
        name_nodes = sorted(rng.choice(backbone, size=k, replace=False).tolist())
        edges["RETURNS_TO"] = [(0, int(v)) for v in name_nodes]
        name = [node_labels[v].lower() for v in name_nodes]
        if rng.rand() < 0.2:
            name.append(_IDENTIFIERS[rng.randint(len(_IDENTIFIERS))].lower())
        yield {
            "backbone_sequence": backbone,
            "node_labels": node_labels,
            "edges": edges,
            "method_name": name,
        }


def synthetic_varmisuse_samples(
    num_samples: int,
    seed: int = 0,
    mean_tokens: int = 40,
    num_candidates: int = 4,
) -> Iterator[Dict]:
    """VarMisuse-schema samples: a chain of identifier tokens (NextToken),
    random Child edges, ``num_candidates`` candidate dummy nodes and one slot
    dummy node, each joined to a token by a Uses edge. The slot's label is
    the correct candidate's symbol name, and the slot uses the same token as
    the correct candidate, so the task is learnable."""
    rng = np.random.RandomState(seed)
    for _ in range(num_samples):
        n_tok = int(np.clip(rng.poisson(mean_tokens), 10, 4 * mean_tokens))
        labels = {str(i): _IDENTIFIERS[rng.randint(len(_IDENTIFIERS))] for i in range(n_tok)}
        cand_names = list(rng.choice(_IDENTIFIERS, size=num_candidates, replace=False))
        correct = int(rng.randint(num_candidates))
        cand_nodes = []
        for k, name in enumerate(cand_names):
            labels[str(n_tok + k)] = str(name)
            cand_nodes.append(n_tok + k)
        slot_node = n_tok + num_candidates
        labels[str(slot_node)] = str(cand_names[correct])

        next_token = [(i, i + 1) for i in range(n_tok - 1)]
        child = [(int(a), int(b)) for a, b in zip(rng.randint(0, n_tok, n_tok // 2), rng.randint(0, n_tok, n_tok // 2))]
        cand_tokens = rng.choice(n_tok, size=num_candidates, replace=False)
        uses = [(int(c), int(t)) for c, t in zip(cand_nodes, cand_tokens)]
        uses.append((slot_node, int(cand_tokens[correct])))
        yield {
            "ContextGraph": {
                "Edges": {"NextToken": next_token, "Child": child, "Uses": uses},
                "NodeLabels": labels,
                "NodeTypes": {},
            },
            "slotTokenIdx": 0,
            "SlotDummyNode": slot_node,
            "SymbolCandidates": [
                {"SymbolDummyNode": int(c), "SymbolName": str(name), "IsCorrect": bool(k == correct)}
                for k, (c, name) in enumerate(zip(cand_nodes, cand_names))
            ],
        }


def synthetic_ppi_graphs(
    num_graphs: int,
    seed: int = 0,
    mean_nodes: int = 300,
    num_features: int = 50,
    num_labels: int = 121,
    edges_per_node: float = 10.0,
) -> Iterator[Dict]:
    """PPI-like graphs: float node features, multi-hot labels, one edge type.
    Yields ``{"features": [N, F] float32, "labels": [N, L] float32 0/1,
    "edges": [(u, v), ...]}``."""
    rng = np.random.RandomState(seed)
    # A feature -> label projection fixed across seeds, so that a model
    # trained on one seed's graphs generalizes to another's.
    w = np.random.RandomState(12345).randn(num_features, num_labels).astype(np.float32)
    for _ in range(num_graphs):
        n = int(np.clip(rng.poisson(mean_nodes), 32, 4 * mean_nodes))
        feats = rng.randn(n, num_features).astype(np.float32)
        logits = feats @ w + 0.5 * rng.randn(n, num_labels).astype(np.float32)
        labels = (logits > 0).astype(np.float32)
        num_e = int(edges_per_node * n)
        edges = list(zip(rng.randint(0, n, num_e).tolist(), rng.randint(0, n, num_e).tolist()))
        yield {"features": feats, "labels": labels, "edges": edges}
