"""Typilus-schema graphs, after the port's
``utils/synthetic.synthetic_typilus_graphs(topology="ast")`` (string nodes,
nested ``{edge_type: {src: [dsts]}}`` adjacency, annotated supernodes, a
token-sequence backbone), kept here so that the program cannot change the
traffic it is measured on.

Changes from that copy, so that the traffic has the published corpus's
shape (the traffic file cites each figure):

- node labels are identifiers of one to three subtokens drawn from a
  lexicon of ``lexicon_size`` words with a Zipf-Mandelbrot law
  (p(rank r) proportional to 1 / (r + ``lexicon_shift``)), so that the
  model's metadata pass fills its 10,000-subtoken vocabulary;
- annotations are drawn from ``type_lexicon_size`` type names, the common
  built-in ones first, with a Zipf law (p(rank r) proportional to 1 / r),
  so that the class vocabulary fills its 100 classes;
- the edges carry the ``edge_kinds`` the file names: a token chain
  (the first kind), a banded syntax tree (the second) and
  geometric-offset semantic edges (the rest, in equal shares).

Every size (a graph's node count and each semantic kind's edge count) is
drawn from ``size_rng``, whose seed the traffic file fixes, and everything
else (labels, endpoints, supernodes, annotations) from ``rng``, the run's
seed. So every seed offers the same amount of work, in other graphs.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

_COMMON_TYPES = [
    "int", "str", "bool", "float", "bytes", "List[int]", "List[str]",
    "Dict[str, int]", "Dict[str, Any]", "Optional[int]", "Optional[str]",
    "Tuple[int, int]", "Set[str]", "Iterator[str]", "Callable", "Path",
    "np.ndarray", "torch.Tensor", "Dict[int, List[str]]", "Sequence[float]",
]


def word(index: int) -> str:
    """The lexicon's word ``index``: three or more lowercase letters, the
    bijective base-26 numeral of ``index + 702``, so no two words are
    alike and no word splits into subtokens."""
    k, letters = index + 703, []
    while k:
        k, r = divmod(k - 1, 26)
        letters.append(chr(ord("a") + r))
    return "".join(reversed(letters))


def type_names(count: int) -> List[str]:
    """The type lexicon: the common types, then user classes named from
    two words, plain, in a ``List`` or ``Optional`` in turn."""
    names = list(_COMMON_TYPES[:count])
    i = 0
    while len(names) < count:
        cls = word(2 * i).capitalize() + word(2 * i + 1).capitalize()
        names.append((cls, f"List[{cls}]", f"Optional[{cls}]")[i % 3])
        i += 1
    return names


def _zipf(size: int, shift: float) -> np.ndarray:
    p = 1.0 / (np.arange(1, size + 1) + shift)
    return p / p.sum()


def _to_adj(src, dst) -> Dict[str, List[int]]:
    adj: Dict[str, List[int]] = {}
    for s, d in zip(src.tolist(), dst.tolist()):
        adj.setdefault(str(s), []).append(d)
    return adj


def _ast_like_edges(size_rng, rng, n: int, token_len: int, edges_per_node: float, kinds: Sequence[str]):
    """Token chain + banded AST tree + geometric-offset semantic edges."""
    edges: Dict[str, Dict[str, List[int]]] = {}
    chain, tree, semantic = kinds[0], kinds[1], kinds[2:]
    if token_len > 1:
        toks = np.arange(token_len)
        edges[chain] = _to_adj(toks[:-1], toks[1:])
    if n > 1:
        kids = np.arange(1, n)
        parents = kids - 1 - rng.randint(0, np.minimum(kids, 32))
        edges[tree] = _to_adj(parents, kids)
    remaining = max(0, int(edges_per_node * n) - (token_len - 1) - (n - 1))
    for et in semantic:
        num_e = size_rng.poisson(remaining // len(semantic)) if remaining else 0
        if num_e == 0 or n < 2:
            continue
        src = rng.randint(0, n, num_e)
        off = rng.geometric(1.0 / 24.0, num_e) * rng.choice([-1, 1], num_e)
        dst = np.clip(src + off, 0, n - 1)
        keep = dst != src
        if keep.any():
            edges[et] = _to_adj(src[keep], dst[keep])
    return edges


def generate(size_rng: np.random.RandomState, rng: np.random.RandomState, *, mean_nodes: int,
             max_nodes: int, edges_per_node: float, supernode_fraction: float, edge_kinds: Sequence[str],
             lexicon_size: int, lexicon_shift: float, subtokens_per_identifier: Sequence[float],
             type_lexicon_size: int) -> Iterator[Dict]:
    """An endless stream of Typilus-schema graphs; ``subtokens_per_identifier``
    gives the chances of one, two, three... subtokens an identifier."""
    if len(edge_kinds) < 3:
        raise ValueError("edge_kinds needs a chain, a tree and at least one semantic kind")
    words = [word(i) for i in range(lexicon_size)]
    word_p = _zipf(lexicon_size, lexicon_shift)
    types = type_names(type_lexicon_size)
    type_p = _zipf(type_lexicon_size, 0.0)
    parts_p = np.asarray(subtokens_per_identifier, float) / sum(subtokens_per_identifier)
    gi = 0
    while True:
        n = int(np.clip(size_rng.poisson(mean_nodes), 16, max_nodes))
        parts = rng.choice(len(parts_p), size=n, p=parts_p) + 1
        drawn = rng.choice(lexicon_size, size=int(parts.sum()), p=word_p).tolist()
        camel = rng.randint(0, 2, n).tolist()
        nodes, at = [], 0
        for k, c in zip(parts.tolist(), camel):
            ws = [words[j] for j in drawn[at:at + k]]
            at += k
            nodes.append(ws[0] + "".join(w.capitalize() for w in ws[1:]) if c else "_".join(ws))
        token_len = max(4, n // 2)
        edges = _ast_like_edges(size_rng, rng, n, token_len, edges_per_node, edge_kinds)
        num_supernodes = max(1, int(n * supernode_fraction))
        supernode_idxs = rng.choice(n, size=num_supernodes, replace=False)
        annotations = rng.choice(type_lexicon_size, size=num_supernodes, p=type_p)
        supernodes = {
            str(int(idx)): {"name": nodes[idx], "annotation": types[t]}
            for idx, t in zip(supernode_idxs, annotations)
        }
        yield {
            "nodes": nodes,
            "edges": edges,
            "token-sequence": list(range(token_len)),
            "supernodes": supernodes,
            "filename": f"synthetic_{gi}.py",
        }
        gi += 1
