"""Traffic: seeds, graph streams, and the grouping of graphs into the
configuration's static minibatch budgets.

The grouping is the benchmark's own: a greedy fill in stream order, a
graph joining the open minibatch while the graph count, the node count,
the edge slots of the padded layout and each reference budget allow it,
and the minibatch closing once its nodes reach the configuration's stop.
The edge slots follow the layout's rule: every (row block, edge type)
segment of receivers rounded up to the edge tile, every row block's run to
the sum supertile, an aligned run for every empty block.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from . import spec


def sub_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed derived from the run's ``--seed`` (any whole number)
    and integer ``keys``."""
    words = [int(seed) % (1 << 64)] + [int(k) % (1 << 64) for k in keys]
    return int(np.random.SeedSequence(words).generate_state(1)[0])


SALT_GRAPHS, SALT_WEIGHTS, SALT_DROPOUT = 1, 2, 3


def dropout_seed(seed: int, step: int, rank: int = 0) -> int:
    """The dropout generator's seed of one step on one rank."""
    return sub_seed(seed, SALT_DROPOUT, step, rank)


def graph_stream(traffic: Dict[str, Any], seed: int, rank: int = 0) -> Iterator[Dict]:
    """The endless stream of rank ``rank``'s graphs: sizes from the
    traffic's fixed size seed, contents from the run's seed."""
    gen = spec.generator(traffic["generator"])
    size_rng = np.random.RandomState(int(traffic["size_seed"]) + rank)
    rng = np.random.RandomState(sub_seed(seed, SALT_GRAPHS, rank))
    return gen.generate(size_rng, rng, **traffic["params"])


def metadata_graphs(traffic: Dict[str, Any], seed: int) -> List[Dict]:
    """The graphs every rank computes metadata (vocabularies, edge types)
    from: the first of rank 0's stream."""
    stream = graph_stream(traffic, seed, 0)
    return [next(stream) for _ in range(int(traffic["metadata_graphs"]))]


@dataclass
class Group:
    graphs: List[Dict]
    nodes: int
    edges: int  # materialized real edges: forward, backward and self
    references: Dict[str, int] = field(default_factory=dict)

    @property
    def weight(self) -> float:
        return float(len(self.graphs))


def _ceil(n: int, m: int) -> int:
    return int(math.ceil(n / m)) * m


class Packer:
    """The greedy fill of one configuration's padding."""

    def __init__(self, config: Dict[str, Any], num_types: int):
        p = config["padding"]
        self.p = p
        self.num_types = num_types
        self.tile = p["edge_tile"]
        s = p["agg_sum_tile"]
        self.align = s if s and s % self.tile == 0 and p["max_edge_slots"] % s == 0 else self.tile
        self.num_blocks = -(-p["max_nodes"] // p["agg_rows"])

    def budget(self, name: str) -> int:
        return int(self.p["reference_budgets"].get(name, self.p["default_reference_budget"]))

    def slots(self, seg: Dict[Tuple[int, int], int]) -> int:
        per_block: Dict[int, int] = {}
        for (b, _), c in seg.items():
            per_block[b] = per_block.get(b, 0) + _ceil(c, self.tile)
        used = sum(_ceil(s, self.align) for s in per_block.values())
        return used + self.align * (self.num_blocks - len(per_block))

    def segments(self, receivers: np.ndarray, types: np.ndarray, offset: int) -> Dict[Tuple[int, int], int]:
        if not len(receivers):
            return {}
        keys = ((receivers + offset) // self.p["agg_rows"]).astype(np.int64) * (self.num_types + 1) + types
        uniq, cnt = np.unique(keys, return_counts=True)
        return {divmod(int(k), self.num_types + 1): int(c) for k, c in zip(uniq, cnt)}

    def groups(self, stream: Iterator[Dict], layout, count: int) -> List[Group]:
        """``count`` minibatches from ``stream``; ``layout(graph)`` gives a
        graph's (nodes, receivers, types, reference counts) of its
        materialized edges."""
        out: List[Group] = []
        cur: List[Tuple[Dict, Tuple]] = []
        seg: Dict[Tuple[int, int], int] = {}
        nodes, refs = 0, {}

        def close():
            nonlocal cur, seg, nodes, refs
            out.append(Group([g for g, _ in cur], nodes, sum(len(lay[1]) for _, lay in cur), dict(refs)))
            cur, seg, nodes, refs = [], {}, 0, {}

        while len(out) < count:
            graph = next(stream)
            lay = layout(graph)
            n, receivers, types, grefs = lay
            if n > self.p["max_nodes"]:
                continue  # the program drops it too
            for attempt in range(2):
                delta = self.segments(receivers, types, nodes)
                merged = dict(seg)
                for k, c in delta.items():
                    merged[k] = merged.get(k, 0) + c
                fits = (len(cur) + 1 <= self.p["max_graphs"] and nodes + n <= self.p["max_nodes"]
                        and self.slots(merged) <= self.p["max_edge_slots"]
                        and all(refs.get(k, 0) + c <= self.budget(k) for k, c in grefs.items()))
                if fits:
                    break
                if not cur:
                    raise RuntimeError("a graph exceeds an empty minibatch's budgets")
                close()
            if not fits:
                raise RuntimeError("a graph exceeds an empty minibatch's budgets")
            cur.append((graph, lay))
            seg = merged
            nodes += n
            for k, c in grefs.items():
                refs[k] = refs.get(k, 0) + c
            if nodes >= min(self.p["max_nodes"], self.p["stop_extending_after_nodes"]):
                close()
        return out[:count]


def pool(config: Dict[str, Any], traffic: Dict[str, Any], task, seed: int, rank: int,
         type_names: Sequence[str], count: int) -> List[Group]:
    """Rank ``rank``'s first ``count`` minibatches of graphs."""
    index = {t: i for i, t in enumerate(type_names)}
    packer = Packer(config, task.num_edge_types(config, len(type_names)))
    return packer.groups(graph_stream(traffic, seed, rank), lambda g: task.layout(config, g, index), count)
