"""Plain reference of Graph2Class (Typilus) with the MLP stack: from raw
Typilus-schema graphs to the supernode classification loss.

Worked out from the graphs alone, by the published rules
(microsoft/ptgnn ``typilus/graph2class.py``, ``graph/gnn.py``, dpu-utils'
vocabulary and identifier splitting): the subtoken vocabulary (most common
first, count >= 5, at most 10,000 with UNK at id 0), the class vocabulary
(at most 100 classes and UNK, count >= 5; an unknown generic falls back to
its base name), the edge types (sorted names), the flattened layout with
backward and self edges, and the labelled supernodes. The forward: the
subtoken embedding's masked mean, a bias-free dense layer, dropout, the
stack, then a linear head on the supernodes and the mean cross-entropy.
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from .common import dropout, dropout_draws, flatten_edges, linear, run_stack

IGNORED_TYPES = {
    "typing.Any", "Any", "", "typing.NoReturn", "NoReturn", "nothing", "None",
    "T", "_T", "_T0", "_T1", "_T2", "_T3", "_T4", "_T5", "_T6", "_T7",
}
UNK = "%UNK%"
_CAMEL = re.compile(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])|(?<=[A-Za-z])(?=[0-9])|(?<=[0-9])(?=[A-Za-z])")


def split_identifier(identifier: str) -> List[str]:
    """snake_case, camelCase, PascalCase, digit and ALLCAPS runs, lowercased."""
    parts = []
    for chunk in re.split(r"[_\W]+", identifier):
        for sub in _CAMEL.split(chunk) if chunk else ():
            if sub:
                parts.append(sub.lower())
    return parts


def _vocabulary(counter: Counter, max_size: int, threshold: int) -> Dict[str, int]:
    vocab = {UNK: 0}
    for token, count in counter.most_common(max_size - 1):
        if count >= threshold and token not in vocab:
            vocab[token] = len(vocab)
    return vocab


def _labelled(graph: Dict) -> List[tuple]:
    return [(int(idx), info.get("annotation")) for idx, info in graph["supernodes"].items()
            if info.get("annotation") not in IGNORED_TYPES and info.get("annotation") is not None]


class Context:
    """What the reference derives from the metadata graphs."""

    def __init__(self, config: Dict[str, Any], meta_graphs: Sequence[Dict]):
        self.config = config
        emb = config["embedder"]
        subtokens: Counter = Counter()
        classes: Counter = Counter()
        edge_types = set()
        for g in meta_graphs:
            for label in g["nodes"]:
                subtokens.update(split_identifier(label))
            edge_types.update(g["edges"])
            classes.update(label for _, label in _labelled(g))
        self.vocab = _vocabulary(subtokens, emb["vocabulary_size"], emb["min_freq_threshold"])
        self.classes = _vocabulary(classes, config["head"]["max_num_classes"] + 1, 5)
        self.edge_types = sorted(edge_types)

    def class_id(self, label: str) -> int:
        if label not in self.classes and "[" in label:
            label = label[: label.find("[")]
        return self.classes.get(label, 0)


class Batch:
    def __init__(self, ctx: Context, graphs: Sequence[Dict], device: torch.device):
        width = ctx.config["embedder"]["max_num_subtokens"]
        per_graph, ids, lengths, super_ids, targets = [], [], [], [], []
        offset = 0
        for g in graphs:
            for label in g["nodes"]:
                sub = [ctx.vocab.get(s, 0) for s in split_identifier(label)] or [0]
                sub = sub[:width]
                ids.append(sub + [0] * (width - len(sub)))
                lengths.append(len(sub))
            lists = []
            for et in ctx.edge_types:
                pairs = [(int(s), d) for s, dsts in g["edges"].get(et, {}).items() for d in dsts]
                arr = np.asarray(pairs, np.int64).reshape(-1, 2)
                lists.append((arr[:, 0], arr[:, 1]))
            per_graph.append((len(g["nodes"]), lists))
            for idx, label in _labelled(g):
                super_ids.append(offset + idx)
                targets.append(ctx.class_id(label))
            offset += len(g["nodes"])
        self.num_nodes, self.edges = flatten_edges(per_graph, backward=ctx.config["backward_edges"],
                                                   self_edges=ctx.config["self_edges"], device=device)
        self.token_ids = torch.tensor(ids, dtype=torch.int64, device=device)
        self.lengths = torch.tensor(lengths, dtype=torch.float32, device=device)
        self.supernodes = torch.tensor(super_ids, dtype=torch.int64, device=device)
        self.targets = torch.tensor(targets, dtype=torch.int64, device=device)
        self.padded_rows = ctx.config["padding"]["max_nodes"]


def loss(ctx: Context, batch: Batch, params: Dict[str, torch.Tensor], seed: int, fmt: str = "fp32",
         half: bool = False) -> torch.Tensor:
    """The minibatch's training loss with the dropout of generator seed
    ``seed``. ``half`` (a planted fault) averages over the first half of the
    supernodes only."""
    config = ctx.config
    device = batch.token_ids.device
    draw = dropout_draws(seed, batch.num_nodes, batch.padded_rows, device)
    table = params["gnn.node_embedder.embeddings.weight"]
    width = batch.token_ids.shape[1]
    valid = (torch.arange(width, device=device)[None, :] < batch.lengths[:, None]).float()
    summed = (table[batch.token_ids] * valid[..., None]).sum(dim=1)
    x = summed / (batch.lengths[:, None] + 1e-10)
    x = linear(x, params["gnn.node_embedder.out_layer.weight"], None, fmt)
    x = dropout(x, config["embedder"]["dropout_rate"], draw)
    x = run_stack(x, batch.edges, params, config, draw, fmt)
    logits = linear(x[batch.supernodes], params["node_to_class.weight"], params["node_to_class.bias"], fmt)
    nll = -torch.log_softmax(logits, dim=-1).gather(1, batch.targets[:, None])[:, 0]
    if half:
        nll = nll[: max(1, nll.shape[0] // 2)]
    return nll.mean()
