"""Plain reference of Graph2Seq with the GGNN encoder and the GRU copy
decoder: from raw CodeGraph2Seq graphs to the copy-marginalised loss.

Worked out from the graphs alone, by the published rules (microsoft/ptgnn
``graph2seq/graph2seq.py``, ``graph2seq/train.py``, ``gnn/messagepassing/
gatedmessagepassing.py``, ``sequence/grucopydecoder.py``,
``reduceops/varsizedsummary.py``; Fernandes et al., ICLR 2019): the
lowercased node-token vocabulary (most common first, count >= 5, at most
10,000 with UNK at id 0), the output vocabulary of the names' tokens (count
>= 5, at most 20,000: UNK, START and END first), the edge types (sorted
names) with their backward copies, the backbone memories and the copyable
positions. The forward: the token embedding and its dropout; the stack of
gated layers (sum of ``drop(h_u) W_t`` over in-edges, then a GRU cell), one
layer's weights at seven positions inside a mean residual, a fresh layer
after it; the 8-head self-attention summary of each graph's [input | output]
rows (the per-graph max as the query) as the decoder's first state; the
teacher-forced GRU decoder with Luong and copy attention over the graph's
memories, the vocabulary scores through the tied embedding, and the negative
log of the joint vocabulary-or-copy probability of each target token.

Where this departs from the published description, as the program does:

- message dropout is keyed: the keep mask of edge (u -> v, t) and column c
  is a uint32 hash of (u, v, t), of c and of a seed that each layer
  position draws from the step's generator, in place of the published
  ``nn.Dropout`` on the gathered states. The hash here is this file's own
  copy (16-bit partial products), and must equal the program's bit for bit.
- the other dropouts draw, in the program's order, one uniform block a
  call from the step's generator at the padded minibatch's shape: the
  embedder's [nodes, 128], the decoder's token embeddings [graphs, 7, 256],
  its copy projections [memories, 128], its attention vectors [graphs, 7,
  128] and its output embedding table [vocabulary, 256]; the real rows are
  used.
- each name is scored over its steps t < its length (START and END
  counted), so a name shorter than 8 also scores one step past END, which
  predicts id 0; UNK is a correct generation only where nothing can be
  copied.
- the metadata pass counts each metadata graph, then the names of its
  ``corpus_names`` (``tasks/graph2seq.py``).

It imports nothing of the program; float32 with TF32 off
(``correctness.reference_readings`` runs it under
``common.exact_float32``); every matrix product goes through ``common.mm``
so that a control runs one precision down.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from .common import flatten_edges, linear, mm

UNK, START, END = "%UNK%", "%START%", "%END%"
U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The keyed message-dropout hash
# ---------------------------------------------------------------------------
def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 x in [0, 2**32): the sum of the 16-bit
    halves' partial products, none of which overflows."""
    x_lo, x_hi = x & 0xFFFF, x >> 16
    c_lo, c_hi = c & 0xFFFF, c >> 16
    cross = (x_hi * c_lo + x_lo * c_hi) & 0xFFFF
    return (x_lo * c_lo + (cross << 16)) & U32


def avalanche(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def edge_key(src: torch.Tensor, dst: torch.Tensor, etype: torch.Tensor) -> torch.Tensor:
    """The uint32 key (in int64) of each directed typed edge (u -> v, t)."""
    u, v, t = (a.long() & U32 for a in (src, dst, etype))
    return avalanche(avalanche(mul_u32(u, 2654435761)) ^ avalanche(mul_u32(v, 2246822519))
                     ^ avalanche(mul_u32(t, 3266489917)))


def keep_mask(seed: torch.Tensor, key: torch.Tensor, num_cols: int, rate: float, col_offset: int = 0) -> torch.Tensor:
    """[E, num_cols] True where edge e keeps column ``col_offset + c``."""
    col = col_offset + torch.arange(num_cols, dtype=torch.int64, device=key.device)
    h = avalanche(((key[:, None] ^ seed) + mul_u32(col, 0x9E3779B9)[None, :]) & U32)
    return h >= int(rate * U32)


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------
def _vocabulary(counter: Counter, max_size: int, threshold: int) -> Dict[str, int]:
    vocab = {UNK: 0}
    for token, count in counter.most_common(max_size - 1):
        if count >= threshold and token not in vocab:
            vocab[token] = len(vocab)
    return vocab


class Context:
    """What the reference derives from the metadata graphs."""

    def __init__(self, config: Dict[str, Any], meta_graphs: Sequence[Dict]):
        self.config = config
        labels: Counter = Counter()
        names: Counter = Counter()
        edge_types = set()
        for g in meta_graphs:
            labels.update(label.lower() for label in g["node_labels"])
            edge_types.update(g["edges"])
            names.update(g["method_name"])
            for name in g.get("corpus_names", ()):
                names.update(name)
        names[START] = names[END] = 1_000_000
        emb, dec = config["embedder"], config["decoder"]
        self.vocab = _vocabulary(labels, emb["vocabulary_size"], emb["min_freq_threshold"])
        self.out_vocab = _vocabulary(names, dec["vocabulary_size"], dec["min_freq_threshold"])
        self.edge_types = sorted(edge_types)


class Batch:
    """One minibatch's real rows: nodes numbered graph after graph, the
    materialized edges with their types and keys, the memories (each graph's
    backbone in order) and the targets."""

    def __init__(self, ctx: Context, graphs: Sequence[Dict], device: torch.device):
        cfg = ctx.config
        seq = cfg["decoder"]["max_seq_len"]
        per_graph, token_ids, node_graph, memories, origin, targets, lengths, copies = [], [], [], [], [], [], [], []
        offset = 0
        for b, g in enumerate(graphs):
            labels = [label.lower() for label in g["node_labels"]]
            n = len(labels)
            token_ids.extend(ctx.vocab.get(label, 0) for label in labels)
            node_graph.extend([b] * n)
            lists = []
            for et in ctx.edge_types:
                arr = np.asarray(g["edges"].get(et, []), np.int64).reshape(-1, 2)
                lists.append((arr[:, 0], arr[:, 1]))
            per_graph.append((n, lists))
            tokens = ([START] + list(g["method_name"]) + [END])[:seq]
            ids = [ctx.out_vocab.get(tok, 0) for tok in tokens]
            targets.append(ids + [0] * (seq - len(ids)))
            lengths.append(len(tokens))
            first = len(memories)
            backbone = list(g["backbone_sequence"])
            for t, tok in enumerate(tokens[1:]):
                copies.extend((first + j, t) for j, k in enumerate(backbone) if labels[k] == tok)
            memories.extend(offset + k for k in backbone)
            origin.extend([b] * len(backbone))
            offset += n
        self.num_nodes, self.edges = flatten_edges(per_graph, backward=cfg["backward_edges"],
                                                   self_edges=cfg["self_edges"], device=device)
        etype = torch.cat([torch.full((b - a,), t, dtype=torch.int64) for t, a, b in self.edges.runs]).to(device)
        self.keys = edge_key(self.edges.src, self.edges.dst, etype)
        self.num_graphs = len(graphs)
        self.token_ids = torch.tensor(token_ids, dtype=torch.int64, device=device)
        self.node_graph = torch.tensor(node_graph, dtype=torch.int64, device=device)
        self.memories = torch.tensor(memories, dtype=torch.int64, device=device)
        self.origin = torch.tensor(origin, dtype=torch.int64, device=device)
        self.targets = torch.tensor(targets, dtype=torch.int64, device=device)
        self.lengths = torch.tensor(lengths, dtype=torch.int64, device=device)
        self.copy = torch.zeros((len(memories), seq - 1), dtype=torch.bool, device=device)
        if copies:
            at = torch.tensor(copies, dtype=torch.int64, device=device)
            self.copy[at[:, 0], at[:, 1]] = True
        self.unk = ctx.out_vocab[UNK]


# ---------------------------------------------------------------------------
# Segment operations over sorted-free ids
# ---------------------------------------------------------------------------
def _segment_max(x: torch.Tensor, ids: torch.Tensor, count: int) -> torch.Tensor:
    index = ids.reshape(ids.shape + (1,) * (x.dim() - 1)).expand_as(x)
    return torch.zeros((count,) + x.shape[1:], dtype=x.dtype, device=x.device).scatter_reduce(
        0, index, x, "amax", include_self=False)


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, count: int) -> torch.Tensor:
    return torch.zeros((count,) + x.shape[1:], dtype=x.dtype, device=x.device).index_add(0, ids, x)


def segment_logsumexp(x: torch.Tensor, ids: torch.Tensor, count: int) -> torch.Tensor:
    """Per segment log(sum exp(x)): -inf for a segment of -inf entries only,
    with a zero gradient there."""
    shift = _segment_max(x.detach(), ids, count)
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    total = _segment_sum(torch.exp(x - shift[ids]), ids, count)
    some = total > 0
    return torch.where(some, torch.log(torch.where(some, total, torch.ones_like(total))),
                       torch.full_like(total, -math.inf)) + shift


def segment_log_softmax(x: torch.Tensor, ids: torch.Tensor, count: int) -> torch.Tensor:
    return x - segment_logsumexp(x, ids, count)[ids]


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
def _drop(x: torch.Tensor, rate: float, draw: torch.Tensor) -> torch.Tensor:
    """Inverted dropout by a Python-float keep rate: keep where the draw is
    below it."""
    keep = 1.0 - rate
    return torch.where(draw < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def gru_cell(x: torch.Tensor, h: torch.Tensor, params: Dict[str, torch.Tensor], prefix: str, fmt: str) -> torch.Tensor:
    gi = linear(x, params[f"{prefix}.weight_ih"], params[f"{prefix}.bias_ih"], fmt)
    gh = linear(h, params[f"{prefix}.weight_hh"], params[f"{prefix}.bias_hh"], fmt)
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gated_layer(h: torch.Tensor, batch: Batch, params: Dict[str, torch.Tensor], prefix: str, seed: torch.Tensor,
                rate: float, fmt: str) -> torch.Tensor:
    """sum over in-edges of drop(h_u) W_t, then the GRU update of h_v."""
    edges = batch.edges
    w = params[f"{prefix}.message_weights"]  # [T, D, M]
    keep = 1.0 - rate
    mask = keep_mask(seed, batch.keys, h.shape[1], 1.0 - keep)
    inp = torch.where(mask, h[edges.src] / torch.full((), keep, dtype=h.dtype, device=h.device),
                      torch.zeros((), dtype=h.dtype, device=h.device))
    msgs = torch.cat([mm(inp[a:b], w[t], fmt) for t, a, b in edges.runs], dim=0)
    return gru_cell(_segment_sum(msgs, edges.dst, h.shape[0]), h, params, f"{prefix}.state_update", fmt)


def summarize(rows: torch.Tensor, batch: Batch, params: Dict[str, torch.Tensor], heads: int, fmt: str) -> torch.Tensor:
    """Each graph's multi-head attention summary of its rows, the query its
    per-column max."""
    n, g = rows.shape[0], batch.num_graphs
    query = _segment_max(rows, batch.node_graph, g)[batch.node_graph].reshape(n, heads, -1)
    keys = linear(rows, params["summarizer.key.weight"], None, fmt).reshape(n, heads, -1)
    scores = (query * keys).sum(dim=-1) / math.sqrt(keys.shape[-1])  # [n, heads]
    probs = torch.exp(segment_log_softmax(scores, batch.node_graph, g))
    weighted = (probs[..., None] * rows[:, None, :]).reshape(n, -1)
    return linear(_segment_sum(weighted, batch.node_graph, g), params["summarizer.output.weight"], None, fmt)


def decoder_loss(memories: torch.Tensor, initial: torch.Tensor, batch: Batch, params: Dict[str, torch.Tensor],
                 cfg: Dict[str, Any], gen: torch.Generator, fmt: str, half: bool) -> torch.Tensor:
    dec, pad = cfg["decoder"], cfg["padding"]
    rate, dev = dec["dropout_rate"], memories.device
    b, m = batch.num_graphs, memories.shape[0]
    steps = batch.targets.shape[1] - 1
    origin = batch.origin
    table = params["decoder.embedding.weight"]  # [V, E]

    def draw(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    emb = _drop(table[batch.targets[:, :-1]], rate, draw(pad["max_graphs"], steps, table.shape[1])[:b])
    h, outs = initial, []
    for t in range(steps):
        h = gru_cell(emb[:, t], h, params, "decoder.gru", fmt)
        outs.append(h)
    out = torch.stack(outs, dim=1)  # [B, T, H]
    std = linear(memories, params["decoder.mem_to_std.weight"], None, fmt)
    copy = linear(memories, params["decoder.mem_to_copy.weight"], None, fmt)
    copy = _drop(copy, rate, draw(pad["reference_budgets"]["backbone_nodes"], copy.shape[1])[:m])
    per_memory = out[origin]  # [M, T, H]
    std_scores = (per_memory * std[:, None, :]).sum(dim=-1)  # [M, T]
    copy_scores = (per_memory * copy[:, None, :]).sum(dim=-1)
    attention = _segment_sum(torch.exp(segment_log_softmax(std_scores, origin, b))[..., None] * std[:, None, :],
                             origin, b)  # [B, T, H]
    attention = _drop(attention, rate, draw(pad["max_graphs"], steps, attention.shape[-1])[:b])
    table_drop = _drop(table, rate, draw(*table.shape))
    vocab_scores = mm(mm(torch.cat([attention, out], dim=-1), params["decoder.hidden_to_vocab"], fmt),
                      table_drop.t(), fmt) + params["decoder.vocab_bias"]  # [B, T, V]
    total_copy = segment_logsumexp(copy_scores, origin, b)  # [B, T]
    norm = torch.logsumexp(torch.cat([vocab_scores, total_copy[..., None]], dim=-1), dim=-1)
    vocab_lp = vocab_scores - norm[..., None]
    copy_lp = copy_scores - norm[origin]

    neg_inf = torch.full((), -math.inf, device=dev)
    targets = batch.targets[:, 1:]
    copyable = _segment_sum(batch.copy.float(), origin, b) > 0
    generated = vocab_lp.gather(-1, targets[..., None])[..., 0]
    generated = torch.where(copyable & (targets == batch.unk), neg_inf, generated)
    copied = segment_logsumexp(torch.where(batch.copy, copy_lp, neg_inf), origin, b)
    either = torch.logaddexp(generated, copied)  # [B, T]
    scored = torch.arange(steps, device=dev)[None, :] < batch.lengths[:, None]
    per_name = torch.where(scored, either, torch.zeros((), device=dev)).sum(dim=-1) / scored.sum(dim=-1).clamp_min(1)
    if half:
        per_name = per_name[: max(1, b // 2)]
    return -per_name.mean()


def loss(ctx: Context, batch: Batch, params: Dict[str, torch.Tensor], seed: int, fmt: str = "fp32",
         half: bool = False) -> torch.Tensor:
    """The minibatch's training loss with the dropout of generator seed
    ``seed``. ``half`` (a planted fault) averages over the first half of
    the names only."""
    cfg = ctx.config
    dev = batch.token_ids.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    width = cfg["hidden_state_size"]
    table = params["gnn.node_embedder.embeddings.weight"]
    draw = torch.rand((cfg["padding"]["max_nodes"], width), generator=gen, device=dev)[:batch.num_nodes]
    x = _drop(table[batch.token_ids], cfg["embedder"]["dropout_rate"], draw)
    h, stash, shared = x, {}, {}
    for i, entry in enumerate(cfg["stack"]):
        if entry[0] == "origin":
            stash[entry[1]] = h
        elif entry[0] == "mean":
            h = (stash.pop(entry[1]) + h) * 0.5
        elif entry[0] == "gated":
            seed_i = torch.randint(0, 2**32, (), generator=gen, device=dev)
            prefix = f"gnn.message_passing_layers.{shared.setdefault(entry[1], i)}"
            h = gated_layer(h, batch, params, prefix, seed_i, cfg["dropout_rate"], fmt)
        else:
            raise ValueError(f"stack entry {entry[0]!r} has no reference")
    initial = summarize(torch.cat([x, h], dim=-1), batch, params, cfg["summarizer"]["num_heads"], fmt)
    return decoder_loss(h[batch.memories], initial, batch, params, cfg, gen, fmt, half)
