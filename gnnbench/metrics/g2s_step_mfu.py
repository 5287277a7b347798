"""The whole Graph2Seq train step's share of the card's peak: the model's
FLOPs of every step in the traced window over the window's time and the
peak of the configuration's precision (float32 outside the tensor cores).

The FLOPs are counted from each minibatch's real nodes n, materialized
edges e (forward and backward), memories m and target sequences B, never
its padding, with T = max_seq_len - 1 teacher-forced steps a sequence:

* each gated position: the typed message product 2 e D M and the GRU cell
  2 n 3D (M + D);
* the embedder: a table lookup, no arithmetic;
* the summariser over the [input | output] rows (width R = 2D, h heads):
  the key projection 2 n R R, the scores 2 n R, the weighted sums 2 n h R
  and the output projection 2 B h R D;
* the decoder (hidden H, token embedding E, vocabulary V): the two memory
  projections 2 x 2 m D H, the GRU over B T tokens 2 B T 3H (E + H), both
  attentions' scores 2 x 2 m T H and the attention's weighted sum
  2 m T H, and the vocabulary product 2 B T (2H E + E V).

A backward costs twice its forward, so the step is three forwards.
Recomputation is not counted."""
from gnnbench.harness import peaks

COMBINE = "mean"


def forward_flops(config, group, shapes) -> float:
    d = config["hidden_state_size"]
    m_dim = config["gated"]["message_dimension"]
    dec = config["decoder"]
    h, e_dim, steps = dec["hidden_size"], dec["embedding_size"], dec["max_seq_len"] - 1
    vocab = shapes["decoder.embedding.weight"][0]
    heads = config["summarizer"]["num_heads"]
    n, e = group.nodes, group.edges
    m = group.references.get("backbone_nodes", 0)
    b = group.references.get("target_sequences", 0)
    positions = sum(1 for entry in config["stack"] if entry[0] == "gated")
    flops = positions * (2.0 * e * d * m_dim + 2.0 * n * 3 * d * (m_dim + d))
    r = 2 * d
    flops += 2.0 * n * r * r + 2.0 * n * r + 2.0 * n * heads * r + 2.0 * b * heads * r * d
    flops += 4.0 * m * d * h + 2.0 * b * steps * 3 * h * (e_dim + h) + 6.0 * m * steps * h
    flops += 2.0 * b * steps * (2 * h * e_dim + e_dim * vocab)
    return flops


def read(run):
    if not run.steps or run.trace.window_s <= 0 or "decoder.embedding.weight" not in run.shapes:
        return None
    flops = sum(3.0 * forward_flops(run.config, g, run.shapes) for g in run.groups)
    return 100.0 * flops / (run.trace.window_s * peaks.flops_per_s(run.config))
