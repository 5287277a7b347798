"""The whole train step's share of the card's peak: the model's FLOPs of
every step in the traced window over the window's time and the peak of the
configuration's precision (a card's; the ranks' mean).

The FLOPs are counted from each minibatch's real nodes and materialized
edges, not its padding: per MLP message-passing layer the typed message
product on the [source, target] states of every edge and the dense update of
every node; the embedder's product; the head's product on the rows it
reads. A backward costs twice its forward, so the step is three forwards.
Recomputation is not counted."""
from gnnbench.harness import peaks

COMBINE = "mean"


def forward_flops(config, group, shapes) -> float:
    h = config["hidden_state_size"]
    n, e = group.nodes, group.edges
    emb = config["embedder"]
    if emb["kind"] == "subtoken":
        flops = 2.0 * n * h * h if emb.get("dense_output", True) else 0.0
    else:
        flops = 2.0 * n * emb["num_features"] * h
    layer = config["mlp_mp"]
    for entry in config["stack"]:
        if entry[0] == "mlp_mp":
            d_in, m = entry[1], entry[2]
            width = 2 * d_in if layer["target_state_input"] else d_in
            flops += 2.0 * e * width * m + 2.0 * n * m * h
    head = config["head"]
    rows = group.references.get("supernodes", 0) if head["kind"] == "supernode_classes" else n
    flops += 2.0 * rows * h * shapes[head["param"]][0]
    return flops


def read(run):
    if not run.steps or run.trace.window_s <= 0:
        return None
    flops = sum(3.0 * forward_flops(run.config, g, run.shapes) for g in run.groups)
    return 100.0 * flops / (run.trace.window_s * peaks.flops_per_s(run.config))
