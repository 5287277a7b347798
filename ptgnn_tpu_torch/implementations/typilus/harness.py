"""Build the Graph2Class model on synthetic Typilus-schema data, produce
finalized, statically shaped minibatches, and time the training step over
device-resident minibatches as ``bench.py`` times the JAX package's (the
step loop serves any task module: PPI's too).

Besides the CLI's 'mlp' and 'ggnn' stacks, ``architecture="layers"``
builds :class:`LayersStackCreator`'s stack of the library's other
message-passing families, and ``architecture="linear-residual"``
:class:`LinearResidualStackCreator`'s (for the smoke run, the tests and the
profiler; they are no CLI options)."""
from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch

from ptgnn_tpu_torch.core.trainer import TrainStep
from ptgnn_tpu_torch.device import DeviceLike
from ptgnn_tpu_torch.graph.messagepassing import (
    EGCMessagePassingLayer,
    GraphNorm,
    LinearResidualLayer,
    MlpMessagePassingLayer,
    MultiHeadSelfAttentionMessagePassing,
    PnaMessageAggregation,
)
from ptgnn_tpu_torch.graph.structs import BatchPadding
from ptgnn_tpu_torch.implementations.typilus.graph2class import Graph2Class, Graph2ClassModule
from ptgnn_tpu_torch.implementations.typilus.train import (
    MlpStackCreator,
    create_graph2class_gnn_model,
    graph2class_model,
)
from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs


def small_padding(max_nodes: int = 512, max_graphs: int = 16) -> BatchPadding:
    return BatchPadding(
        max_nodes=max_nodes,
        max_edge_slots=max_nodes * 12,
        max_graphs=max_graphs,
        edge_tile=64,
        reference_budgets=(
            ("supernodes", max(64, max_nodes // 8)),
            ("token-sequence", max_nodes),
        ),
    )


def bench_graph_count(num_batches: int, max_nodes: int = 8192) -> int:
    """Synthetic graphs (mean 2500 nodes) that fill ``num_batches`` batches of
    the benchmark configuration (``train.default_padding()``)."""
    return max(32, 2 * num_batches * (max_nodes // 2500 + 1))


class LayersStackCreator:
    """Seven positions over the library's message-passing families at state
    ``hidden_state_size`` (h): an MLP-MP layer with one hidden layer and PNA
    aggregation (per-slot route), GraphNorm, EGC with max aggregation (4
    bases, 8 heads; fused route), block self-attention over the batch's
    ``att_order``, an MLP-MP layer with a [2h] hidden layer, mean
    aggregation and no target state (per-slot route), self-attention among
    the supernodes, and the benchmark's MLP-MP layer with max aggregation
    (fused route). Attention uses 4 heads of key and value width h / 4 and
    an FFN of 2h. A class, not a closure, so a model that holds it pickles
    into a checkpoint."""

    def __init__(self, hidden_state_size: int, dropout_rate: float):
        self.hidden_state_size = hidden_state_size
        self.dropout_rate = dropout_rate

    def _attention(self, **kw) -> MultiHeadSelfAttentionMessagePassing:
        h = self.hidden_state_size
        return MultiHeadSelfAttentionMessagePassing(
            h, h // 4, h // 4, h, 2 * h, num_heads=4, dropout_rate=self.dropout_rate, **kw
        )

    def __call__(self, num_edges: int):
        h, rate = self.hidden_state_size, self.dropout_rate
        return [
            MlpMessagePassingLayer(h, h, h, num_edges, PnaMessageAggregation(), mlp_hidden_layers=1,
                                   dropout_rate=rate),
            GraphNorm(h),
            EGCMessagePassingLayer(h, h, num_edges, "max", num_bases=4, num_heads=8, dropout_rate=rate),
            self._attention(),
            MlpMessagePassingLayer(h, h, h, num_edges, "mean", use_target_state_as_message_input=False,
                                   mlp_hidden_layers=[2 * h], dropout_rate=rate),
            self._attention(target_reference="supernodes"),
            MlpMessagePassingLayer(h, h, h, num_edges, "max", dropout_rate=rate),
        ]


class LinearResidualStackCreator(MlpStackCreator):
    """The benchmark 'mlp' stack with each of its two concat residuals
    replaced by a :class:`LinearResidualLayer` (the stashed and the current
    h-wide states to 2h, bias-free, then dropout), so every position keeps
    the benchmark's widths."""

    def __call__(self, num_edges: int):
        h = self.hidden_state_size
        r1 = LinearResidualLayer(h, h, 2 * h, self.dropout_rate)
        r2 = LinearResidualLayer(h, h, 2 * h, self.dropout_rate)
        return [
            r1.pass_through_dummy_layer(),
            self._mlp_mp(num_edges, h, h), self._mlp_mp(num_edges, h, h), self._mlp_mp(num_edges, h, h),
            r1,
            self._mlp_mp(num_edges, 2 * h, 2 * h),
            r2.pass_through_dummy_layer(),
            self._mlp_mp(num_edges, h, h), self._mlp_mp(num_edges, h, h), self._mlp_mp(num_edges, h, h),
            r2,
            self._mlp_mp(num_edges, 2 * h, 2 * h),
        ]


_HARNESS_STACKS = {"layers": LayersStackCreator, "linear-residual": LinearResidualStackCreator}


def build_graph2class(
    *,
    padding: BatchPadding,
    num_metadata_graphs: int = 48,
    mean_nodes: int = 60,
    max_graph_nodes: int = 200,
    hidden_state_size: int = 64,
    seed: int = 0,
    num_minibatches: int = 1,
    minibatch_size: int = 16,
    architecture: str = "mlp",
    dropout_rate: float = 0.1,
    topology: str = "random",
    argmax_routing: bool = False,
    device: DeviceLike = None,
) -> Tuple[Graph2Class, Graph2ClassModule, List[Dict[str, Any]]]:
    """Returns (model, module on ``device`` with seeded weights, host
    minibatches). ``architecture``: 'mlp', 'ggnn', 'layers'
    (:class:`LayersStackCreator`) or 'linear-residual'
    (:class:`LinearResidualStackCreator`); ``argmax_routing``: single-winner
    gradients of the max aggregation (the fused routes of 'mlp' and
    'ggnn'). Edge dropout is the module's ``gnn.edge_dropout_rate``."""
    if architecture in _HARNESS_STACKS:
        model = graph2class_model(
            _HARNESS_STACKS[architecture](hidden_state_size, dropout_rate), hidden_state_size=hidden_state_size,
            dropout_rate=dropout_rate, padding=padding,
        )
    else:
        model = create_graph2class_gnn_model(
            hidden_state_size=hidden_state_size, padding=padding,
            architecture=architecture, dropout_rate=dropout_rate, argmax_routing=argmax_routing,
        )

    def data():
        return synthetic_typilus_graphs(
            num_metadata_graphs, seed=seed, mean_nodes=mean_nodes,
            max_nodes=max_graph_nodes, topology=topology,
        )

    model.compute_metadata(data(), parallelize=False)
    module = model.build_neural_module(device=device, seed=seed)

    minibatches: List[Dict[str, Any]] = []
    for mb, _ in model.minibatch_iterator(
        model.tensorize_dataset(data(), parallelize=False),
        max_minibatch_size=minibatch_size,
        parallelize=False,
    ):
        minibatches.append(mb)
        if len(minibatches) >= num_minibatches:
            break
    if not minibatches:
        raise RuntimeError("synthetic data produced no minibatches")
    while len(minibatches) < num_minibatches:
        minibatches.append(minibatches[len(minibatches) % len(minibatches)])
    return model, module, minibatches


def train_steps(
    module: torch.nn.Module,
    minibatches: Sequence[Mapping[str, Any]],
    *,
    steps: int,
    enable_amp: bool = False,
    learning_rate: float = 2.5e-4,
    clip_gradient_norm: float = 1.0,
    seed: int = 0,
) -> Dict[str, Any]:
    """``bench.py``'s train-step loop over device-resident minibatches, each
    the keyword arguments of ``module`` (Graph2Class: ``{"batch",
    "target_classes"}``; PPI: ``{"batch", "targets"}``): the trainer's
    compiled step (:class:`TrainStep`: clip(1.0) + Adam(``learning_rate``)),
    one warm-up step on the first minibatch, then ``steps`` timed steps
    cycling over them, the last of which waits for the device. Updates
    ``module`` in place. Returns the last loss, ms per step, graphs, nodes
    and edges per second, and the compiled step's capture costs
    (``captures``: a ``CaptureStats`` per batch signature)."""
    step = TrainStep(module, torch.optim.Adam(module.parameters(), lr=learning_rate),
                     clip_gradient_norm=clip_gradient_norm, amp=enable_amp)
    device = step.device
    # Host-side sizes: reading them from the device inside the loop would
    # synchronise every step.
    sizes = [
        (int(mb["batch"].num_graphs), int(mb["batch"].num_nodes), int(mb["batch"].num_edges))
        for mb in minibatches
    ]

    def run(i: int) -> torch.Tensor:
        step.generator.manual_seed(seed * 1_000_003 + i)
        return step.step(dict(minibatches[i % len(minibatches)]))[0]

    run(0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    totals = [0, 0, 0]
    t0 = time.perf_counter()
    for i in range(steps):
        loss = run(i)
        for k, v in enumerate(sizes[i % len(sizes)]):
            totals[k] += v
    final_loss = float(loss)  # waits for the last step
    elapsed = time.perf_counter() - t0
    return {
        "loss": final_loss,
        "ms_per_step": 1e3 * elapsed / steps,
        "graphs_per_s": totals[0] / elapsed,
        "nodes_per_s": totals[1] / elapsed,
        "edges_per_s": totals[2] / elapsed,
        "captures": step.train_step.stats(),
    }
