"""Build the Graph2Class model on synthetic Typilus-schema data, produce
finalized, statically shaped minibatches, and time the training step over
device-resident minibatches as ``bench.py`` times the JAX package's (the
step loop serves any task module: PPI's too)."""
from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch

from ptgnn_tpu_torch.core.trainer import module_loss, optimizer_step
from ptgnn_tpu_torch.device import DeviceLike
from ptgnn_tpu_torch.graph.structs import BatchPadding
from ptgnn_tpu_torch.implementations.typilus.graph2class import Graph2Class, Graph2ClassModule
from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model
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
    minibatches). ``architecture``: 'mlp' or 'ggnn'; ``argmax_routing``:
    single-winner gradients of the max aggregation."""
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
) -> Dict[str, float]:
    """``bench.py``'s train-step loop over device-resident minibatches, each
    the keyword arguments of ``module`` (Graph2Class: ``{"batch",
    "target_classes"}``; PPI: ``{"batch", "targets"}``): clip(1.0) +
    Adam(``learning_rate``), one warm-up step on the first minibatch, then
    ``steps`` timed steps cycling over them, the last of which waits for the
    device. Updates ``module`` in place. Returns the last loss, ms per step,
    and graphs, nodes and edges per second."""
    optimizer = torch.optim.Adam(module.parameters(), lr=learning_rate)
    base_lrs = [group["lr"] for group in optimizer.param_groups]
    device = next(module.parameters()).device
    generator = torch.Generator(device=device)
    # Host-side sizes: reading them from the device inside the loop would
    # synchronise every step.
    sizes = [
        (int(mb["batch"].num_graphs), int(mb["batch"].num_nodes), int(mb["batch"].num_edges))
        for mb in minibatches
    ]

    def step(i: int) -> torch.Tensor:
        generator.manual_seed(seed * 1_000_003 + i)
        loss, _ = module_loss(
            module, dict(minibatches[i % len(minibatches)]), train=True,
            generator=generator, amp=enable_amp,
        )
        loss.backward()
        optimizer_step(module, optimizer, base_lrs, clip_gradient_norm=clip_gradient_norm)
        return loss

    step(0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    totals = [0, 0, 0]
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step(i)
        for k, v in enumerate(sizes[i % len(sizes)]):
            totals[k] += v
    final_loss = float(loss.detach())  # waits for the last step
    elapsed = time.perf_counter() - t0
    return {
        "loss": final_loss,
        "ms_per_step": 1e3 * elapsed / steps,
        "graphs_per_s": totals[0] / elapsed,
        "nodes_per_s": totals[1] / elapsed,
        "edges_per_s": totals[2] / elapsed,
    }
