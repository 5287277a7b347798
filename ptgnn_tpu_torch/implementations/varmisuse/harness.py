"""Build the VarMisuse model on synthetic VarMisuse samples and produce
finalized, statically shaped minibatches (for tests, ``chip_smoke.py`` and
the profiler). The step loop is ``implementations.typilus.harness.train_steps``,
which takes VarMisuse's ``{"batch", "correct_candidate_idxs"}`` minibatches
as they are."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ptgnn_tpu_torch.device import DeviceLike
from ptgnn_tpu_torch.graph.structs import BatchPadding
from ptgnn_tpu_torch.implementations.varmisuse.train import create_var_misuse_gnn_model
from ptgnn_tpu_torch.implementations.varmisuse.varmisuse import VarMisuseGraphModel, VarMisuseModel
from ptgnn_tpu_torch.utils.synthetic import synthetic_varmisuse_samples


def full_width_samples(
    num_samples: int, padding: BatchPadding, seed: int = 0
) -> Tuple[int, List[Dict[str, Any]], List[Tuple[int, float, int]]]:
    """Synthetic samples that fill ``padding``: ``mean_tokens`` rises from 40
    in steps of 10 until the first two batches hold at least 75 % of the
    node budget, or until one of them closes below it with room for more
    graphs (the edge slots bind first). Returns (mean_tokens, the samples,
    the tries as (mean_tokens, node fill, graphs of the first batch))."""
    probe_batches = 2
    tries = []
    mean_tokens = 40
    while True:
        samples = list(synthetic_varmisuse_samples(num_samples, seed=seed, mean_tokens=mean_tokens))
        model = create_var_misuse_gnn_model(hidden_state_size=8, padding=padding)
        model.compute_metadata(iter(samples[:probe_batches * padding.max_graphs]), parallelize=False)
        batches = []
        for mb, _ in model.minibatch_iterator(
            model.tensorize_dataset(iter(samples), parallelize=False),
            max_minibatch_size=padding.max_graphs, parallelize=False,
        ):
            batches.append(mb["batch"])
            if len(batches) == probe_batches:
                break
        fill = min(int(b.num_nodes) for b in batches) / padding.max_nodes
        tries.append((mean_tokens, fill, int(batches[0].num_graphs)))
        edges_bind = any(int(b.num_graphs) < padding.max_graphs for b in batches)
        if fill >= 0.75 or edges_bind:
            return mean_tokens, samples, tries
        mean_tokens += 10


def build_varmisuse(
    *,
    padding: BatchPadding,
    samples: List[Dict[str, Any]],
    hidden_state_size: int = 64,
    architecture: str = "mlp",
    seed: int = 0,
    minibatch_size: int = 300,
    device: DeviceLike = None,
) -> Tuple[VarMisuseModel, VarMisuseGraphModel, List[Dict[str, Any]]]:
    """Returns (model with metadata from ``samples``, module on ``device``
    with seeded weights, the host minibatches of ``samples``)."""
    model = create_var_misuse_gnn_model(
        hidden_state_size=hidden_state_size, padding=padding, architecture=architecture
    )
    model.compute_metadata(iter(samples), parallelize=False)
    module = model.build_neural_module(device=device, seed=seed)
    minibatches = [
        mb for mb, _ in model.minibatch_iterator(
            model.tensorize_dataset(iter(samples), parallelize=False),
            max_minibatch_size=minibatch_size, parallelize=False,
        )
    ]
    if not minibatches:
        raise RuntimeError("the samples produced no minibatches")
    return model, module, minibatches
