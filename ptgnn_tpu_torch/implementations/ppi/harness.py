"""Build the PPI model on synthetic PPI-like graphs and produce finalized,
statically shaped minibatches (for tests, ``chip_smoke.py`` and the
profiler). The step loop is ``implementations.typilus.harness.train_steps``."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ptgnn_tpu_torch.device import DeviceLike
from ptgnn_tpu_torch.graph.structs import BatchPadding
from ptgnn_tpu_torch.implementations.ppi.dataloader import PPIGraphSample
from ptgnn_tpu_torch.implementations.ppi.ppi import PPIClassification, PPIMulticlassClassification
from ptgnn_tpu_torch.implementations.ppi.train import create_ppi_gnn_model
from ptgnn_tpu_torch.utils.synthetic import synthetic_ppi_graphs

# The published PPI dataset's sizes: 50 features, 121 labels, about 2,372
# nodes and 34k edges (14.4 per node) per graph.
PPI_GRAPH_SIZES = dict(mean_nodes=2372, edges_per_node=14.4, num_features=50, num_labels=121)


def synthetic_ppi_samples(num_graphs: int, seed: int = 0, **sizes) -> List[PPIGraphSample]:
    """``synthetic_ppi_graphs(num_graphs, seed, **sizes)`` as samples."""
    return [PPIGraphSample.from_synthetic(g) for g in synthetic_ppi_graphs(num_graphs, seed=seed, **sizes)]


def build_ppi(
    *,
    padding: BatchPadding,
    samples: List[PPIGraphSample],
    hidden_state_size: int = 256,
    seed: int = 0,
    minibatch_size: int = 50,
    device: DeviceLike = None,
) -> Tuple[PPIMulticlassClassification, PPIClassification, List[Dict[str, Any]]]:
    """Returns (model with metadata from ``samples``, module on ``device``
    with seeded weights, the host minibatches of ``samples``)."""
    model = create_ppi_gnn_model(hidden_state_size=hidden_state_size, padding=padding)
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
