"""Build Graph2Seq on synthetic CodeGraph2Seq samples and produce finalized,
statically shaped minibatches (for tests, ``chip_smoke.py`` and the
profiler). The step loop is ``implementations.typilus.harness.train_steps``,
which takes Graph2Seq's ``{"batch", "target_token_ids", "target_lengths",
"copy_matrix"}`` minibatches as they are."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ptgnn_tpu_torch.device import DeviceLike
from ptgnn_tpu_torch.graph.structs import BatchPadding
from ptgnn_tpu_torch.implementations.graph2seq.graph2seq import Graph2Seq, Graph2SeqModule
from ptgnn_tpu_torch.implementations.graph2seq.train import create_graph2seq_model
from ptgnn_tpu_torch.sequence.grucopydecoder import DecoderData, GruCopyingDecoderModel
from ptgnn_tpu_torch.utils.synthetic import synthetic_graph2seq_samples


def batch_sizes(minibatches: List[Dict[str, Any]]) -> List[Tuple[int, int, int, int]]:
    """(graphs, nodes, materialized edges, memories) of each minibatch."""
    return [
        (int(mb["batch"].num_graphs), int(mb["batch"].num_nodes), int(mb["batch"].num_edges),
         int(np.asarray(mb["batch"].references["backbone_nodes"].mask).sum()))
        for mb in minibatches
    ]


def full_width_samples(
    num_samples: int, padding: BatchPadding, seed: int = 0
) -> Tuple[int, List[Dict[str, Any]], List[Tuple[int, float, int]]]:
    """Synthetic samples that fill ``padding``: ``mean_nodes`` rises from 60
    in steps of 10, with the generator's ``max_nodes`` clip at 2.5 times it
    (its default ratio), until the first two batches hold at least 75 % of
    the node budget, or until one of them closes below it with room for more
    graphs (the edge slots bind first). Returns (mean_nodes, the samples,
    the tries as (mean_nodes, node fill, graphs of the first batch))."""
    probe_batches = 2
    tries = []
    mean_nodes = 60
    while True:
        samples = list(synthetic_graph2seq_samples(
            num_samples, seed=seed, mean_nodes=mean_nodes, max_nodes=5 * mean_nodes // 2))
        model = create_graph2seq_model(embedding_size=8, padding=padding)
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
        tries.append((mean_nodes, fill, int(batches[0].num_graphs)))
        edges_bind = any(int(b.num_graphs) < padding.max_graphs for b in batches)
        if fill >= 0.75 or edges_bind:
            return mean_nodes, samples, tries
        mean_nodes += 10


def build_graph2seq(
    *,
    padding: BatchPadding,
    samples: List[Dict[str, Any]],
    embedding_size: int = 128,
    max_seq_len: int = 8,
    seed: int = 0,
    minibatch_size: int = 64,
    device: DeviceLike = None,
) -> Tuple[Graph2Seq, Graph2SeqModule, List[Dict[str, Any]]]:
    """Returns (model with metadata from ``samples``, module on ``device``
    with seeded weights, the host minibatches of ``samples``)."""
    model = create_graph2seq_model(embedding_size=embedding_size, padding=padding, max_seq_len=max_seq_len)
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


def decoder_at_vocabulary_cap() -> GruCopyingDecoderModel:
    """The decoder model at its defaults (Graph2Seq's, hidden 128, token
    embedding 256) with an output vocabulary filled to its 20,000-token cap:
    its metadata counts synthetic names over as many distinct tokens, each
    often enough to pass the count threshold."""
    model = GruCopyingDecoderModel()
    rng = np.random.RandomState(0)
    names = [DecoderData(input_elements=[], target_data=[f"tok{i}"] * (5 + int(rng.randint(100))))
             for i in range(model.vocabulary_max_size)]
    model.compute_metadata(iter(names), parallelize=False)
    return model
