#!/usr/bin/env python
"""Train Graph2Seq on a jsonl(.gz) file of CodeGraph2Seq samples.

The counterpart of the JAX package's CLI: the same model factory (a token
vocabulary node embedder, 7 positions of one shared gated layer and a fresh
one in a mean residual block, the GRU copy decoder) and training defaults
(Adam 1e-3, no clipping, the validation loss for early stopping).

Usage:
    python -m ptgnn_tpu_torch.implementations.graph2seq.train TRAIN_DATA \\
        VALID_DATA MODEL_FILENAME [options]

Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import List, Optional

from ptgnn_tpu_torch.core.data import LazyDataIterable
from ptgnn_tpu_torch.core.trainer import ModelTrainer
from ptgnn_tpu_torch.graph.embedders import StrElementRepresentationModel
from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetworkModel
from ptgnn_tpu_torch.graph.messagepassing import GatedMessagePassingLayer, MeanResidualLayer
from ptgnn_tpu_torch.graph.structs import BatchPadding
from ptgnn_tpu_torch.implementations.graph2seq.graph2seq import Graph2Seq
from ptgnn_tpu_torch.sequence.grucopydecoder import GruCopyingDecoderModel
from ptgnn_tpu_torch.utils.amlutils import configure_logging
from ptgnn_tpu_torch.utils.autotune import autotune_task_model, default_candidates
from ptgnn_tpu_torch.utils.io import configure_remote_io, data_path, iter_jsonl


def g2s_padding(max_nodes: int = 16384, max_graphs: int = 64) -> BatchPadding:
    """Static batch budgets: 8 edge slots per node, a backbone reference
    budget of one per node."""
    return BatchPadding(
        max_nodes=max_nodes,
        max_edge_slots=max_nodes * 8,
        max_graphs=max_graphs,
        edge_tile=128,
        reference_budgets=(("backbone_nodes", max_nodes),),
    )


class GatedStackCreator:
    """The Graph2Seq stack for ``num_edges`` materialized edge types: a
    residual origin, one gated layer object (sum aggregation) at 7
    positions, the mean residual, and a fresh gated layer. A class, not a
    closure, so a model that holds it pickles."""

    def __init__(self, embedding_size: int, dropout_rate: float):
        self.embedding_size = embedding_size
        self.dropout_rate = dropout_rate

    def _gated(self, num_edges: int) -> GatedMessagePassingLayer:
        return GatedMessagePassingLayer(
            state_dimension=self.embedding_size, message_dimension=self.embedding_size,
            num_edge_types=num_edges, message_aggregation_function="sum", dropout_rate=self.dropout_rate,
        )

    def __call__(self, num_edges: int):
        shared = self._gated(num_edges)
        r1 = MeanResidualLayer(self.embedding_size)
        return [r1.pass_through_dummy_layer()] + [shared] * 7 + [r1, self._gated(num_edges)]


def create_graph2seq_model(
    embedding_size: int = 128,
    dropout_rate: float = 0.1,
    padding: Optional[BatchPadding] = None,
    max_seq_len: int = 8,
    token_vocabulary_size: int = 10000,
    decoder_hidden_size: Optional[int] = None,
    decoder_embedding_size: Optional[int] = None,
) -> Graph2Seq:
    """The JAX package's factory: a node-token vocabulary of
    ``token_vocabulary_size`` (the output vocabulary caps at 20,000). The
    decoder's hidden size defaults to ``embedding_size`` and its token
    embedding to twice that (128/256 at the default)."""
    padding = padding if padding is not None else g2s_padding()
    if decoder_hidden_size is None:
        decoder_hidden_size = embedding_size
    if decoder_embedding_size is None:
        decoder_embedding_size = 2 * embedding_size
    return Graph2Seq(
        gnn_model=GraphNeuralNetworkModel(
            node_representation_model=StrElementRepresentationModel(
                token_splitting="token", embedding_size=embedding_size, vocabulary_size=token_vocabulary_size,
            ),
            message_passing_layer_creator=GatedStackCreator(embedding_size, dropout_rate),
            padding=padding,
        ),
        decoder=GruCopyingDecoderModel(
            hidden_size=decoder_hidden_size,
            embedding_size=decoder_embedding_size,
            memories_hidden_dim=embedding_size,
            max_seq_len=max_seq_len,
        ),
    )


def load_jsonl(path):
    yield from iter_jsonl(path)


def autotune_candidates() -> List[BatchPadding]:
    """The paddings ``--autotune`` measures: 8k and 16k nodes at 6 and 8
    slots a node, with every node a memory slot."""
    return default_candidates(max_nodes_options=(8192, 16384), slots_per_node_options=(6.0, 8.0),
                              reference_budgets_fn=lambda mn: (("backbone_nodes", mn),))

def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("train_data_path", type=data_path)
    parser.add_argument("valid_data_path", type=data_path)
    parser.add_argument("model_filename", type=Path)
    parser.add_argument("--max-num-epochs", type=int, default=100)
    parser.add_argument("--minibatch-size", type=int, default=50)
    parser.add_argument("--amp", action="store_true", help="bf16 mixed precision")
    parser.add_argument("--gradient-accumulation", type=int, default=1,
                        help="apply the mean gradient of every k minibatches in one optimizer step")
    parser.add_argument("--restore-path", type=Path, default=None)
    parser.add_argument("--autotune", action="store_true",
                        help="measure candidate batch paddings on this dataset before training and pick the fastest")
    parser.add_argument("--sequential-run", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--max-nodes", type=int, default=16384)
    parser.add_argument("--azure-info", type=Path, default=None,
                        help="JSON file of fsspec storage options for remote (e.g. az://) dataset paths")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    return parser


def run(args: argparse.Namespace) -> ModelTrainer:
    """Train; returns the trainer, holding the best parameters."""
    if not args.model_filename.name.endswith(".pkl.gz"):
        raise ValueError("MODEL_FILENAME must have a `.pkl.gz` suffix.")
    configure_logging()
    if args.quiet:
        logging.getLogger().setLevel(logging.WARNING)
    if args.azure_info is not None:
        configure_remote_io(args.azure_info)
    training_data = LazyDataIterable(lambda: load_jsonl(args.train_data_path))
    validation_data = LazyDataIterable(lambda: load_jsonl(args.valid_data_path))

    if args.restore_path is not None:
        model, _ = Graph2Seq.restore_model(args.restore_path)
    else:
        model = create_graph2seq_model(padding=g2s_padding(args.max_nodes))
        if args.autotune:
            model, _ = autotune_task_model(
                model, training_data, minibatch_size=args.minibatch_size, candidates=autotune_candidates(),
                amp=args.amp, parallelize=not args.sequential_run, device=args.device,
            )
    trainer = ModelTrainer(
        model,
        args.model_filename,
        max_num_epochs=args.max_num_epochs,
        minibatch_size=args.minibatch_size,
        enable_amp=args.amp,
        gradient_accumulation_steps=args.gradient_accumulation,
        device=args.device,
    )
    if args.restore_path is not None:
        trainer.restore_parameters(args.restore_path)
    trainer.train(
        training_data,
        validation_data,
        initialize_metadata=args.restore_path is None,
        parallelize=not args.sequential_run,
    )
    return trainer


def main() -> None:
    run(build_arg_parser().parse_args())


if __name__ == "__main__":
    main()
