#!/usr/bin/env python
"""Train PPI multi-label node classification on a GraphSAGE-format data
directory (``{train,valid,test}_{graph.json,feats.npy,labels.npy,graph_id.npy}``).

Usage:
    python -m ptgnn_tpu_torch.implementations.ppi.train DATA_DIR MODEL_FILENAME [options]

Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Optional

from ptgnn_tpu_torch.core.trainer import ModelTrainer
from ptgnn_tpu_torch.graph.embedders import FeatureRepresentationModel
from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetworkModel
from ptgnn_tpu_torch.graph.messagepassing import MeanResidualLayer, MlpMessagePassingLayer
from ptgnn_tpu_torch.graph.structs import BatchPadding
from ptgnn_tpu_torch.implementations.ppi.dataloader import PPIDatasetLoader
from ptgnn_tpu_torch.implementations.ppi.ppi import PPIMulticlassClassification
from ptgnn_tpu_torch.utils.io import configure_remote_io, data_path


def ppi_padding(max_nodes: int = 4096) -> BatchPadding:
    """PPI graphs average ~2.4k nodes and ~34k edges; batches stop extending
    after 3000 nodes, so one padded batch holds 1-2 graphs. PPI is dense:
    about 28 materialized (forward, backward, self) edges per node."""
    return BatchPadding(
        max_nodes=max_nodes,
        max_edge_slots=max_nodes * 30,
        max_graphs=8,
        edge_tile=128,
    )


class PPIStackCreator:
    """PPI's stack for ``num_edges`` materialized edge types: 5 sum-aggregation
    MLP-MP layers (output dropout 0.2) in two mean-residual blocks. A class,
    not a closure, so a model that holds it pickles into a checkpoint."""

    def __init__(self, hidden_state_size: int):
        self.hidden_state_size = hidden_state_size

    def _mlp_mp(self, num_edges: int) -> MlpMessagePassingLayer:
        h = self.hidden_state_size
        return MlpMessagePassingLayer(
            input_state_dimension=h,
            message_dimension=h,
            output_state_dimension=h,
            num_edge_types=num_edges,
            message_aggregation_function="sum",
            dropout_rate=0.2,
        )

    def __call__(self, num_edges: int):
        r1 = MeanResidualLayer(self.hidden_state_size)
        r2 = MeanResidualLayer(self.hidden_state_size)
        return [
            r1.pass_through_dummy_layer(),
            self._mlp_mp(num_edges), self._mlp_mp(num_edges), self._mlp_mp(num_edges),
            r1,
            r2.pass_through_dummy_layer(),
            self._mlp_mp(num_edges), self._mlp_mp(num_edges),
            r2,
        ]


def create_ppi_gnn_model(
    hidden_state_size: int = 256, padding: Optional[BatchPadding] = None
) -> PPIMulticlassClassification:
    """The PPI model: a Tanh feature embedder, :class:`PPIStackCreator`'s
    stack, backward and self edges, batches of up to 3000 nodes."""
    padding = padding if padding is not None else ppi_padding()
    return PPIMulticlassClassification(
        gnn_model=GraphNeuralNetworkModel(
            node_representation_model=FeatureRepresentationModel(
                embedding_size=hidden_state_size, activation="tanh"
            ),
            message_passing_layer_creator=PPIStackCreator(hidden_state_size),
            padding=padding,
            max_nodes_per_graph=6000,
            max_graph_edges=300000,
            introduce_backwards_edges=True,
            add_self_edges=True,
            stop_extending_minibatch_after_num_nodes=3000,
        ),
    )


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("data_path", type=data_path)
    parser.add_argument("model_filename", type=Path)
    parser.add_argument("--max-num-epochs", type=int, default=100)
    parser.add_argument("--minibatch-size", type=int, default=50)
    parser.add_argument("--restore-path", type=Path, default=None)
    parser.add_argument("--autotune", action="store_true",
                        help="not supported yet (the padding autotuner is not ported)")
    parser.add_argument("--amp", action="store_true", help="bf16 mixed precision")
    parser.add_argument("--sequential-run", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--max-nodes", type=int, default=4096)
    parser.add_argument("--gradient-accumulation", type=int, default=1,
                        help="apply the mean gradient of every k minibatches in one optimizer step")
    parser.add_argument("--azure-info", type=Path, default=None,
                        help="JSON file of fsspec storage options for remote (e.g. az://) dataset paths")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    return parser


def run(args: argparse.Namespace) -> dict:
    """Train, then report the test fold's metrics (returned and printed)."""
    if args.autotune:
        raise NotImplementedError("--autotune: the padding autotuner is not ported yet")
    if not args.model_filename.name.endswith(".pkl.gz"):
        raise ValueError("MODEL_FILENAME must have a `.pkl.gz` suffix.")
    if args.azure_info is not None:
        configure_remote_io(args.azure_info)
    training_data = PPIDatasetLoader.load_data(args.data_path, "train")
    validation_data = PPIDatasetLoader.load_data(args.data_path, "valid")

    if args.restore_path is not None:
        model, _ = PPIMulticlassClassification.restore_model(args.restore_path)
    else:
        model = create_ppi_gnn_model(padding=ppi_padding(args.max_nodes))
    trainer = ModelTrainer(
        model,
        args.model_filename,
        max_num_epochs=args.max_num_epochs,
        minibatch_size=args.minibatch_size,
        gradient_accumulation_steps=args.gradient_accumulation,
        enable_amp=args.amp,
        clip_gradient_norm=1.0,
        target_validation_metric="f1_score",
        target_validation_metric_higher_is_better=True,
        device=args.device,
    )  # the default optimizer is Adam(1e-3)
    if args.restore_path is not None:
        trainer.restore_parameters(args.restore_path)
    trainer.train(
        training_data,
        validation_data,
        initialize_metadata=args.restore_path is None,
        parallelize=not args.sequential_run,
        patience=20,
        store_tensorized_data_in_memory=True,
    )
    test_data = PPIDatasetLoader.load_data(args.data_path, "test")
    metrics = model.report_metrics(test_data, trainer.neural_module, device=args.device)
    print(f"Test metrics: {metrics}")
    return metrics


def main() -> None:
    args = build_arg_parser().parse_args()
    logging.basicConfig(level=logging.WARNING if args.quiet else logging.INFO)
    run(args)


if __name__ == "__main__":
    main()
