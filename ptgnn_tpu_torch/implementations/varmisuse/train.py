#!/usr/bin/env python
"""Train VarMisuse on folders of .jsonl.gz VarMisuse samples.

The counterpart of the JAX package's CLI: the same model factory (a char-CNN
node embedder with a candidate bit; 'mlp', the 12-entry MLP-MP stack with
max aggregation, or 'ggnn', a shared gated layer with sum aggregation, mean
residuals and two GRU global-state updates) and training hyperparameters
(Adam lr 1e-4, clip 0.5, Accuracy-driven early stopping with patience 10).

Usage:
    python -m ptgnn_tpu_torch.implementations.varmisuse.train TRAIN_DATA_PATH \\
        VALID_DATA_PATH TEST_DATA_PATH MODEL_FILENAME [options]

Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Optional

import torch

from ptgnn_tpu_torch.core.data import LazyDataIterable
from ptgnn_tpu_torch.core.trainer import ModelTrainer
from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetworkModel
from ptgnn_tpu_torch.graph.messagepassing import GatedMessagePassingLayer, GruGlobalStateUpdate, MeanResidualLayer
from ptgnn_tpu_torch.graph.structs import BatchPadding
from ptgnn_tpu_torch.implementations.typilus.train import MlpStackCreator
from ptgnn_tpu_torch.implementations.varmisuse.candidateannotatedembeddings import CandidateNodeAnnotationModel
from ptgnn_tpu_torch.implementations.varmisuse.varmisuse import VarMisuseModel
from ptgnn_tpu_torch.reduceops import WeightedSumVarSizedElementReduce
from ptgnn_tpu_torch.utils.amlutils import configure_logging
from ptgnn_tpu_torch.utils.io import configure_remote_io, data_path, load_from_folder


def vm_padding(max_nodes: int = 8192, max_graphs: int = 64) -> BatchPadding:
    """Static batch budgets: 8k-node batches at 8 edge slots per node."""
    return BatchPadding(
        max_nodes=max_nodes,
        max_edge_slots=max_nodes * 8,
        max_graphs=max_graphs,
        edge_tile=128,
        reference_budgets=vm_reference_budgets(max_nodes, max_graphs),
    )


def vm_reference_budgets(max_nodes: int, max_graphs: int = 64) -> tuple:
    return (
        ("candidate_nodes", max(512, max_graphs * 16)),
        ("slot_node_idx", max_graphs),
    )


class GgnnGlobalStackCreator:
    """The 'ggnn' stack for ``num_edges`` materialized edge types: one gated
    layer object (sum aggregation, message dropout 0.01) at 8 positions, two
    mean residual blocks, and a GRU global-state update over a sigmoid-gated
    node sum (dropout 0.1) after the third gated layer of each block. A
    class, not a closure, so a model that holds it pickles."""

    def __init__(self, hidden_state_size: int):
        self.hidden_state_size = hidden_state_size

    def _global_update(self) -> GruGlobalStateUpdate:
        h = self.hidden_state_size
        return GruGlobalStateUpdate(
            global_graph_representation_module=WeightedSumVarSizedElementReduce(h),
            input_state_size=h,
            summarized_state_size=h,
            dropout_rate=0.1,
        )

    def __call__(self, num_edges: int):
        h = self.hidden_state_size
        ggnn_mp = GatedMessagePassingLayer(
            state_dimension=h, message_dimension=h, num_edge_types=num_edges,
            message_aggregation_function="sum", dropout_rate=0.01,
        )
        r1, r2 = MeanResidualLayer(h), MeanResidualLayer(h)
        return [
            r1.pass_through_dummy_layer(), r2.pass_through_dummy_layer(),
            ggnn_mp, ggnn_mp, ggnn_mp, self._global_update(), ggnn_mp, r1,
            ggnn_mp, ggnn_mp, ggnn_mp, self._global_update(), ggnn_mp, r2,
        ]


def create_var_misuse_gnn_model(
    hidden_state_size: int = 64,
    padding: Optional[BatchPadding] = None,
    architecture: str = "mlp",
) -> VarMisuseModel:
    """The JAX package's factory: 'mlp' (Graph2Class's :class:`MlpStackCreator`
    with dense dropout 0.1) or 'ggnn' (:class:`GgnnGlobalStackCreator`)."""
    if architecture == "mlp":
        creator = MlpStackCreator(hidden_state_size, dropout_rate=0.1)
    elif architecture == "ggnn":
        creator = GgnnGlobalStackCreator(hidden_state_size)
    else:
        raise ValueError(f"unknown architecture {architecture!r}: 'mlp' or 'ggnn'")
    padding = padding if padding is not None else vm_padding()
    return VarMisuseModel(
        gnn_model=GraphNeuralNetworkModel(
            node_representation_model=CandidateNodeAnnotationModel(
                embedding_size=hidden_state_size, token_splitting="char"
            ),
            message_passing_layer_creator=creator,
            padding=padding,
            max_nodes_per_graph=50000,
            max_graph_edges=500000,
            introduce_backwards_edges=True,
            add_self_edges=True,
            stop_extending_minibatch_after_num_nodes=min(80000, padding.max_nodes),
        ),
    )


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("train_data_path", type=data_path)
    parser.add_argument("valid_data_path", type=data_path)
    parser.add_argument("test_data_path", type=data_path)
    parser.add_argument("model_filename", type=Path)
    parser.add_argument("--max-num-epochs", type=int, default=100)
    parser.add_argument("--minibatch-size", type=int, default=300)
    parser.add_argument("--amp", action="store_true", help="bf16 mixed precision")
    parser.add_argument("--gradient-accumulation", type=int, default=1,
                        help="apply the mean gradient of every k minibatches in one optimizer step")
    parser.add_argument("--restore-path", type=Path, default=None)
    parser.add_argument("--sequential-run", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--max-nodes", type=int, default=8192)
    parser.add_argument("--architecture", choices=["mlp", "ggnn"], default="mlp")
    parser.add_argument("--autotune", action="store_true",
                        help="not supported yet (the padding autotuner is not ported)")
    parser.add_argument("--azure-info", type=Path, default=None,
                        help="JSON file of fsspec storage options for remote (e.g. az://) dataset paths")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    return parser


def run(args: argparse.Namespace) -> float:
    """Train, then report the test fold's accuracy (returned and printed)."""
    if args.autotune:
        raise NotImplementedError("--autotune: the padding autotuner is not ported yet")
    if not args.model_filename.name.endswith(".pkl.gz"):
        raise ValueError("MODEL_FILENAME must have a `.pkl.gz` suffix.")
    configure_logging()
    if args.quiet:
        logging.getLogger().setLevel(logging.WARNING)
    if args.azure_info is not None:
        configure_remote_io(args.azure_info)
    training_data = LazyDataIterable(lambda: load_from_folder(args.train_data_path, shuffle=True))
    validation_data = LazyDataIterable(lambda: load_from_folder(args.valid_data_path, shuffle=False))

    if args.restore_path is not None:
        model, _ = VarMisuseModel.restore_model(args.restore_path)
    else:
        model = create_var_misuse_gnn_model(padding=vm_padding(args.max_nodes), architecture=args.architecture)
    trainer = ModelTrainer(
        model,
        args.model_filename,
        max_num_epochs=args.max_num_epochs,
        minibatch_size=args.minibatch_size,
        optimizer_creator=lambda params: torch.optim.Adam(params, lr=1e-4),
        clip_gradient_norm=0.5,
        target_validation_metric="Accuracy",
        target_validation_metric_higher_is_better=True,
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
        patience=10,
    )

    test_data = LazyDataIterable(lambda: load_from_folder(args.test_data_path, shuffle=False))
    accuracy = model.report_accuracy(iter(test_data), trainer.neural_module, device=args.device)
    print(f"Test accuracy: {accuracy:%}")
    return accuracy


def main() -> None:
    run(build_arg_parser().parse_args())


if __name__ == "__main__":
    main()
