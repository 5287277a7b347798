#!/usr/bin/env python
"""Train Graph2Class (Typilus) on folders of .jsonl.gz Typilus graphs.

The counterpart of the JAX package's CLI: the same model factory ('mlp', the
benchmark's 12-entry MLP-MP stack, or 'ggnn', the shared-weight GGNN stack)
and training hyperparameters (Adam lr 2.5e-4, clip 1.0, Accuracy-driven early
stopping with patience 10). Setting ``PTGNN_TPU_ARGMAX_ROUTING`` (the JAX
package's switch) trains max aggregation with single-winner gradient
routing.

Usage:
    python -m ptgnn_tpu_torch.implementations.typilus.train TRAIN_DATA_PATH \\
        VALID_DATA_PATH TEST_DATA_PATH MODEL_FILENAME [options]

Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path
from typing import Callable, List, Optional

import torch

from ptgnn_tpu_torch.core.data import LazyDataIterable
from ptgnn_tpu_torch.core.trainer import ModelTrainer
from ptgnn_tpu_torch.graph.embedders import StrElementRepresentationModel
from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetworkModel
from ptgnn_tpu_torch.graph.messagepassing import (
    ConcatResidualLayer,
    GatedMessagePassingLayer,
    MlpMessagePassingLayer,
)
from ptgnn_tpu_torch.graph.structs import BatchPadding
from ptgnn_tpu_torch.implementations.typilus.graph2class import Graph2Class
from ptgnn_tpu_torch.utils.amlutils import configure_logging, get_run_context, log_run
from ptgnn_tpu_torch.utils.autotune import autotune_task_model, default_candidates
from ptgnn_tpu_torch.utils.io import configure_remote_io, data_path, load_from_folder

ARGMAX_ROUTING_ENV = "PTGNN_TPU_ARGMAX_ROUTING"


def default_padding(
    max_nodes: int = 8192,
    max_graphs: Optional[int] = None,
    edge_slots_per_node: float = 6.0,
) -> BatchPadding:
    """Static batch budgets: 8k-node batches at 6 edge slots per node."""
    return BatchPadding(
        max_nodes=max_nodes,
        max_edge_slots=int(max_nodes * edge_slots_per_node) // 128 * 128,
        max_graphs=max_graphs if max_graphs is not None else max(8, max_nodes // 1024),
        edge_tile=128,
        reference_budgets=typilus_reference_budgets(max_nodes),
    )


def typilus_reference_budgets(max_nodes: int) -> tuple:
    return (
        ("supernodes", max(512, max_nodes // 16)),
        ("token-sequence", max_nodes),
    )


class MlpStackCreator:
    """The benchmark 'mlp' stack for ``num_edges`` materialized edge types: 12
    entries, 8 MLP-MP layers with max aggregation and target-state input, two
    concat residuals. A class, not a closure, so a model that holds it
    pickles into a checkpoint."""

    def __init__(self, hidden_state_size: int, dropout_rate: float, argmax_routing: bool = False):
        self.hidden_state_size = hidden_state_size
        self.dropout_rate = dropout_rate
        self.argmax_routing = argmax_routing

    def _mlp_mp(self, num_edges: int, input_dim: int, message_dim: int) -> MlpMessagePassingLayer:
        return MlpMessagePassingLayer(
            input_state_dimension=input_dim,
            message_dimension=message_dim,
            output_state_dimension=self.hidden_state_size,
            num_edge_types=num_edges,
            message_aggregation_function="max",
            dropout_rate=self.dropout_rate,
            argmax_routing=self.argmax_routing,
        )

    def __call__(self, num_edges: int):
        h = self.hidden_state_size
        r1 = ConcatResidualLayer(h)
        r2 = ConcatResidualLayer(h)
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


class GgnnStackCreator:
    """The 'ggnn' stack: one gated layer object at 7 positions (shared
    weights), then a concat residual and a second gated layer at state
    2 x hidden, all with max aggregation. A class, not a closure, so a model
    that holds it pickles into a checkpoint."""

    def __init__(self, hidden_state_size: int, dropout_rate: float, argmax_routing: bool = False):
        self.hidden_state_size = hidden_state_size
        self.dropout_rate = dropout_rate
        self.argmax_routing = argmax_routing

    def _gated(self, num_edges: int, state_dim: int) -> GatedMessagePassingLayer:
        return GatedMessagePassingLayer(
            state_dimension=state_dim,
            message_dimension=self.hidden_state_size,
            num_edge_types=num_edges,
            message_aggregation_function="max",
            dropout_rate=self.dropout_rate,
            argmax_routing=self.argmax_routing,
        )

    def __call__(self, num_edges: int):
        h = self.hidden_state_size
        shared = self._gated(num_edges, h)
        r1 = ConcatResidualLayer(h)
        return [r1.pass_through_dummy_layer()] + [shared] * 7 + [r1, self._gated(num_edges, 2 * h)]


_STACKS = {"mlp": MlpStackCreator, "ggnn": GgnnStackCreator}


def create_graph2class_gnn_model(
    hidden_state_size: int = 64,
    dropout_rate: float = 0.1,
    padding: Optional[BatchPadding] = None,
    architecture: str = "mlp",
    min_freq_threshold: int = 5,
    argmax_routing: bool = False,
) -> Graph2Class:
    """The JAX package's model factory: 'mlp' (:class:`MlpStackCreator`, the
    benchmark configuration) or 'ggnn' (:class:`GgnnStackCreator`); edge
    dropout is 0. ``argmax_routing`` goes to every MP layer."""
    if architecture not in _STACKS:
        raise ValueError(f"unknown architecture {architecture!r}: one of {sorted(_STACKS)}")
    return graph2class_model(
        _STACKS[architecture](hidden_state_size, dropout_rate, argmax_routing),
        hidden_state_size=hidden_state_size, dropout_rate=dropout_rate, padding=padding,
        min_freq_threshold=min_freq_threshold,
    )


def graph2class_model(
    layer_creator: Callable[[int], list],
    *,
    hidden_state_size: int = 64,
    dropout_rate: float = 0.1,
    padding: Optional[BatchPadding] = None,
    min_freq_threshold: int = 5,
    token_splitting: str = "subtoken",
    subtoken_combination: str = "mean",
) -> Graph2Class:
    """Graph2Class with the factory's node embedder (labels split by
    ``token_splitting``, the factory's ``subtoken`` or ``bpe``, and pooled by
    ``subtoken_combination``) and batching around the message-passing stack
    that ``layer_creator(num_edge_types)`` builds."""
    padding = padding if padding is not None else default_padding()
    return Graph2Class(
        gnn_model=GraphNeuralNetworkModel(
            node_representation_model=StrElementRepresentationModel(
                embedding_size=hidden_state_size,
                token_splitting=token_splitting,
                subtoken_combination=subtoken_combination,
                vocabulary_size=10000,
                min_freq_threshold=min_freq_threshold,
                dropout_rate=dropout_rate,
            ),
            message_passing_layer_creator=layer_creator,
            padding=padding,
            max_nodes_per_graph=100000,
            max_graph_edges=500000,
            introduce_backwards_edges=True,
            add_self_edges=True,
            stop_extending_minibatch_after_num_nodes=min(120000, padding.max_nodes),
        ),
        max_num_classes=100,
    )


def autotune_candidates() -> List[BatchPadding]:
    """The paddings ``--autotune`` measures: the default grid with the
    Typilus reference budgets."""
    return default_candidates(reference_budgets_fn=typilus_reference_budgets)

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
    parser.add_argument("--restore-optimizer", action="store_true")
    parser.add_argument("--sequential-run", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--aml", action="store_true")
    parser.add_argument("--max-nodes", type=int, default=8192,
                        help="static per-batch node budget (graphs larger than this are dropped)")
    parser.add_argument("--architecture", choices=sorted(_STACKS), default="mlp")
    parser.add_argument("--autotune", action="store_true",
                        help="measure candidate batch paddings on this dataset before training and pick the fastest")
    parser.add_argument("--azure-info", type=Path, default=None,
                        help="JSON file of fsspec storage options for remote (e.g. az://) dataset paths")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    return parser


def run(args: argparse.Namespace) -> float:
    """Train, then report the test fold's accuracy (returned and printed)."""
    if not args.model_filename.name.endswith(".pkl.gz"):
        raise ValueError("MODEL_FILENAME must have a `.pkl.gz` suffix.")
    aml_ctx = get_run_context() if args.aml else None
    configure_logging(aml_ctx)
    if args.quiet:
        logging.getLogger().setLevel(logging.WARNING)
    if args.azure_info is not None:
        configure_remote_io(args.azure_info)
    # The JAX package's switch, read once here and passed down explicitly.
    argmax_routing = bool(os.environ.get(ARGMAX_ROUTING_ENV))

    training_data = LazyDataIterable(lambda: load_from_folder(args.train_data_path, shuffle=True))
    validation_data = LazyDataIterable(lambda: load_from_folder(args.valid_data_path, shuffle=False))

    if args.restore_path is not None:
        model, _ = Graph2Class.restore_model(args.restore_path)
    else:
        model = create_graph2class_gnn_model(
            padding=default_padding(max_nodes=args.max_nodes),
            architecture=args.architecture,
            argmax_routing=argmax_routing,
        )
        if args.autotune:  # the re-budgeted clone carries its metadata: the trainer skips a second scan
            model, _ = autotune_task_model(
                model, training_data, minibatch_size=args.minibatch_size, candidates=autotune_candidates(),
                amp=args.amp, parallelize=not args.sequential_run, device=args.device,
            )
    trainer = ModelTrainer(
        model,
        args.model_filename,
        max_num_epochs=args.max_num_epochs,
        minibatch_size=args.minibatch_size,
        optimizer_creator=lambda params: torch.optim.Adam(params, lr=2.5e-4),
        clip_gradient_norm=1.0,
        target_validation_metric="Accuracy",
        target_validation_metric_higher_is_better=True,
        enable_amp=args.amp,
        gradient_accumulation_steps=args.gradient_accumulation,
        device=args.device,
    )
    if args.restore_path is not None:
        trainer.restore_parameters(args.restore_path, restore_optimizer=args.restore_optimizer)
        for layer in trainer.neural_module.modules():  # this invocation's routing
            if hasattr(layer, "argmax_routing"):
                layer.argmax_routing = argmax_routing
    trainer.register_train_epoch_end_hook(
        lambda model, nn, epoch, metrics: log_run(aml_ctx, "train", model, epoch, metrics)
    )
    trainer.register_validation_epoch_end_hook(
        lambda model, nn, epoch, metrics: log_run(aml_ctx, "valid", model, epoch, metrics)
    )
    trainer.train(
        training_data,
        validation_data,
        initialize_metadata=args.restore_path is None,
        parallelize=not args.sequential_run,
        patience=10,
        store_tensorized_data_in_memory=True,
    )

    test_data = LazyDataIterable(lambda: load_from_folder(args.test_data_path, shuffle=False))
    accuracy = model.report_accuracy(iter(test_data), trainer.neural_module, device=args.device)
    print(f"Test accuracy: {accuracy:%}")
    return accuracy


def main() -> None:
    run(build_arg_parser().parse_args())


if __name__ == "__main__":
    main()
