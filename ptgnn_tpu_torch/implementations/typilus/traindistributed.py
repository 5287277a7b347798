#!/usr/bin/env python
"""Data-parallel Graph2Class (Typilus) training, one process per GPU.

The counterpart of the JAX package's distributed CLI, with its arguments:
the benchmark's 'mlp' model, Adam lr 2.5e-4, clip 1.0, Accuracy-driven early
stopping with patience 10, ZeRO-1 unless ``--no-zero1``.

    python -m ptgnn_tpu_torch.implementations.typilus.traindistributed \\
        TRAIN_DATA VALID_DATA TEST_DATA MODEL_FILENAME [--world-size N] [options]

spawns ``--world-size`` processes on this host (every local GPU by default;
one process runs in this one), joined through a ``file://`` rendezvous in a
temporary directory. Under torchrun (``torchrun --nproc-per-node N -m
ptgnn_tpu_torch.implementations.typilus.traindistributed ...``) each process
takes its rank from torchrun's environment instead. Across hosts without
torchrun, run the command on every host with ``--coordinator HOST:PORT``,
``--num-processes`` (hosts) and ``--process-id`` (this host): the ranks of
host i are i x world-size .. (i + 1) x world-size - 1. Each host reads its
own interleave of the training and validation files; metadata comes from
rank 0 over the whole training folder. ``--device cpu`` runs gloo over CPU
processes; the default is NCCL over the local cards.

``--node-shards S`` splits each minibatch's nodes over node groups of S
consecutive ranks (``parallel/node_sharded_trainer.py``): graphs larger
than one card train, and the node groups are data-parallel among
themselves. A node group must not span hosts. ``--node-budget-headroom``
scales the node-sharding budgets probed from the first batches.
"""
from __future__ import annotations

import argparse
import logging
import os
import random
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from ptgnn_tpu_torch.core.data import LazyDataIterable
from ptgnn_tpu_torch.device import resolve_device
from ptgnn_tpu_torch.implementations.typilus.graph2class import Graph2Class
from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model, default_padding
from ptgnn_tpu_torch.parallel.distributed_trainer import DistributedModelTrainer, initialize_multi_host
from ptgnn_tpu_torch.parallel.node_sharded_trainer import NodeShardedModelTrainer
from ptgnn_tpu_torch.utils.amlutils import configure_logging, get_run_context, log_run
from ptgnn_tpu_torch.utils.io import configure_remote_io, data_path, load_from_folder

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("train_data_path", type=data_path)
    parser.add_argument("valid_data_path", type=data_path)
    parser.add_argument("test_data_path", type=data_path)
    parser.add_argument("model_filename", type=Path)
    parser.add_argument("--max-num-epochs", type=int, default=100)
    parser.add_argument("--minibatch-size", type=int, default=300)
    parser.add_argument("--amp", action="store_true", help="bf16 mixed precision")
    parser.add_argument("--restore-path", type=Path, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--max-nodes", type=int, default=131072,
                        help="static per-batch node budget (graphs larger than this are dropped)")
    parser.add_argument("--world-size", type=int, default=None,
                        help="processes on this host (default: one per local GPU; 1 with --device cpu)")
    parser.add_argument("--no-zero1", action="store_true", help="keep the full optimizer state on every rank")
    parser.add_argument("--node-shards", type=int, default=None,
                        help="split each batch's nodes over this many ranks (graphs larger than one card train); "
                             "the node groups are data-parallel among themselves")
    parser.add_argument("--node-budget-headroom", type=float, default=1.5,
                        help="safety factor on the node-sharding budgets probed from the first batches")
    parser.add_argument("--coordinator", type=str, default=None, help="HOST:PORT of host 0's rendezvous")
    parser.add_argument("--num-processes", type=int, default=None, help="number of hosts (with --coordinator)")
    parser.add_argument("--process-id", type=int, default=None, help="this host's index (with --coordinator)")
    parser.add_argument("--azure-info", type=Path, default=None,
                        help="JSON file of fsspec storage options for remote (e.g. az://) dataset paths")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda: NCCL over the local cards; cpu: gloo over CPU processes")
    return parser


def _train(local_rank: int, args: argparse.Namespace, init_method: Optional[str], world_size: Optional[int],
           rank_offset: int) -> Optional[float]:
    """One rank: join the group, train, and (rank 0) report the test fold's
    accuracy. Under torchrun ``init_method`` is None (its environment)."""
    rank = None if init_method is None else rank_offset + local_rank
    if args.device == "cuda":
        resolve_device("cuda")  # raises where CUDA is missing
        if init_method is not None:
            # this spawned rank's place on its host, as torchrun states it:
            # the card that initialize_multi_host binds
            os.environ["LOCAL_RANK"] = str(local_rank)
            os.environ["LOCAL_WORLD_SIZE"] = str(args.world_size)
        initialize_multi_host("nccl", init_method, world_size, rank)
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        initialize_multi_host("gloo", init_method, world_size, rank)
        device = torch.device("cpu")
    try:
        return _run_rank(args, device)
    finally:
        dist.destroy_process_group()


def _run_rank(args: argparse.Namespace, device: torch.device) -> Optional[float]:
    rank, world = dist.get_rank(), dist.get_world_size()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or args.world_size or world
    node, nodes = rank // local_world, world // local_world
    aml_ctx = get_run_context()
    configure_logging(aml_ctx, rank=rank)
    if args.quiet:
        logging.getLogger().setLevel(logging.WARNING)
    if args.azure_info is not None:
        configure_remote_io(args.azure_info)

    # The ranks of a node read one file order (a shared seed); nodes read
    # their own interleave of the files.
    file_order = random.Random(node)
    training_data = LazyDataIterable(lambda: load_from_folder(
        args.train_data_path, shuffle=True, rank=node, world_size=nodes, rng=file_order))
    validation_data = LazyDataIterable(lambda: load_from_folder(
        args.valid_data_path, shuffle=False, rank=node, world_size=nodes))
    metadata_data = LazyDataIterable(lambda: load_from_folder(args.train_data_path, shuffle=False))

    if args.restore_path is not None:
        model, _ = Graph2Class.restore_model(args.restore_path)
    else:
        model = create_graph2class_gnn_model(padding=default_padding(max_nodes=args.max_nodes))
    trainer_kwargs = dict(
        zero1=not args.no_zero1,
        local_world_size=local_world,
        max_num_epochs=args.max_num_epochs,
        minibatch_size=args.minibatch_size,
        optimizer_creator=lambda params: torch.optim.Adam(params, lr=2.5e-4),
        clip_gradient_norm=1.0,
        target_validation_metric="Accuracy",
        target_validation_metric_higher_is_better=True,
        enable_amp=args.amp,
        device=device,
    )
    if args.node_shards is not None:
        trainer = NodeShardedModelTrainer(model, args.model_filename, node_shards=args.node_shards,
                                          budget_headroom=args.node_budget_headroom, **trainer_kwargs)
    else:
        trainer = DistributedModelTrainer(model, args.model_filename, **trainer_kwargs)
    if args.restore_path is not None:
        trainer.restore_parameters(args.restore_path)
    else:
        trainer.load_metadata_and_create_network(metadata_data)
    logging.info("Data-parallel training on %s ranks (%s nodes of %s, node groups of %s), rank %s on %s.",
                 world, nodes, local_world, args.node_shards or 1, rank, device)
    trainer.register_train_epoch_end_hook(
        lambda model, nn, epoch, metrics: log_run(aml_ctx, "train", model, epoch, metrics)
    )
    trainer.register_validation_epoch_end_hook(
        lambda model, nn, epoch, metrics: log_run(aml_ctx, "valid", model, epoch, metrics)
    )
    trainer.train(
        training_data,
        validation_data,
        initialize_metadata=False,
        patience=10,
        store_tensorized_data_in_memory=True,
    )
    if rank != 0:
        return None
    test_data = LazyDataIterable(lambda: load_from_folder(args.test_data_path, shuffle=False))
    accuracy = model.report_accuracy(iter(test_data), trainer.neural_module, device=device)
    print(f"Test accuracy: {accuracy:%}", flush=True)
    return accuracy


def run(args: argparse.Namespace) -> Optional[float]:
    """Train on every rank; returns the test accuracy where rank 0 ran in
    this process, else None (it is printed either way)."""
    if not args.model_filename.name.endswith(".pkl.gz"):
        raise ValueError("MODEL_FILENAME must have a `.pkl.gz` suffix.")
    if args.device == "cuda":
        resolve_device("cuda")
    if all(k in os.environ for k in TORCHRUN_ENV):
        if args.world_size is not None or args.coordinator is not None:
            raise ValueError("under torchrun the ranks come from its environment: drop --world-size/--coordinator")
        return _train(int(os.environ["LOCAL_RANK"]), args, None, None, 0)
    local = args.world_size or (torch.cuda.device_count() if args.device == "cuda" else 1)
    hosts = args.num_processes or 1
    if args.coordinator is None and hosts != 1:
        raise ValueError("--num-processes needs --coordinator")
    args.world_size = local
    rank_offset = (args.process_id or 0) * local
    rendezvous = None
    if args.coordinator is not None:
        init_method = f"tcp://{args.coordinator}"
    else:
        rendezvous = tempfile.mkdtemp(prefix="ptgnn_rendezvous_")
        init_method = f"file://{rendezvous}/store"
    try:
        if local == 1:
            return _train(0, args, init_method, hosts * local, rank_offset)
        torch.multiprocessing.start_processes(
            _train, args=(args, init_method, hosts * local, rank_offset), nprocs=local, join=True,
            start_method="spawn",
        )
        return None
    finally:
        if rendezvous is not None:
            shutil.rmtree(rendezvous, ignore_errors=True)


def main() -> None:
    run(build_arg_parser().parse_args())


if __name__ == "__main__":
    main()
