#!/usr/bin/env python
"""Streaming type prediction with a trained Graph2Class model: one line per
supernode of every graph in a folder of .jsonl.gz Typilus graphs.

Usage:
    python -m ptgnn_tpu_torch.implementations.typilus.predict MODEL_FILENAME DATA_PATH [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ptgnn_tpu_torch.implementations.typilus.graph2class import Graph2Class
from ptgnn_tpu_torch.utils.io import configure_remote_io, data_path, load_from_folder


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model_filename", type=Path)
    parser.add_argument("data_path", type=data_path)
    parser.add_argument("--azure-info", type=Path, default=None,
                        help="JSON file of fsspec storage options for remote (e.g. az://) dataset paths")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    return parser


def run(args: argparse.Namespace) -> int:
    """Print the suggestions; returns the number of lines printed."""
    if args.azure_info is not None:
        configure_remote_io(args.azure_info)
    data = load_from_folder(args.data_path, shuffle=False)
    model, state = Graph2Class.restore_model(args.model_filename)
    network = model.build_neural_module(device=args.device)
    network.load_state_dict(state)

    printed = 0
    for graph, suggestions in model.predict(data, network, device=args.device):
        for supernode_idx, (target_type, prob) in suggestions.items():
            supernode_info = graph["supernodes"][str(supernode_idx)]
            print(
                f'`{supernode_info["name"]}` Original: `{supernode_info.get("annotation")}` '
                f"Predicted: `{target_type}` ({prob:.2%})"
            )
            printed += 1
    return printed


def main() -> None:
    run(build_arg_parser().parse_args())


if __name__ == "__main__":
    main()
