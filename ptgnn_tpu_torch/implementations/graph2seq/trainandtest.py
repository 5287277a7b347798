#!/usr/bin/env python
"""Train Graph2Seq, then evaluate it on a test file in the same run.

Usage:
    python -m ptgnn_tpu_torch.implementations.graph2seq.trainandtest TRAIN_DATA \\
        VALID_DATA MODEL_FILENAME TEST_DATA [options]

Takes the train CLI's options; runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import Dict

from ptgnn_tpu_torch.implementations.graph2seq import test as test_cli
from ptgnn_tpu_torch.implementations.graph2seq import train as train_cli
from ptgnn_tpu_torch.utils.io import data_path


def build_arg_parser() -> argparse.ArgumentParser:
    parser = train_cli.build_arg_parser()
    parser.add_argument("test_data_path", type=data_path)
    return parser


def run(args: argparse.Namespace) -> Dict[str, float]:
    trainer = train_cli.run(args)
    data = list(train_cli.load_jsonl(args.test_data_path))
    metrics = test_cli.evaluate(trainer.model, trainer.neural_module, data, verbose=not args.quiet,
                                device=args.device)
    print(f"Test metrics: {metrics}")
    return metrics


def main() -> None:
    run(build_arg_parser().parse_args())


if __name__ == "__main__":
    main()
