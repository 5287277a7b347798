#!/usr/bin/env python
"""Evaluate a trained Graph2Seq model: decode every test sample and report
exact-match accuracy, set-level precision, recall and F1 of the name's
tokens, and Jaro-Winkler similarity of the joined names.

Usage:
    python -m ptgnn_tpu_torch.implementations.graph2seq.test MODEL_FILENAME \\
        TEST_DATA [--beam-size K] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List

import numpy as np

from ptgnn_tpu_torch.device import DeviceLike
from ptgnn_tpu_torch.implementations.graph2seq.graph2seq import Graph2Seq, Graph2SeqModule
from ptgnn_tpu_torch.implementations.graph2seq.train import load_jsonl
from ptgnn_tpu_torch.utils.io import configure_remote_io, data_path
from ptgnn_tpu_torch.utils.strsim import jaro_winkler


def evaluate(model: Graph2Seq, network: Graph2SeqModule, data: List[dict], verbose: bool = True,
             beam_size: int = 1, device: DeviceLike = None) -> Dict[str, float]:
    """The metrics of the greedy decode (``beam_size`` 1) or of the top beam;
    samples dropped by the size caps are left out."""
    if beam_size > 1:
        all_responses = [None if beams is None else beams[0]
                         for beams in model.beam_decode(data, network, beam_size=beam_size, device=device)]
    else:
        all_responses = model.greedy_decode(data, network, device=device)
    correct_elements, jw_sim, num_elements = 0, 0.0, 0
    sum_f1, sum_precision, sum_recall = 0.0, 0.0, 0.0
    for response, actual_data in zip(all_responses, data):
        if response is None:  # dropped by the size caps (the decode warns)
            continue
        res_tokens, res_logprob = response
        num_elements += 1
        if verbose:
            print(f'{actual_data["method_name"]} -> {res_tokens} ({np.exp(res_logprob):.2f})')
        jw_sim += jaro_winkler("".join(actual_data["method_name"]), "".join(res_tokens))
        if actual_data["method_name"] == res_tokens:
            correct_elements += 1
        res_token_set = set(res_tokens)
        res_token_set.discard("%UNK%")
        ground_tokens = set(actual_data["method_name"])
        precision = len(res_token_set & ground_tokens) / len(res_token_set) if res_token_set else 0
        recall = len(res_token_set & ground_tokens) / len(ground_tokens)
        if precision + recall > 0:
            sum_f1 += 2 * recall * precision / (precision + recall)
            sum_precision += precision
            sum_recall += recall
    return {
        "accuracy": correct_elements / num_elements,
        "f1": sum_f1 / num_elements,
        "precision": sum_precision / num_elements,
        "recall": sum_recall / num_elements,
        "jaro_winkler": jw_sim / num_elements,
    }


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model_filename", type=Path)
    parser.add_argument("test_data_path", type=data_path)
    parser.add_argument("--beam-size", type=int, default=1, help="beam search width; 1 = greedy")
    parser.add_argument("--azure-info", type=Path, default=None,
                        help="JSON file of fsspec storage options for remote (e.g. az://) dataset paths")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    return parser


def run(args: argparse.Namespace) -> Dict[str, float]:
    if args.azure_info is not None:
        configure_remote_io(args.azure_info)
    data = list(load_jsonl(args.test_data_path))
    model, state = Graph2Seq.restore_model(args.model_filename)
    network = model.build_neural_module(device=args.device)
    network.load_state_dict(state)
    metrics = evaluate(model, network, data, beam_size=args.beam_size, device=args.device)
    print(f"Acc {metrics['accuracy']:%}")
    print(f"F1 {metrics['f1']}")
    print(f"Pr {metrics['precision']}  Re {metrics['recall']}")
    print(f"JW Sim {metrics['jaro_winkler']}")
    return metrics


def main() -> None:
    run(build_arg_parser().parse_args())


if __name__ == "__main__":
    main()
