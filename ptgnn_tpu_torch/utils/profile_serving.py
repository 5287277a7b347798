"""Where the time of a serving forward, of a training step or of a decode
goes on the card, for Graph2Class, PPI, VarMisuse or Graph2Seq, for
Graph2Class over the stack of the other message-passing families, or for
the generic engine with edge features.

Builds the model's configuration with random seeded weights (Graph2Class:
the benchmark configuration, ``train.default_padding()``, hidden 64, the
``--architecture`` stack, with ``--argmax-routing`` single-winner max
gradients; PPI:
``ppi_padding()``, hidden 256, synthetic graphs of the published PPI sizes,
one graph a batch; VarMisuse: ``vm_padding()``, hidden 64, the
``--architecture`` stack, synthetic samples that fill at least 75 % of the
node budget, ``harness.full_width_samples``; Graph2Seq: ``g2s_padding()``,
``create_graph2seq_model()`` defaults, synthetic samples that fill at least
75 % of the node budget, its ``harness.full_width_samples``), keeps 6
batches on the device, and traces 3 passes over them with
``torch.profiler``: forwards, or with ``--train`` whole training steps
(forward, backward, clip + Adam: clip 1.0 and 2.5e-4 for Graph2Class, 1.0
and 1e-3 for PPI, 0.5 and 1e-4 for VarMisuse, no clip and 1e-3 for
Graph2Seq); ``--amp`` runs either in bf16 AMP. Graph2Seq's ``--decode``
traces ``Graph2Seq.greedy_decode`` of each batch's samples, or
``beam_decode`` with ``--beam-size`` above 1, the host's tensorize and
batching included (the path a serving user waits on). ``--model layers``
is Graph2Class at the benchmark configuration with
``harness.LayersStackCreator``'s stack (PNA, GraphNorm, EGC, self-attention
and MLP-MP layers), and adds the device time of each stack entry, forward
and backward: a kernel counts for the entry in whose forward it ran, or
whose forward op's backward launched it (the profiler's sequence numbers).
``--model edge-features`` is ``ppi.harness.build_edge_feature_gnn`` at
``ppi_padding()`` (hidden 256, 128 edge-feature columns, the 5-layer MLP-MP
stack; the loss the sum of squares of the node states; clip 1.0, 1e-3) on
``synthetic_edge_feature_graphs`` of PPI's sizes, with the same per-entry
breakdown (the edge embedder's gather counts outside the stack).
Prints the wall time per batch, the
device's busy share, the device time by kernel class and the 15 costliest
kernels, and writes a Chrome trace to ``--trace``. Run on a machine with a
CUDA device:

    python -m ptgnn_tpu_torch.utils.profile_serving --trace serving_trace.json
    python -m ptgnn_tpu_torch.utils.profile_serving --train --trace train_trace.json
    python -m ptgnn_tpu_torch.utils.profile_serving --train --architecture ggnn --argmax-routing
    python -m ptgnn_tpu_torch.utils.profile_serving --model ppi --train --amp
    python -m ptgnn_tpu_torch.utils.profile_serving --model varmisuse --architecture ggnn --train
    python -m ptgnn_tpu_torch.utils.profile_serving --model graph2seq --train
    python -m ptgnn_tpu_torch.utils.profile_serving --model graph2seq --decode --beam-size 5
    python -m ptgnn_tpu_torch.utils.profile_serving --model layers --train
    python -m ptgnn_tpu_torch.utils.profile_serving --model edge-features --train --amp
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch

# Kernel-name fragments -> class, first match wins.
CLASSES = (
    ("segment_extremum_argmax_kernel", "argmax extremum kernel"),
    ("segment_extremum_kernel", "extremum kernel"),
    ("broadcast_rows_kernel", "broadcast kernel"),
    ("segment_sum_kernel", "sum kernel"),
    ("typed_matmul", "typed matmul kernel"),
    ("multi_tensor_apply", "optimizer (foreach)"),
    ("sort", "sort"),  # Graph2Seq's beam selection
    ("convolve", "convolution"),  # cuDNN's kernels of VarMisuse's char CNN
    ("fprop", "convolution"),
    ("dgrad", "convolution"),
    ("wgrad", "convolution"),
    ("gemm", "matmul"),
    ("nvjet", "matmul"),  # cuBLAS's bf16 GEMMs on Hopper
    ("cutlass", "matmul"),
    ("gemv", "matmul"),
    ("index", "gather/scatter"),
    ("gather", "gather/scatter"),
    ("scatter", "gather/scatter"),
    ("cat", "concat/copy"),
    ("copy", "concat/copy"),
    ("reduce", "reductions"),
    ("elementwise", "elementwise"),
)


def kernel_class(name: str) -> str:
    lowered = name.lower()
    for fragment, label in CLASSES:
        if fragment in lowered:
            return label
    return "other"


def layer_label(position: int, layer) -> str:
    """A stack entry's profiler range: its position and family."""
    family = type(layer).__name__
    aggregation = getattr(layer, "aggregation_fn", None)
    if aggregation is not None:
        family += f"({aggregation if isinstance(aggregation, str) else type(aggregation).__name__})"
    if getattr(layer, "target_reference", "all") != "all":
        family += f"({layer.target_reference})"
    return f"layer {position} {family}"


def label_layer_ranges(layers) -> list:
    """Hooks that run each stack entry's forward inside a profiler range
    named by :func:`layer_label`; returns their handles."""
    from torch.autograd.profiler import record_function

    open_ranges = []

    def enter(label):
        def hook(module, args):
            ranged = record_function(label)
            ranged.__enter__()
            open_ranges.append(ranged)
        return hook

    def leave(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    handles = []
    for position, layer in enumerate(layers):
        handles.append(layer.register_forward_pre_hook(enter(layer_label(position, layer))))
        handles.append(layer.register_forward_hook(leave))
    return handles


def device_us_by_layer(events) -> dict:
    """{label: [forward us, backward us]} of the kernels that host ops
    launched (each kernel is listed under the op that launched it): an op
    inside a stack entry's range counts for it (forward), and so does an op
    under the autograd engine's evaluation of a backward node whose forward
    op ran in that range (by sequence number). The other ops' kernels go to
    ``"outside the stack"``."""
    def ancestor(evt, prefix):
        while evt is not None:
            if evt.name.startswith(prefix):
                return evt
            evt = evt.cpu_parent
        return None

    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    forward_of = {}
    for evt in cpu:
        ranged = ancestor(evt, "layer ")
        if ranged is not None and evt.sequence_nr >= 0:
            forward_of[evt.sequence_nr] = ranged.name
    totals = defaultdict(lambda: [0.0, 0.0])
    for evt in cpu:
        us = sum(kernel.duration for kernel in evt.kernels)
        if us <= 0:
            continue
        ranged = ancestor(evt, "layer ")
        if ranged is not None:
            totals[ranged.name][0] += us
            continue
        node = ancestor(evt, "autograd::engine::evaluate_function")
        if node is not None and node.sequence_nr in forward_of:
            totals[forward_of[node.sequence_nr]][1] += us
        else:
            totals["outside the stack"][0 if node is None else 1] += us
    return dict(totals)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", default=None, help="Chrome trace output path")
    parser.add_argument("--passes", type=int, default=3)
    parser.add_argument("--train", action="store_true", help="trace training steps, not forwards")
    parser.add_argument("--amp", action="store_true", help="bf16 AMP forwards or training steps")
    parser.add_argument("--model", choices=("graph2class", "ppi", "varmisuse", "graph2seq", "layers",
                                            "edge-features"), default="graph2class")
    parser.add_argument("--decode", action="store_true", help="Graph2Seq: trace the decode of each batch")
    parser.add_argument("--beam-size", type=int, default=1, help="Graph2Seq --decode: 1 is greedy")
    parser.add_argument("--architecture", choices=("mlp", "ggnn"), default="mlp",
                        help="Graph2Class's or VarMisuse's stack")
    parser.add_argument("--argmax-routing", action="store_true",
                        help="Graph2Class: single-winner gradients of the max aggregation")
    args = parser.parse_args()
    if args.decode and (args.model != "graph2seq" or args.train or args.amp):
        parser.error("--decode traces Graph2Seq's float32 decode, not a training step")

    from torch.profiler import ProfilerActivity, profile

    from ptgnn_tpu_torch.core.trainer import module_loss, optimizer_step
    from ptgnn_tpu_torch.graph.structs import tree_to

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as chip_smoke.py holds it against the CPU
    torch.backends.cudnn.allow_tf32 = False  # VarMisuse's char CNN
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if args.model == "ppi":
        from ptgnn_tpu_torch.implementations.ppi.harness import PPI_GRAPH_SIZES, build_ppi, synthetic_ppi_samples
        from ptgnn_tpu_torch.implementations.ppi.train import ppi_padding

        _, module, minibatches = build_ppi(
            padding=ppi_padding(), samples=synthetic_ppi_samples(6, 0, **PPI_GRAPH_SIZES),
            hidden_state_size=256, device=dev,
        )
        lr, clip = 1e-3, 1.0
    elif args.model == "edge-features":
        from ptgnn_tpu_torch.implementations.ppi.harness import (
            PPI_GRAPH_SIZES,
            build_edge_feature_gnn,
            synthetic_edge_feature_graphs,
        )
        from ptgnn_tpu_torch.implementations.ppi.train import ppi_padding

        _, module, minibatches = build_edge_feature_gnn(
            padding=ppi_padding(), graphs=synthetic_edge_feature_graphs(6, 0, **PPI_GRAPH_SIZES), device=dev,
        )
        lr, clip = 1e-3, 1.0
        label_layer_ranges(module.gnn.message_passing_layers)
    elif args.model == "varmisuse":
        from ptgnn_tpu_torch.implementations.varmisuse.harness import build_varmisuse, full_width_samples
        from ptgnn_tpu_torch.implementations.varmisuse.train import vm_padding

        padding = vm_padding()
        _, samples, _ = full_width_samples(6 * padding.max_graphs, padding)
        _, module, minibatches = build_varmisuse(
            padding=padding, samples=samples, architecture=args.architecture, device=dev,
        )
        minibatches = minibatches[:6]
        lr, clip = 1e-4, 0.5
    elif args.model == "graph2seq":
        from ptgnn_tpu_torch.implementations.graph2seq import harness as g2s
        from ptgnn_tpu_torch.implementations.graph2seq.train import g2s_padding

        padding = g2s_padding()
        _, samples, _ = g2s.full_width_samples(6 * padding.max_graphs, padding)
        model, module, minibatches = g2s.build_graph2seq(
            padding=padding, samples=samples, device=dev, minibatch_size=padding.max_graphs)
        minibatches = minibatches[:6]
        print("batches (graphs, nodes, materialized edges, memories):", g2s.batch_sizes(minibatches))
        sample_runs, start = [], 0
        for graphs, *_ in g2s.batch_sizes(minibatches):  # each batch's samples, for --decode
            sample_runs.append(samples[start:start + graphs])
            start += graphs
        lr, clip = 1e-3, None
    else:
        from ptgnn_tpu_torch.implementations.typilus.harness import bench_graph_count, build_graph2class
        from ptgnn_tpu_torch.implementations.typilus.train import default_padding

        _, module, minibatches = build_graph2class(
            padding=default_padding(), num_metadata_graphs=bench_graph_count(6), mean_nodes=2500,
            max_graph_nodes=8000, hidden_state_size=64, num_minibatches=6, minibatch_size=300,
            architecture="layers" if args.model == "layers" else args.architecture,
            argmax_routing=args.argmax_routing, device=dev,
        )
        lr, clip = 2.5e-4, 1.0
        if args.model == "layers":
            label_layer_ranges(module.gnn.message_passing_layers)
    batches = [tree_to(mb, dev) for mb in minibatches]
    optimizer = torch.optim.Adam(module.parameters(), lr=lr)
    generator = torch.Generator(device=dev)

    def work(step: int, minibatch) -> None:
        if args.decode:
            data = sample_runs[step % len(sample_runs)]
            if args.beam_size > 1:
                model.beam_decode(data, module, beam_size=args.beam_size, max_minibatch_size=len(data), device=dev)
            else:
                model.greedy_decode(data, module, max_minibatch_size=len(data), device=dev)
            return
        if not args.train:
            with torch.inference_mode():
                module_loss(module, minibatch, train=False, amp=args.amp)
            return
        generator.manual_seed(step)
        loss, _ = module_loss(module, minibatch, train=True, generator=generator, amp=args.amp)
        loss.backward()
        optimizer_step(module, optimizer, [lr], clip_gradient_norm=clip)

    for step, minibatch in enumerate(batches):  # warm-up
        work(step, minibatch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in range(args.passes):
            for step, minibatch in enumerate(batches):
                work(len(batches) * (p + 1) + step, minibatch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_batches = args.passes * len(batches)

    by_class = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        device_us = getattr(evt, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(evt, "self_cuda_time_total", 0.0)
        if device_us <= 0 or getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(evt, "is_user_annotation", False) or evt.key.startswith(("Optimizer.", "layer ")):
            continue  # a named range (Optimizer.step#Adam.step) spans kernels counted on their own
        by_class[kernel_class(evt.key)] += device_us
        kernels.append((device_us, evt.count, evt.key))
    device_ms = sum(by_class.values()) / 1e3
    summary = {
        "card": card,
        "model": args.model if args.model in ("ppi", "graph2seq", "layers", "edge-features") else
        f"{args.model} {args.architecture}" + (" argmax routing" if args.argmax_routing else ""),
        "mode": (("greedy decode" if args.beam_size == 1 else f"beam-{args.beam_size} decode") if args.decode
                 else "train" if args.train else "serving forward") + (", bf16 AMP" if args.amp else ", float32"),
        "batches": n_batches,
        "wall_ms_per_batch_traced": 1e3 * wall / n_batches,
        "device_ms_per_batch": device_ms / n_batches,
        "device_busy_share": device_ms / (1e3 * wall),
        "device_ms_per_batch_by_class": {
            k: v / 1e3 / n_batches for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])
        },
    }
    if args.model in ("layers", "edge-features"):
        by_layer = device_us_by_layer(prof.events())
        summary["device_ms_per_batch_by_layer"] = {
            label: {"forward": fwd / 1e3 / n_batches, "backward": bwd / 1e3 / n_batches}
            for label, (fwd, bwd) in sorted(by_layer.items())
        }
        summary["device_ms_per_batch_attributed"] = sum(map(sum, by_layer.values())) / 1e3 / n_batches
    print(json.dumps(summary, indent=1))
    for device_us, count, name in sorted(kernels, reverse=True)[:15]:
        print(f"{device_us / 1e3 / n_batches:9.4f} ms/batch  {count // n_batches:4d}/batch  {name[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
