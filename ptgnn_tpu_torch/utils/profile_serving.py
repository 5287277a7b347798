"""Where the time of a serving forward, or of a training step, goes on the
card, for Graph2Class or PPI.

Builds the model's configuration with random seeded weights (Graph2Class:
the benchmark configuration, ``train.default_padding()``, hidden 64, the
``--architecture`` stack, with ``--argmax-routing`` single-winner max
gradients; PPI:
``ppi_padding()``, hidden 256, synthetic graphs of the published PPI sizes,
one graph a batch), keeps 6 batches on the device, and traces 3 passes over
them with ``torch.profiler``: forwards, or with ``--train`` whole training
steps (forward, backward, clip(1.0) + Adam: 2.5e-4 for Graph2Class, 1e-3 for
PPI); ``--amp`` runs either in bf16 AMP. Prints the wall time per batch, the
device's busy share, the device time by kernel class and the 15 costliest
kernels, and writes a Chrome trace to ``--trace``. Run on a machine with a
CUDA device:

    python -m ptgnn_tpu_torch.utils.profile_serving --trace serving_trace.json
    python -m ptgnn_tpu_torch.utils.profile_serving --train --trace train_trace.json
    python -m ptgnn_tpu_torch.utils.profile_serving --train --architecture ggnn --argmax-routing
    python -m ptgnn_tpu_torch.utils.profile_serving --model ppi --train --amp
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", default=None, help="Chrome trace output path")
    parser.add_argument("--passes", type=int, default=3)
    parser.add_argument("--train", action="store_true", help="trace training steps, not forwards")
    parser.add_argument("--amp", action="store_true", help="bf16 AMP forwards or training steps")
    parser.add_argument("--model", choices=("graph2class", "ppi"), default="graph2class")
    parser.add_argument("--architecture", choices=("mlp", "ggnn"), default="mlp", help="Graph2Class's stack")
    parser.add_argument("--argmax-routing", action="store_true",
                        help="Graph2Class: single-winner gradients of the max aggregation")
    args = parser.parse_args()

    from torch.profiler import ProfilerActivity, profile

    from ptgnn_tpu_torch.core.trainer import module_loss, optimizer_step
    from ptgnn_tpu_torch.graph.structs import tree_to

    torch.backends.cuda.matmul.allow_tf32 = False
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
        lr = 1e-3
    else:
        from ptgnn_tpu_torch.implementations.typilus.harness import bench_graph_count, build_graph2class
        from ptgnn_tpu_torch.implementations.typilus.train import default_padding

        _, module, minibatches = build_graph2class(
            padding=default_padding(), num_metadata_graphs=bench_graph_count(6), mean_nodes=2500,
            max_graph_nodes=8000, hidden_state_size=64, num_minibatches=6, minibatch_size=300,
            architecture=args.architecture, argmax_routing=args.argmax_routing, device=dev,
        )
        lr = 2.5e-4
    batches = [tree_to(mb, dev) for mb in minibatches]
    optimizer = torch.optim.Adam(module.parameters(), lr=lr)
    generator = torch.Generator(device=dev)

    def work(step: int, minibatch) -> None:
        if not args.train:
            with torch.inference_mode():
                module_loss(module, minibatch, train=False, amp=args.amp)
            return
        generator.manual_seed(step)
        loss, _ = module_loss(module, minibatch, train=True, generator=generator, amp=args.amp)
        loss.backward()
        optimizer_step(module, optimizer, [lr], clip_gradient_norm=1.0)

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
        if getattr(evt, "is_user_annotation", False) or "#" in evt.key:
            continue  # a named range (Optimizer.step#Adam.step) spans kernels counted on their own
        by_class[kernel_class(evt.key)] += device_us
        kernels.append((device_us, evt.count, evt.key))
    device_ms = sum(by_class.values()) / 1e3
    summary = {
        "card": card,
        "model": args.model if args.model == "ppi" else
        f"graph2class {args.architecture}" + (" argmax routing" if args.argmax_routing else ""),
        "mode": ("train" if args.train else "serving forward") + (", bf16 AMP" if args.amp else ", float32"),
        "batches": n_batches,
        "wall_ms_per_batch_traced": 1e3 * wall / n_batches,
        "device_ms_per_batch": device_ms / n_batches,
        "device_busy_share": device_ms / (1e3 * wall),
        "device_ms_per_batch_by_class": {
            k: v / 1e3 / n_batches for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])
        },
    }
    print(json.dumps(summary, indent=1))
    for device_us, count, name in sorted(kernels, reverse=True)[:15]:
        print(f"{device_us / 1e3 / n_batches:9.4f} ms/batch  {count // n_batches:4d}/batch  {name[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
