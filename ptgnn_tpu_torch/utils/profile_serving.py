"""Where the time of a Graph2Class serving forward goes on the card.

Builds the benchmark configuration (``train.default_padding()``) with
random seeded weights, keeps 6 batches on the device, and traces 3 passes
over them with ``torch.profiler``. Prints the wall time per batch, the
device's busy share, the device time by kernel class and the 15 costliest
kernels, and writes a Chrome trace to ``--trace``. Run on a machine with a
CUDA device:

    python -m ptgnn_tpu_torch.utils.profile_serving --trace serving_trace.json
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
    ("segment_extremum_kernel", "extremum kernel"),
    ("broadcast_rows_kernel", "broadcast kernel"),
    ("gemm", "matmul"),
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
    args = parser.parse_args()

    from torch.profiler import ProfilerActivity, profile

    from ptgnn_tpu_torch.implementations.typilus.harness import bench_graph_count, build_graph2class
    from ptgnn_tpu_torch.implementations.typilus.train import default_padding

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    _, module, minibatches = build_graph2class(
        padding=default_padding(), num_metadata_graphs=bench_graph_count(6), mean_nodes=2500,
        max_graph_nodes=8000, hidden_state_size=64, num_minibatches=6, minibatch_size=300,
        device=dev,
    )
    module.eval()
    batches = [(mb["batch"].to(dev), torch.from_numpy(mb["target_classes"]).to(dev)) for mb in minibatches]
    with torch.inference_mode():
        for batch, targets in batches:
            module(batch, targets)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.passes):
                for batch, targets in batches:
                    module(batch, targets)
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
        by_class[kernel_class(evt.key)] += device_us
        kernels.append((device_us, evt.count, evt.key))
    device_ms = sum(by_class.values()) / 1e3
    summary = {
        "card": card,
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
