#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (ptgnn_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:

1. device: the card's name and power limit;
2. build: the CUDA kernels, from ptgnn_tpu_torch/csrc, into build/kernels/;
3. serving: Graph2Class inference at the benchmark configuration (8192-node
   batches, 49,152 edge slots, hidden 64, the 12-entry "mlp" stack, random
   seeded weights, synthetic Typilus graphs) through report_accuracy,
   predict and the module's forward, with the kernels' launch counters read
   around it;
4. parity: one batch on the card against the CPU with the same weights, and
   each kernel against its plain PyTorch version, bitwise, at the path's
   shapes;
5. kernels: each kernel's time (CUDA events over a CUDA graph of launches
   on rotating inputs), its bound, its plain version's and one library
   call's time, as one JSON line.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit as nvidia-smi reports them.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SEED = 0
NUM_BATCHES = 6


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def graphs():
    from ptgnn_tpu_torch.implementations.typilus.harness import bench_graph_count
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    return synthetic_typilus_graphs(
        bench_graph_count(NUM_BATCHES), seed=SEED, mean_nodes=2500, max_nodes=8000
    )


def graph_time_ms(calls, reps: int = 5) -> float:
    """Mean device time of one call: the calls are captured into one CUDA
    graph, which is replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls[:2]:
            call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def rotating(make, bytes_per_copy: int, count: int = 16):
    """Input copies enough to spill the 50 MB L2 between calls."""
    copies = max(1, min(count, math.ceil(2 * 50e6 / max(bytes_per_copy, 1))))
    return [make() for _ in range(copies)]


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    from ptgnn_tpu_torch.implementations.typilus.harness import bench_graph_count, build_graph2class
    from ptgnn_tpu_torch.implementations.typilus.train import default_padding
    from ptgnn_tpu_torch.ops import cuda_build
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", f"{kind}; nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build -------------------------------------------------------
    build_s = cuda_build.build_all()
    phase("build", f"{build_s:.2f} s for {sorted(cuda_build.BUILD_LOG) or 'nothing (cached)'}")
    for name, log in sorted(cuda_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "Used" in line:
                phase("build", f"{name}: {line.strip()}")

    # ---- 3. serving at full width ----------------------------------------
    t0 = time.perf_counter()
    model, module, minibatches = build_graph2class(
        padding=default_padding(),
        num_metadata_graphs=bench_graph_count(NUM_BATCHES),
        mean_nodes=2500, max_graph_nodes=8000, hidden_state_size=64, seed=SEED,
        num_minibatches=NUM_BATCHES, minibatch_size=300, device=dev,
    )
    module.eval()
    sizes = [(int(mb["batch"].num_graphs), int(mb["batch"].num_nodes), int(mb["batch"].num_edges))
             for mb in minibatches]
    batches = [(mb["batch"].to(dev), torch.from_numpy(mb["target_classes"]).to(dev)) for mb in minibatches]
    torch.cuda.synchronize()
    phase("serving", f"setup {time.perf_counter() - t0:.2f} s; {len(batches)} batches of "
          f"(graphs, nodes, edges) {sizes}; {len(model.target_vocab)} classes")

    forwards = [0]  # GNN forwards of the main path, one per batch
    counter = module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    sk.reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    accuracy = model.report_accuracy(graphs(), module, max_minibatch_size=300, device=dev)
    t_acc = time.perf_counter() - t0
    t0 = time.perf_counter()
    predictions = list(model.predict(graphs(), module, max_minibatch_size=300, device=dev))
    t_pred = time.perf_counter() - t0
    reps = 5
    with torch.inference_mode():
        for batch, targets in batches:  # warm-up
            module(batch, targets)
        torch.cuda.synchronize()
        losses = []
        t0 = time.perf_counter()
        for _ in range(reps):
            for batch, targets in batches:
                losses.append(module(batch, targets)[0])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    main_counts = sk.launch_counts()  # the main path ends here
    counter.remove()

    losses = torch.stack(losses).cpu().numpy()
    if not (np.isfinite(losses).all() and 0.0 <= accuracy <= 1.0):
        raise RuntimeError(f"bad serving outputs: losses {losses}, accuracy {accuracy}")
    if not predictions or not all(
        all(0.0 < p <= 1.0 and name in model.target_vocab for name, p in preds.values())
        for _, preds in predictions
    ):
        raise RuntimeError("predict returned no graphs or malformed suggestions")
    g, n, e = (reps * sum(s[i] for s in sizes) for i in range(3))
    eval_loss = float(losses[:len(batches)].mean())
    phase("serving", f"report_accuracy {accuracy:.4f} in {t_acc:.2f} s; predict {len(predictions)} "
          f"graphs in {t_pred:.2f} s (host tensorize + batching included)")
    phase("serving", f"eval loss {eval_loss:.6f}; forward over {reps * len(batches)} device-resident "
          f"batches: {g / elapsed:.1f} graphs/s, {n / elapsed:.0f} nodes/s, {e / elapsed:.0f} edges/s "
          f"({1e3 * elapsed / (reps * len(batches)):.3f} ms/batch) on {card}")
    phase("serving", f"launches over the main path's {forwards[0]} forwards: {main_counts}")
    if min(main_counts.values()) <= 0:
        raise RuntimeError(f"a kernel of the path was never launched: {main_counts}")
    per_batch = {k: v / forwards[0] for k, v in main_counts.items()}
    if per_batch != {"segment_extremum": 8, "broadcast_to_edges": 8}:
        raise RuntimeError(f"expected 8 + 8 kernel launches per forward, got {per_batch}")
    per_batch = {k: int(v) for k, v in per_batch.items()}

    # ---- 4. parity --------------------------------------------------------
    cpu_module = model.build_neural_module(device="cpu", seed=SEED).eval()
    for (k, a), b in zip(module.state_dict().items(), cpu_module.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise RuntimeError(f"the CPU module's weights differ at {k}")
    def record_layers(m, outs):
        """Hooks that keep the embedder's and each MP layer's output."""
        def keep(_module, _inputs, out):
            outs.append(out.float().cpu())

        layers = [m.gnn.node_embedder] + [
            layer for layer in m.gnn.message_passing_layers if type(layer).__name__ == "MlpMessagePassingLayer"
        ]
        return [layer.register_forward_hook(keep) for layer in layers]

    gpu_layers, cpu_layers = [], []
    hooks = record_layers(module, gpu_layers) + record_layers(cpu_module, cpu_layers)
    with torch.inference_mode():
        gpu_logits = module._logits(batches[0][0], train=False)[0].cpu().numpy()
        cpu_logits = cpu_module._logits(minibatches[0]["batch"].to("cpu"), train=False)[0].numpy()
    for hook in hooks:
        hook.remove()
    layer_err = [f"{float((g - c).abs().max()):.3e}" for g, c in zip(gpu_layers, cpu_layers)]
    phase("parity", f"card vs CPU max abs err after the embedder and each of the "
          f"{len(layer_err) - 1} MP layers: {layer_err}")
    atol = 1e-4 * float(np.abs(cpu_logits).max())
    err = float(np.abs(gpu_logits - cpu_logits).max())
    np.testing.assert_allclose(gpu_logits, cpu_logits, rtol=1e-4, atol=atol)
    top2 = np.sort(cpu_logits, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal(gpu_logits.argmax(-1)[decided], cpu_logits.argmax(-1)[decided])
    phase("parity", f"logits card vs CPU: max abs err {err:.3e} (rtol 1e-4, atol {atol:.3e} = 1e-4 "
          f"x max|logit|); argmax equal on {int(decided.sum())}/{len(decided)} decided slots")

    adj = batches[0][0].adjacency
    num_nodes = adj.agg_counts.numel()
    ext_plan = sk.plan_from_adjacency(adj)
    bc_plan = sk.sum_plan_from_adjacency(adj)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    neutral = {  # the wrapper's masked value per (dtype, max?)
        (torch.float32, True): -3.0e38, (torch.float32, False): 3.0e38,
        (torch.bfloat16, True): torch.finfo(torch.bfloat16).min,
        (torch.bfloat16, False): torch.finfo(torch.bfloat16).max,
    }

    def masked_messages(width, dtype, is_max):
        data = torch.randn(adj.mask.shape[0], width, device=dev, generator=gen).to(dtype)
        fill = torch.full((), neutral[(dtype, is_max)], dtype=dtype, device=dev)
        return torch.where(adj.mask[:, None], data, fill).contiguous()

    checks = []
    max_abs_err = {"broadcast_to_edges": 0.0, "segment_extremum": 0.0}

    def hold(name, got, plain, case):
        err = float((got.float() - plain.float()).abs().max())
        max_abs_err[name] = max(max_abs_err[name], err)
        if not bitwise_equal(got, plain):
            raise RuntimeError(f"{name} kernel != plain version at {case} (max abs err {err})")

    for width in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn(num_nodes, width, device=dev, generator=gen).to(dtype)
            hold("broadcast_to_edges", sk.planned_broadcast_to_edges(table, bc_plan),
                 sk.broadcast_plain(table, bc_plan), (width, dtype))
            for is_max in (True, False):
                data = masked_messages(width, dtype, is_max)
                hold("segment_extremum", sk.planned_segment_extremum(data, ext_plan, num_nodes, is_max),
                     sk.segment_extremum_plain(data, ext_plan, num_nodes, is_max), (width, dtype, is_max))
            checks.append(f"{width}/{str(dtype)[6:]}")
    torch.cuda.synchronize()
    phase("parity", f"kernels == plain versions bitwise at D/M and dtype {checks} (max and min)")

    # ---- 5. kernel timings -------------------------------------------------
    e_pad = adj.mask.shape[0]
    real = adj.mask
    e_real = int(real.sum())
    recv_rows = int(torch.unique(adj.receivers[real]).numel())
    n_super = bc_plan.tile_row_blocks.numel()
    num_blocks = adj.agg_counts.shape[0]
    valid = adj.receivers < num_nodes
    safe_recv = torch.where(valid, adj.receivers, 0).long()
    kernels = []
    for width in (64, 128):
        # the path's float32 shapes: D = M = 64 before the residuals, 128 after
        tables = rotating(lambda: torch.randn(num_nodes, width, device=dev, generator=gen),
                          num_nodes * width * 4)
        datas = rotating(lambda: masked_messages(width, torch.float32, True), e_pad * width * 4)
        scatter_index = torch.where(valid, adj.receivers, num_nodes).long()[:, None].expand(-1, width).contiguous()

        def calls(fn, inputs):
            return [lambda x=inputs[i % len(inputs)]: fn(x) for i in range(16)]

        bc = {
            "ms": graph_time_ms(calls(lambda t: sk.planned_broadcast_to_edges(t, bc_plan), tables)),
            "plain_ms": graph_time_ms(calls(lambda t: sk.broadcast_plain(t, bc_plan), tables)),
            "library_ms": graph_time_ms(calls(
                lambda t: torch.where(valid[:, None], t.index_select(0, safe_recv), 0.0), tables)),
        }
        bc_bytes = recv_rows * width * 4 + e_pad * 4 + n_super * 4 + e_pad * width * 4
        ext = {
            "ms": graph_time_ms(calls(lambda d: sk.planned_segment_extremum(d, ext_plan, num_nodes, True), datas)),
            "plain_ms": graph_time_ms(calls(lambda d: sk.segment_extremum_plain(d, ext_plan, num_nodes, True), datas)),
            "library_ms": graph_time_ms(calls(
                lambda d: torch.zeros(num_nodes + 1, width, device=dev).scatter_reduce_(
                    0, scatter_index, d, "amax", include_self=False), datas)),
        }
        ext_bytes = (e_real * width * 4 + e_pad * 4 + (num_blocks + 1) * 8 + num_nodes * 4
                     + num_nodes * width * 4)
        ext_ops = e_real * width
        for name, times, nbytes, ops, source, replaces, launches in (
            ("broadcast_to_edges", bc, bc_bytes, 0, "ptgnn_tpu_torch/csrc/broadcast_rows.cu",
             "ptgnn_tpu/ops/pallas/segment_kernels.py:233", main_counts["broadcast_to_edges"]),
            ("segment_extremum", ext, ext_bytes, ext_ops, "ptgnn_tpu_torch/csrc/segment_extremum.cu",
             "ptgnn_tpu/ops/pallas/segment_kernels.py:370", main_counts["segment_extremum"]),
        ):
            bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            ops_ms = 1e3 * ops / F32_OPS_PER_S
            entry = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_per_batch": per_batch[name],
                "max_abs_err": max_abs_err[name],
                "ms": times["ms"], "plain_ms": times["plain_ms"],
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": times["library_ms"], "width": width, "dtype": "float32",
            }
            if width == 64:
                kernels.append(entry)
            phase("kernels", json.dumps(entry))
    torch.cuda.synchronize()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
