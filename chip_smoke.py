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
   around it (8 extremum + 8 broadcast launches per forward);
4. train: the training step at the same configuration through
   ModelTrainer.train (one epoch, validation before and after) and the
   harness's train_steps loop in float32 and in bf16 AMP, with the counters
   read around the whole phase and around each train_steps loop (per step:
   8 extremum, 24 broadcast and 16 sum launches);
5. parity: one batch on the card against the CPU with the same weights, and
   each kernel against its plain PyTorch version at the path's shapes
   (bitwise for the broadcast and the extremum; within 1e-5 of each row's
   sum of |x| for the sum, bitwise on 0/1 data and from run to run);
6. train-parity: one train step (dropout 0) on the card against the CPU:
   the loss; each MP layer alone on the same inputs (bitwise aggregates, the
   same routing, every gradient to rtol 1e-4 and 1e-4 of its largest
   magnitude); the whole step's gradients within 1e-2 of their norms, with
   the routing differences that a few-ulp forward difference causes; the
   clip + Adam step on equal gradients; a tie count >= 1 for every
   non-empty (node, column) of every MP layer in both orientations of the
   backward; and a train step that repeats bit for bit;
7. ppi-serving: PPI at its reference width (hidden 256, 4,096-node batches
   of 122,880 edge slots, a Tanh feature embedder, 5 sum MLP-MP layers in two
   mean residual blocks, random seeded weights) on synthetic graphs of the
   published PPI sizes (50 features, 121 labels, about 2,372 nodes and 14.4
   edges per node), one graph a batch: report_metrics, and the forward over
   device-resident batches in float32 and in bf16 AMP eval, with the
   counters read around each (per forward: 5 broadcast and 5 sum launches,
   and 5 typed matmul launches in bf16);
8. ppi-train: ModelTrainer.train for one epoch with validation under bf16
   AMP, then train_steps in float32 and in bf16 AMP (per step: 10 broadcast,
   10 sum, and 15 typed matmul launches in bf16, 0 in float32);
9. ppi-parity: the float32 forward and a float32 train step (dropout 0) on
   the card against the CPU, elementwise; a bf16 AMP step (the typed matmul
   kernel) against the CPU's plain route; the typed matmul against float64
   at both PPI shapes in both dtypes, bitwise from run to run and under tile
   and row permutations; the sum at 256 and 512 and the broadcast at 256 on
   the PPI layout; a bf16 AMP step with dropout that repeats bit for bit;
10. kernels: each kernel's time (CUDA events over a CUDA graph of launches
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
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 dense tensor cores
SEED = 0
NUM_BATCHES = 6
TRAIN_STEPS = 30
PER_FORWARD = {"segment_extremum": 8, "broadcast_to_edges": 8, "segment_sum": 0, "typed_matmul": 0}
PER_TRAIN_STEP = {"segment_extremum": 8, "broadcast_to_edges": 24, "segment_sum": 16, "typed_matmul": 0}
# PPI: per MP layer one broadcast (target rows) and one sum forward, one
# broadcast (g rows) and one sum (both cotangents) backward; the typed matmul
# once forward and twice backward, where its gate opens (bf16 only).
PPI_GRAPHS = 6
PPI_TRAIN_STEPS = 20
PPI_PER_FORWARD = {
    "float32": {"segment_extremum": 0, "broadcast_to_edges": 5, "segment_sum": 5, "typed_matmul": 0},
    "bf16": {"segment_extremum": 0, "broadcast_to_edges": 5, "segment_sum": 5, "typed_matmul": 5},
}
PPI_PER_TRAIN_STEP = {
    "float32": {"segment_extremum": 0, "broadcast_to_edges": 10, "segment_sum": 10, "typed_matmul": 0},
    "bf16": {"segment_extremum": 0, "broadcast_to_edges": 10, "segment_sum": 10, "typed_matmul": 15},
}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def graphs(seed: int = SEED):
    from ptgnn_tpu_torch.implementations.typilus.harness import bench_graph_count
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    return synthetic_typilus_graphs(
        bench_graph_count(NUM_BATCHES), seed=seed, mean_nodes=2500, max_nodes=8000
    )


def delta(after, before):
    return {k: after[k] - before[k] for k in after}


def add_counts(a, b):
    return {k: a[k] + b[k] for k in a}


def set_dropout(module, rate: float) -> None:
    for sub in module.modules():
        if hasattr(sub, "dropout_rate"):
            sub.dropout_rate = rate


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


def event_time_ms(calls, reps: int = 3) -> float:
    """Mean time of one call between CUDA events, for calls that synchronise
    (and so cannot be captured into a CUDA graph)."""
    for call in calls[:2]:
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for call in calls:
            call()
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


def train_phase(model, batches, dev, card):
    """ModelTrainer.train for one epoch, then train_steps in float32 and in
    bf16 AMP. Returns the launch counts over the whole phase."""
    from ptgnn_tpu_torch.core.trainer import ModelTrainer
    from ptgnn_tpu_torch.implementations.typilus.harness import train_steps
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    train_graphs, valid_graphs = list(graphs(SEED)), list(graphs(SEED + 1))
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    trainer = ModelTrainer(
        model, out_dir / "graph2class.pkl.gz", max_num_epochs=1, minibatch_size=300,
        clip_gradient_norm=1.0, optimizer_creator=lambda p: torch.optim.Adam(p, lr=2.5e-4),
        device=dev, seed=SEED,
    )
    trainer.load_metadata_and_create_network(train_graphs, parallelize=False)
    module = trainer.neural_module
    forwards, backwards = [0], [0]
    hooks = [
        module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1)),
        module.node_to_class.weight.register_hook(lambda g: backwards.__setitem__(0, backwards[0] + 1)),
    ]
    valid_metrics = []
    trainer.register_validation_epoch_end_hook(lambda m, mod, e, metrics: valid_metrics.append(metrics))
    sk.reset_launch_counts()  # the train path starts here
    t0 = time.perf_counter()
    trainer.train(train_graphs, valid_graphs, initialize_metadata=False, patience=0)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    phase("train", f"ModelTrainer.train: 1 epoch over {len(train_graphs)} graphs with validation "
          f"before and after in {t_train:.2f} s (host tensorize + batching included): "
          f"{backwards[0]} train steps, {forwards[0] - backwards[0]} validation forwards; "
          f"validation metrics {valid_metrics}")
    if backwards[0] == 0 or not (out_dir / "graph2class.pkl.gz").exists():
        raise RuntimeError("ModelTrainer.train took no step or wrote no checkpoint")
    for name, amp in (("float32", False), ("bf16 AMP", True)):
        steps_module = model.build_neural_module(device=dev, seed=SEED)
        before = sk.launch_counts()
        stats = train_steps(steps_module, [{"batch": b, "target_classes": t} for b, t in batches],
                            steps=TRAIN_STEPS, enable_amp=amp, seed=SEED)
        per_step = {k: v / (TRAIN_STEPS + 1) for k, v in delta(sk.launch_counts(), before).items()}
        if per_step != PER_TRAIN_STEP:
            raise RuntimeError(f"expected {PER_TRAIN_STEP} launches per train step, got {per_step}")
        if not math.isfinite(stats["loss"]):
            raise RuntimeError(f"train_steps ({name}) gave a non-finite loss {stats['loss']}")
        phase("train", f"train_steps {name}: {TRAIN_STEPS} steps after 1 warm-up, loss {stats['loss']:.6f}, "
              f"{stats['ms_per_step']:.3f} ms/step, {stats['graphs_per_s']:.1f} graphs/s, "
              f"{stats['nodes_per_s']:.0f} nodes/s, {stats['edges_per_s']:.0f} edges/s on {card}; "
              f"launches per step {per_step}")
    counts = sk.launch_counts()  # the train path ends here
    for hook in hooks:
        hook.remove()
    expected = {
        k: PER_FORWARD[k] * forwards[0] + (PER_TRAIN_STEP[k] - PER_FORWARD[k]) * backwards[0]
        + PER_TRAIN_STEP[k] * 2 * (TRAIN_STEPS + 1)
        for k in counts
    }
    phase("train", f"launches over the train path: {counts}")
    if counts != expected:
        raise RuntimeError(f"train path launches {counts} != {expected} expected from its "
                           f"{forwards[0]} forwards and {backwards[0]} backwards in ModelTrainer.train")
    return counts


def train_parity_phase(model, device_batch, host_minibatch, dev):
    """One float32 train step with dropout 0 on the card against the CPU.

    Max aggregation routes each (node, column)'s gradient to the slots that
    attain the maximum, so a near-tie that the two devices' few-ulp forward
    differences order differently moves a gradient wholesale, and everything
    upstream of that layer inherits the difference. Hence the gates: the
    loss; each MP layer alone, from the CPU's inputs and upstream cotangent
    (aggregates bitwise equal, no slot routed differently, every gradient
    within rtol 1e-4 and 1e-4 of its tensor's largest magnitude); the whole
    step end to end within 1e-2 of each gradient's norm, printed beside the
    elementwise tolerance and the routing differences between the two runs."""
    from ptgnn_tpu_torch.core.trainer import module_loss, optimizer_step
    from ptgnn_tpu_torch.graph.messagepassing.base import GraphContext
    from ptgnn_tpu_torch.ops import fused_mp

    gpu = model.build_neural_module(device=dev, seed=SEED)
    cpu = model.build_neural_module(device="cpu", seed=SEED)
    for m in (gpu, cpu):
        set_dropout(m, 0.0)
    initial = {k: v.detach().clone() for k, v in gpu.state_dict().items()}

    def mlp_layers(m):
        return [layer for layer in m.gnn.message_passing_layers if type(layer).__name__ == "MlpMessagePassingLayer"]

    inputs = {"gpu": [], "cpu": []}
    upstream = {}  # CPU cotangent of each MP layer's output

    def keep_upstream(index):
        def hook(_module, _args, out):
            out.register_hook(lambda g: upstream.__setitem__(index, g.detach()))
        return hook

    hooks = [layer.register_forward_pre_hook(lambda mod, args, k=k: inputs[k].append(args[0].detach()))
             for k, m in (("gpu", gpu), ("cpu", cpu)) for layer in mlp_layers(m)]
    hooks += [layer.register_forward_hook(keep_upstream(i)) for i, layer in enumerate(mlp_layers(cpu))]
    batch, targets = device_batch
    gpu_loss, _ = module_loss(gpu, {"batch": batch, "target_classes": targets}, train=True,
                              generator=torch.Generator(device=dev))
    gpu_loss.backward()
    cpu_batch = host_minibatch["batch"].to("cpu")
    cpu_targets = torch.from_numpy(host_minibatch["target_classes"])
    cpu_loss, _ = module_loss(cpu, {"batch": cpu_batch, "target_classes": cpu_targets}, train=True,
                              generator=torch.Generator())
    cpu_loss.backward()
    for hook in hooks:
        hook.remove()
    gpu_loss, cpu_loss = float(gpu_loss.detach()), float(cpu_loss.detach())
    np.testing.assert_allclose(gpu_loss, cpu_loss, rtol=1e-5)
    # (name, card gradient on the host, CPU gradient) of the whole step
    step_grads = [(name, pg.grad.cpu(), pc.grad.clone())
                  for (name, pg), pc in zip(gpu.named_parameters(), cpu.parameters())]

    def beyond(got, want):
        """Elements outside rtol 1e-4, atol 1e-4 x max|want|."""
        return int(((got - want).abs() > 1e-4 * want.abs() + 1e-4 * want.abs().max()).sum())

    # Each MP layer alone, on the same inputs and upstream cotangent.
    def context(b):
        return GraphContext(adjacency=b.adjacency, node_graph=b.node_graph, node_mask=b.node_mask,
                            graph_mask=b.graph_mask, references=b.references)

    local_worst = 0.0
    for index, (lg, lc) in enumerate(zip(mlp_layers(gpu), mlp_layers(cpu))):
        x, g_out = inputs["cpu"][index], upstream[index]
        xg, xc = x.to(dev).clone().requires_grad_(), x.clone().requires_grad_()
        lg.zero_grad()
        lc.zero_grad()
        lg(xg, context(batch), train=True).backward(g_out.to(dev))
        lc(xc, context(cpu_batch), train=True).backward(g_out)
        w = lc.message_mlp.weights_0.detach()
        out_c, inp_c = fused_mp._fused_fwd_impl(x, w, cpu_batch.adjacency, None, x.shape[0], "max", True, 1.0)
        out_g, inp_g = fused_mp._fused_fwd_impl(x.to(dev), w.to(dev), batch.adjacency, None, x.shape[0], "max", True, 1.0)
        rerouted = int((fused_mp._primary_indicator(inp_g, w.to(dev), batch.adjacency, out_g, torch.float32).cpu()
                        != fused_mp._primary_indicator(inp_c, w, cpu_batch.adjacency, out_c, torch.float32)).sum())
        if rerouted or not bitwise_equal(out_g.cpu(), out_c):
            raise RuntimeError(f"MP layer {index} alone: aggregates differ or {rerouted} slots routed differently")
        pairs = [("input", xg.grad, xc.grad)] + [
            (name, pg.grad, pc.grad) for (name, pg), pc in zip(lg.named_parameters(), lc.parameters())]
        for name, got, want in pairs:
            got = got.cpu()
            if beyond(got, want):
                raise RuntimeError(f"MP layer {index} alone: the {name} gradient is off in {beyond(got, want)} elements")
            local_worst = max(local_worst, float((got - want).abs().max() / want.abs().max()))
    phase("train-parity", f"loss card {gpu_loss:.7f} vs CPU {cpu_loss:.7f} (rtol 1e-5); each of the "
          f"{len(mlp_layers(gpu))} MP layers alone, on the CPU's inputs and upstream gradient: aggregates "
          f"bitwise equal, no slot routed differently, every gradient within rtol 1e-4, atol 1e-4 x max|g| "
          f"(worst {local_worst:.3e} of max)")

    # The whole step end to end, and the routing differences that explain it.
    rerouted = []
    for lg, xg_in, xc_in in zip(mlp_layers(gpu), inputs["gpu"], inputs["cpu"]):
        w = lg.message_mlp.weights_0.detach()
        out_g, inp_g = fused_mp._fused_fwd_impl(xg_in, w, batch.adjacency, None, xg_in.shape[0], "max", True, 1.0)
        out_c, inp_c = fused_mp._fused_fwd_impl(xc_in, w.cpu(), cpu_batch.adjacency, None, xc_in.shape[0], "max", True, 1.0)
        rerouted.append(int((fused_mp._primary_indicator(inp_g, w, batch.adjacency, out_g, torch.float32).cpu()
                             != fused_mp._primary_indicator(inp_c, w.cpu(), cpu_batch.adjacency, out_c, torch.float32)).sum()))
    report, outside = [], []
    for name, got, want in step_grads:
        rel = float((got - want).norm() / want.norm())
        report.append((rel, name))
        if beyond(got, want):
            outside.append(name)
        if rel > 1e-2:
            raise RuntimeError(f"end to end, the {name} gradient differs by {rel:.3e} of its norm")
    report.sort(reverse=True)
    phase("train-parity", f"end to end: slots routed differently per MP layer {rerouted}; every gradient "
          f"within 1e-2 of its norm (largest {report[0][0]:.3e}, {report[0][1]}); {len(outside)} of "
          f"{len(report)} tensors outside rtol 1e-4, atol 1e-4 x max|g|: {outside}")

    # Every non-empty (node, column) of every MP layer must find its extremum
    # again in both orientations of the backward, which compare messages
    # recomputed by the card's matmuls with ``==``; at bf16 too.
    adj = batch.adjacency
    n = inputs["gpu"][0].shape[0]
    nonempty = adj.agg_counts.reshape(-1)[:n] > 0
    layers = [layer for layer in gpu.gnn.message_passing_layers if type(layer).__name__ == "MlpMessagePassingLayer"]
    most = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for index, (layer, x) in enumerate(zip(layers, inputs["gpu"])):
            ties, ties_tr = fused_mp.tie_counts(x.to(dtype), layer.message_mlp.weights_0.detach().to(dtype), adj)
            if not (bool((ties[nonempty] >= 1).all()) and bool((ties_tr[nonempty] >= 1).all())
                    and torch.equal(ties, ties_tr)):
                raise RuntimeError(f"MP layer {index} ({dtype}): a non-empty (node, column) has no tie "
                                   f"in one orientation, or the orientations disagree")
            most = max(most, float(ties.max()))
    phase("train-parity", f"tie counts >= 1 and equal in both orientations for all "
          f"{int(nonempty.sum())} non-empty nodes x every column of the {len(layers)} MP layers, "
          f"float32 and bf16 (largest tie {most:.0f})")

    # The clip + Adam step. Held on the same (the CPU's) gradients on both
    # sides: Adam divides each gradient by its own magnitude, so an entry
    # near zero turns the float32 noise that the gradient check allows into
    # up to a whole learning rate. The step from the card's own gradients is
    # reported beside it.
    lr = 2.5e-4
    cpu_grads = [want for _, _, want in step_grads]
    for (_, got, want), pg, pc in zip(step_grads, gpu.parameters(), cpu.parameters()):
        pg.grad, pc.grad = got.to(dev), want.clone()
    optimizer_step(gpu, torch.optim.Adam(gpu.parameters(), lr=lr), [lr], clip_gradient_norm=1.0)
    own = [p.detach().cpu().clone() for p in gpu.parameters()]
    optimizer_step(cpu, torch.optim.Adam(cpu.parameters(), lr=lr), [lr], clip_gradient_norm=1.0)
    gpu.load_state_dict(initial)
    for pg, g in zip(gpu.parameters(), cpu_grads):
        pg.grad = g.to(dev)
    optimizer_step(gpu, torch.optim.Adam(gpu.parameters(), lr=lr), [lr], clip_gradient_norm=1.0)
    beyond, own_worst = 0, 0.0
    for (name, pg), pc, po in zip(gpu.named_parameters(), cpu.parameters(), own):
        c = pc.detach().numpy()
        np.testing.assert_allclose(pg.detach().cpu().numpy(), c, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(c).max()), err_msg=name)
        diff = np.abs(po.numpy() - c)
        beyond += int((diff > 1e-4 * np.abs(c) + 1e-4 * float(np.abs(c).max())).sum())
        own_worst = max(own_worst, float(diff.max()) / lr)
    phase("train-parity", f"clip + Adam on equal gradients: every parameter within rtol 1e-4, atol 1e-4 x "
          f"max|p|; from the card's own gradients the largest parameter difference is {own_worst:.3e} "
          f"learning rates, {beyond} elements beyond that tolerance")


def repeat_check(model, device_batch, dev):
    """Two train steps from the same weights and dropout seed give the same
    bits: every kernel and reduction of the step adds in a fixed order."""
    from ptgnn_tpu_torch.core.trainer import module_loss

    batch, targets = device_batch
    for name, amp in (("float32", False), ("bf16 AMP", True)):
        runs = []
        for _ in range(2):
            m = model.build_neural_module(device=dev, seed=SEED)
            loss, _ = module_loss(m, {"batch": batch, "target_classes": targets}, train=True,
                                  generator=torch.Generator(device=dev).manual_seed(SEED), amp=amp)
            loss.backward()
            runs.append([loss.detach()] + [p.grad for p in m.parameters()])
        differ = sum(not torch.equal(a, b) for a, b in zip(*runs))
        if differ:
            raise RuntimeError(f"a {name} train step gave other bits on a second run in {differ} tensors")
    phase("train-parity", f"a train step (dropout on) repeats bit for bit, float32 and bf16 AMP: the loss "
          f"and all {len(runs[0]) - 1} gradient tensors")


def ppi_setup(dev, card):
    """The PPI model at its reference width on synthetic graphs of the
    published sizes: (model, module on the card, samples, host minibatches,
    device-resident minibatches)."""
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.implementations.ppi.harness import PPI_GRAPH_SIZES, build_ppi, synthetic_ppi_samples
    from ptgnn_tpu_torch.implementations.ppi.train import ppi_padding

    samples = synthetic_ppi_samples(PPI_GRAPHS, SEED, **PPI_GRAPH_SIZES)
    t0 = time.perf_counter()
    model, module, minibatches = build_ppi(padding=ppi_padding(), samples=samples, hidden_state_size=256,
                                           seed=SEED, device=dev)
    t_host = time.perf_counter() - t0
    batches = [tree_to(mb, dev) for mb in minibatches]
    torch.cuda.synchronize()
    sizes = [(int(mb["batch"].num_graphs), int(mb["batch"].num_nodes), int(mb["batch"].num_edges))
             for mb in minibatches]
    adj = minibatches[0]["batch"].adjacency
    phase("ppi-serving", f"host metadata + tensorize + batching of {len(samples)} graphs: {t_host:.2f} s "
          f"({1e3 * t_host / len(samples):.0f} ms/graph); {len(batches)} batches of (graphs, nodes, edges) "
          f"{sizes}; {adj.mask.shape[0]} edge slots in {adj.tile_types.shape[0]} tiles of {adj.edge_tile}, "
          f"{[int(mb['batch'].adjacency.mask.sum()) for mb in minibatches]} valid; message weights "
          f"{tuple(module.gnn.message_passing_layers[1].message_mlp.weights_0.shape)}")
    return model, module, samples, minibatches, batches


def ppi_serving_phase(model, module, samples, batches, dev, card, reps: int = 3):
    """report_metrics, then the forward over device-resident batches in
    float32 and in bf16 AMP eval. Returns the launch counts of the path."""
    from ptgnn_tpu_torch.core.trainer import module_loss
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    module.eval()
    forwards = [0]
    counter = module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    sk.reset_launch_counts()  # the ppi-serving path starts here
    t0 = time.perf_counter()
    metrics = model.report_metrics(samples, module, device=dev)
    t_report = time.perf_counter() - t0
    report_forwards = forwards[0]
    if not all(0.0 <= v <= 1.0 for v in metrics.values()) or set(metrics) != {"f1_score", "pr_score", "re_score"}:
        raise RuntimeError(f"report_metrics gave {metrics}")
    phase("ppi-serving", f"report_metrics {metrics} over {len(samples)} graphs in {t_report:.2f} s "
          f"({report_forwards} forwards; host tensorize + batching included)")
    sizes = [(int(mb["batch"].num_graphs), int(mb["batch"].num_nodes), int(mb["batch"].num_edges)) for mb in batches]
    g, n, e = (reps * sum(s[i] for s in sizes) for i in range(3))
    eval_losses = {}
    for name, amp in (("float32", False), ("bf16", True)):
        before, before_forwards = sk.launch_counts(), forwards[0]
        with torch.inference_mode():
            for mb in batches:  # warm-up
                module_loss(module, mb, train=False, amp=amp)
            torch.cuda.synchronize()
            losses = []
            t0 = time.perf_counter()
            for _ in range(reps):
                for mb in batches:
                    losses.append(module_loss(module, mb, train=False, amp=amp)[0])
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        per_forward = {k: v / (forwards[0] - before_forwards) for k, v in delta(sk.launch_counts(), before).items()}
        if per_forward != PPI_PER_FORWARD[name]:
            raise RuntimeError(f"expected {PPI_PER_FORWARD[name]} launches per {name} forward, got {per_forward}")
        losses = torch.stack(losses).cpu().numpy()
        if not np.isfinite(losses).all():
            raise RuntimeError(f"non-finite {name} eval losses {losses}")
        eval_losses[name] = float(losses[:len(batches)].mean())
        phase("ppi-serving", f"{name} forward over {reps * len(batches)} device-resident batches: eval loss "
              f"{eval_losses[name]:.6f}, {1e3 * elapsed / (reps * len(batches)):.3f} ms/batch, "
              f"{g / elapsed:.2f} graphs/s, {n / elapsed:.0f} nodes/s, {e / elapsed:.0f} edges/s on {card}; "
              f"launches per forward {per_forward}")
    counts = sk.launch_counts()  # the ppi-serving path ends here
    counter.remove()
    if abs(eval_losses["bf16"] - eval_losses["float32"]) > 2e-2 * abs(eval_losses["float32"]):
        raise RuntimeError(f"bf16 eval loss {eval_losses['bf16']} is not within 2e-2 of float32's")
    n_bf16 = (reps + 1) * len(batches)
    expected = {k: PPI_PER_FORWARD["float32"][k] * (forwards[0] - n_bf16) + PPI_PER_FORWARD["bf16"][k] * n_bf16
                for k in counts}
    phase("ppi-serving", f"launches over the ppi-serving path's {forwards[0]} forwards: {counts}")
    if counts != expected:
        raise RuntimeError(f"ppi-serving launches {counts} != {expected} expected")
    return counts


def ppi_train_phase(model, samples, batches, dev, card):
    """ModelTrainer.train for one epoch under bf16 AMP, then train_steps in
    float32 and in bf16 AMP. Returns the launch counts of the path."""
    from ptgnn_tpu_torch.core.trainer import ModelTrainer
    from ptgnn_tpu_torch.implementations.ppi.harness import PPI_GRAPH_SIZES, synthetic_ppi_samples
    from ptgnn_tpu_torch.implementations.typilus.harness import train_steps
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    valid = synthetic_ppi_samples(2, SEED + 1, **PPI_GRAPH_SIZES)
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    trainer = ModelTrainer(
        model, out_dir / "ppi.pkl.gz", max_num_epochs=1, minibatch_size=1, clip_gradient_norm=1.0,
        target_validation_metric="f1_score", target_validation_metric_higher_is_better=True,
        enable_amp=True, device=dev, seed=SEED,
    )  # Adam(1e-3), the default optimizer
    trainer.load_metadata_and_create_network(samples, parallelize=False)
    module = trainer.neural_module
    forwards, backwards = [0], [0]
    hooks = [
        module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1)),
        module.to_logits.weight.register_hook(lambda g: backwards.__setitem__(0, backwards[0] + 1)),
    ]
    valid_metrics = []
    trainer.register_validation_epoch_end_hook(lambda m, mod, e, metrics: valid_metrics.append(metrics))
    sk.reset_launch_counts()  # the ppi-train path starts here
    t0 = time.perf_counter()
    trainer.train(samples, valid, initialize_metadata=False, patience=0, store_tensorized_data_in_memory=True)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    for hook in hooks:
        hook.remove()
    fw, bw = forwards[0], backwards[0]
    expected = {k: PPI_PER_FORWARD["bf16"][k] * fw + (PPI_PER_TRAIN_STEP["bf16"][k] - PPI_PER_FORWARD["bf16"][k]) * bw
                for k in sk.launch_counts()}
    got = sk.launch_counts()
    phase("ppi-train", f"ModelTrainer.train (bf16 AMP): 1 epoch over {len(samples)} graphs with validation "
          f"over {len(valid)} before and after in {t_train:.2f} s (host tensorize + batching included): {bw} "
          f"train steps, {fw - bw} validation forwards; validation metrics {valid_metrics}; launches {got}")
    if bw == 0 or not (out_dir / "ppi.pkl.gz").exists():
        raise RuntimeError("ModelTrainer.train took no PPI step or wrote no checkpoint")
    if got != expected:
        raise RuntimeError(f"ModelTrainer.train launches {got} != {expected} expected from {fw} forwards and {bw} backwards")
    for name, amp in (("float32", False), ("bf16", True)):
        steps_module = model.build_neural_module(device=dev, seed=SEED)
        before = sk.launch_counts()
        stats = train_steps(steps_module, batches, steps=PPI_TRAIN_STEPS, enable_amp=amp, learning_rate=1e-3, seed=SEED)
        per_step = {k: v / (PPI_TRAIN_STEPS + 1) for k, v in delta(sk.launch_counts(), before).items()}
        if per_step != PPI_PER_TRAIN_STEP[name]:
            raise RuntimeError(f"expected {PPI_PER_TRAIN_STEP[name]} launches per {name} PPI step, got {per_step}")
        if not math.isfinite(stats["loss"]):
            raise RuntimeError(f"PPI train_steps ({name}) gave a non-finite loss {stats['loss']}")
        phase("ppi-train", f"train_steps {name}: {PPI_TRAIN_STEPS} steps after 1 warm-up, loss {stats['loss']:.6f}, "
              f"{stats['ms_per_step']:.3f} ms/step, {stats['graphs_per_s']:.2f} graphs/s, "
              f"{stats['nodes_per_s']:.0f} nodes/s, {stats['edges_per_s']:.0f} edges/s on {card}; "
              f"launches per step {per_step}")
        expected = add_counts(expected, {k: v * (PPI_TRAIN_STEPS + 1) for k, v in PPI_PER_TRAIN_STEP[name].items()})
    counts = sk.launch_counts()  # the ppi-train path ends here
    phase("ppi-train", f"launches over the ppi-train path: {counts}")
    if counts != expected:
        raise RuntimeError(f"ppi-train launches {counts} != {expected} expected")
    return counts


def _typed_reference(x, w, tt, tile):
    """float64 product of the typed matmul, and each element's sum of |x||w|."""
    d, m = w.shape[1], w.shape[2]
    wt = w.double().index_select(0, tt.long())
    xt = x.double().reshape(-1, tile, d)
    return torch.bmm(xt, wt).reshape(-1, m), torch.bmm(xt.abs(), wt.abs()).reshape(-1, m)


def typed_matmul_checks(adj, dev, gen, max_abs_err):
    """The typed matmul kernel at both PPI shapes in both dtypes: within
    2^-8 |ref| + 1e-5 sum|x||w| of float64 (its plain version too), the same
    bits on a second run and under a permutation of same-type tiles and of
    the rows inside each tile."""
    from ptgnn_tpu_torch.ops import typed_linear as ttl

    tt, tile = adj.tile_types, adj.edge_tile
    nt = tt.shape[0]
    g = torch.Generator().manual_seed(SEED)
    tile_perm = torch.arange(nt)
    for t in torch.unique(tt.cpu()):
        idx = torch.nonzero(tt.cpu() == t)[:, 0]
        tile_perm[idx] = idx[torch.randperm(len(idx), generator=g)]
    rows = torch.cat([tile_perm[i] * tile + torch.randperm(tile, generator=g) for i in range(nt)]).to(dev)
    done = []
    for din, m in ((512, 256), (256, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(nt * tile, din, device=dev, generator=gen).to(dtype)
            w = (torch.randn(3, din, m, device=dev, generator=gen) / din ** 0.5).to(dtype)
            got = ttl.typed_matmul_kernel(x, w, tt, tile)
            plain = ttl.typed_matmul_plain(x, w, tt, tile)
            ref, scale = _typed_reference(x, w, tt, tile)
            for which, out in (("kernel", got), ("plain version", plain)):
                if bool(((out.double() - ref).abs() > 2.0 ** -8 * ref.abs() + 1e-5 * scale).any()):
                    raise RuntimeError(f"typed matmul {which} off float64 at {din}x{m}/{dtype}")
            del ref, scale
            key = f"typed_matmul {din}x{m} {str(dtype)[6:]}"
            max_abs_err[key] = float((got.float() - plain.float()).abs().max())
            if not bitwise_equal(got, ttl.typed_matmul_kernel(x, w, tt, tile)):
                raise RuntimeError(f"typed matmul gave other bits on a second run at {din}x{m}/{dtype}")
            if not bitwise_equal(ttl.typed_matmul_kernel(x[rows], w, tt, tile), got[rows]):
                raise RuntimeError(f"typed matmul bits depend on row positions at {din}x{m}/{dtype}")
            done.append(f"{din}x{m}/{str(dtype)[6:]}")
    torch.cuda.synchronize()
    phase("ppi-parity", f"typed matmul kernel at [{nt * tile}, D] x [3, D, M], D x M and dtype {done}: within "
          f"2^-8 |ref| + 1e-5 sum|x||w| of float64 (its plain version too; kernel vs plain max abs err "
          f"{ {k: v for k, v in max_abs_err.items() if k.startswith('typed')} }), bitwise from run to run "
          f"and under a permutation of same-type tiles and of the rows inside each tile")


def ppi_parity_phase(model, minibatches, batches, dev):
    """The PPI forward and train step on the card against the CPU, the
    typed matmul, sum and broadcast on the PPI layout, and a repeat check."""
    from ptgnn_tpu_torch.core.trainer import module_loss
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    gpu = model.build_neural_module(device=dev, seed=SEED).eval()
    cpu = model.build_neural_module(device="cpu", seed=SEED).eval()
    host_mb = tree_to(minibatches[0], torch.device("cpu"))
    with torch.inference_mode():
        gl, _ = gpu(**batches[0])
        cl, _ = cpu(**host_mb)
        g_logits = gpu.logits(batches[0]["batch"])[0].cpu().numpy()
        c_logits = cpu.logits(host_mb["batch"])[0].numpy()
    atol = 1e-4 * float(np.abs(c_logits).max())
    np.testing.assert_allclose(float(gl), float(cl), rtol=1e-4)
    np.testing.assert_allclose(g_logits, c_logits, rtol=1e-4, atol=atol)
    phase("ppi-parity", f"float32 forward card vs CPU: loss {float(gl):.7f} vs {float(cl):.7f}; logits max abs "
          f"err {float(np.abs(g_logits - c_logits).max()):.3e} (rtol 1e-4, atol {atol:.3e} = 1e-4 x max|logit|)")

    def step(module, mb, amp, generator):
        module.zero_grad(set_to_none=True)
        loss, _ = module_loss(module, mb, train=True, generator=generator, amp=amp)
        loss.backward()
        return float(loss.detach()), [(name, p.grad.detach().cpu().clone()) for name, p in module.named_parameters()]

    for m in (gpu, cpu):
        set_dropout(m, 0.0)
    g_loss, g32 = step(gpu, batches[0], False, torch.Generator(device=dev))
    c_loss, c32 = step(cpu, host_mb, False, torch.Generator())
    np.testing.assert_allclose(g_loss, c_loss, rtol=1e-5)
    for (n, g), (_, c) in zip(g32, c32):
        c = c.numpy()
        np.testing.assert_allclose(g.numpy(), c, rtol=1e-4, atol=1e-4 * np.abs(c).max(), err_msg=n)
    worst = max((float((g - c).abs().max() / c.abs().max()), n) for (n, g), (_, c) in zip(g32, c32))
    phase("ppi-parity", f"float32 train step (dropout 0) card vs CPU: loss {g_loss:.7f} vs {c_loss:.7f}; "
          f"all {len(g32)} gradients within rtol 1e-4, atol 1e-4 x max|g| elementwise (largest "
          f"difference {worst[0]:.3e} of max|g|, {worst[1]})")

    # bf16 AMP: the card's bf16 step (the typed matmul kernel, cuBLAS) and the
    # CPU's (the plain route, the CPU's bf16 GEMMs) each round at their own
    # places. Each bf16 gradient is held to its own device's float32 gradient
    # of the same step: the card's may lie no farther from it than 1.5 times
    # the CPU's distance (or 1e-2 of its norm); the card-vs-CPU distance of
    # every tensor is reported beside the 2e-2 of the norm first asked for.
    g16_loss, g16 = step(gpu, batches[0], True, torch.Generator(device=dev))
    c16_loss, c16 = step(cpu, host_mb, True, torch.Generator())
    if abs(g16_loss - c16_loss) > 1e-2 * abs(c16_loss):
        raise RuntimeError(f"bf16 AMP PPI loss card {g16_loss} vs CPU {c16_loss}")

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    rows = [(rel(g, c), rel(g, gf), rel(c, cf), n)
            for (n, g), (_, c), (_, gf), (_, cf) in zip(g16, c16, g32, c32)]
    for card_cpu, card_f32, cpu_f32, n in rows:
        if card_f32 > max(1.5 * cpu_f32, 1e-2):
            raise RuntimeError(f"bf16 AMP PPI gradient {n}: {card_f32:.3e} of its norm from the card's float32 "
                               f"gradient, against the CPU's {cpu_f32:.3e}")
    over = [(f"{r[0]:.3e}", r[3]) for r in rows if r[0] > 2e-2]
    phase("ppi-parity", f"bf16 AMP train step, card (typed matmul kernel) vs CPU (plain route): loss "
          f"{g16_loss:.6f} vs {c16_loss:.6f} (within 1e-2); distance of each bf16 gradient from its own "
          f"device's float32 one, largest card {max(r[1] for r in rows):.3e} vs CPU {max(r[2] for r in rows):.3e}, "
          f"summed card {sum(r[1] for r in rows):.3e} vs CPU {sum(r[2] for r in rows):.3e}; card vs CPU largest "
          f"{max(rows)[0]:.3e} ({max(rows)[3]}), {len(over)} of {len(rows)} tensors beyond 2e-2 of the norm: {over}")

    adj = batches[0]["batch"].adjacency
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    max_abs_err = {}
    typed_matmul_checks(adj, dev, gen, max_abs_err)
    plan = sk.sum_plan_from_adjacency(adj)
    num_nodes = adj.agg_counts.numel()
    for width in (256, 512):
        for dtype in (torch.float32, torch.bfloat16):
            data = torch.where(adj.mask[:, None], torch.randn(adj.mask.shape[0], width, device=dev,
                               generator=gen), 0.0).to(dtype)
            got = sk.planned_segment_sum(data, plan, num_nodes)
            err = (got - sk.segment_sum_plain(data, plan, num_nodes)).abs()
            max_abs_err[f"segment_sum {width} {str(dtype)[6:]}"] = float(err.max())
            if bool((err > 1e-5 * sk.segment_sum_plain(data.abs(), plan, num_nodes)).any()):
                raise RuntimeError(f"sum kernel off by more than 1e-5 of sum|x| on the PPI layout at {width}/{dtype}")
            if not bitwise_equal(got, sk.planned_segment_sum(data, plan, num_nodes)):
                raise RuntimeError(f"sum kernel gave other bits on a second run at {width}/{dtype}")
            ones = (torch.rand(data.shape, device=dev, generator=gen) < 0.5).to(dtype) * adj.mask[:, None].to(dtype)
            if not bitwise_equal(sk.planned_segment_sum(ones, plan, num_nodes), sk.segment_sum_plain(ones, plan, num_nodes)):
                raise RuntimeError(f"sum kernel != plain version on 0/1 data at {width}/{dtype}")
        table = torch.randn(num_nodes, 256, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            if not bitwise_equal(sk.planned_broadcast_to_edges(table.to(dtype), plan),
                                 sk.broadcast_plain(table.to(dtype), plan)):
                raise RuntimeError(f"broadcast kernel != plain version on the PPI layout at 256/{dtype}")
    torch.cuda.synchronize()
    phase("ppi-parity", f"on the PPI layout: sum kernel at 256 and 512 (f32, bf16) within 1e-5 x sum|x| "
          f"(max abs err { {k: v for k, v in max_abs_err.items() if k.startswith('segment_sum')} }), bitwise "
          f"on 0/1 data and run to run; broadcast at 256 (f32, bf16) bitwise equal to its plain version")

    runs = []
    for _ in range(2):
        m = model.build_neural_module(device=dev, seed=SEED)
        loss, _ = module_loss(m, batches[0], train=True, generator=torch.Generator(device=dev).manual_seed(SEED),
                              amp=True)
        loss.backward()
        runs.append([loss.detach()] + [p.grad for p in m.parameters()])
    differ = sum(not torch.equal(a, b) for a, b in zip(*runs))
    if differ:
        raise RuntimeError(f"a bf16 AMP PPI train step gave other bits on a second run in {differ} tensors")
    phase("ppi-parity", f"a bf16 AMP PPI train step (dropout on) repeats bit for bit: the loss and all "
          f"{len(runs[0]) - 1} gradient tensors")
    return max_abs_err


def ppi_kernel_entries(adj, dev, gen, max_abs_err, counts, launches_by_path):
    """kernels-line entries of the typed matmul at both PPI shapes and both
    dtypes. Library call: today's bmm route (index_select + torch.bmm)."""
    from ptgnn_tpu_torch.ops import typed_linear as ttl

    tt, tile = adj.tile_types, adj.edge_tile
    nt = tt.shape[0]
    e = nt * tile
    entries = []
    for din, m in ((512, 256), (256, 256)):
        for dtype, peak in ((torch.bfloat16, BF16_OPS_PER_S), (torch.float32, F32_OPS_PER_S)):
            size = torch.finfo(dtype).bits // 8
            xs = rotating(lambda: torch.randn(e, din, device=dev, generator=gen).to(dtype), e * din * size)
            w = (torch.randn(3, din, m, device=dev, generator=gen) / din ** 0.5).to(dtype)

            def calls(fn):
                return [lambda x=xs[i % len(xs)]: fn(x) for i in range(16)]

            times = {
                "ms": graph_time_ms(calls(lambda x: ttl.typed_matmul_kernel(x, w, tt, tile))),
                "plain_ms": event_time_ms(calls(lambda x: ttl.typed_matmul_plain(x, w, tt, tile))),
                "library_ms": graph_time_ms(calls(
                    lambda x: torch.bmm(x.view(nt, tile, din), w.index_select(0, tt.long())).view(e, m))),
            }
            nbytes = e * din * size + e * m * size + w.numel() * size + nt * 4
            ops = 2 * e * din * m
            bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / peak
            dname = str(dtype)[6:]
            entry = {
                "name": "typed_matmul", "route": "cuda", "source": "ptgnn_tpu_torch/csrc/typed_matmul.cu",
                "replaces": "ptgnn_tpu/ops/typed_linear.py:62",
                "launches": counts["typed_matmul"],
                "launches_by_path": {k: v["typed_matmul"] for k, v in launches_by_path.items()},
                "launches_per_ppi_train_step": PPI_PER_TRAIN_STEP["bf16"]["typed_matmul"] if dtype == torch.bfloat16 else 0,
                "max_abs_err": max_abs_err[f"typed_matmul {din}x{m} {dname}"],
                "ms": times["ms"], "plain_ms": times["plain_ms"],
                "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": times["library_ms"], "shape": [e, din, m, 3], "dtype": dname,
            }
            entries.append(entry)
            phase("kernels", json.dumps(entry))
            del xs
    return entries


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
    serving_counts = sk.launch_counts()  # the serving path ends here
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
    phase("serving", f"launches over the serving path's {forwards[0]} forwards: {serving_counts}")
    if serving_counts != {k: v * forwards[0] for k, v in PER_FORWARD.items()}:
        raise RuntimeError(f"expected 8 + 8 kernel launches per forward, got {serving_counts}")

    # ---- 4. training at full width --------------------------------------
    train_counts = train_phase(model, batches, dev, card)

    # ---- 7-8. PPI serving and training at full width ----------------------
    ppi_model, ppi_module, ppi_samples, ppi_minibatches, ppi_batches = ppi_setup(dev, card)
    ppi_serving_counts = ppi_serving_phase(ppi_model, ppi_module, ppi_samples, ppi_batches, dev, card)
    ppi_train_counts = ppi_train_phase(ppi_model, ppi_samples, ppi_batches, dev, card)
    paths = {"serving": serving_counts, "train": train_counts,
             "ppi-serving": ppi_serving_counts, "ppi-train": ppi_train_counts}
    main_counts = {k: sum(counts[k] for counts in paths.values()) for k in serving_counts}
    if min(main_counts.values()) <= 0:
        raise RuntimeError(f"a kernel of the path was never launched: {main_counts}")

    # ---- 5. parity --------------------------------------------------------
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
    max_abs_err = {"broadcast_to_edges": 0.0, "segment_extremum": 0.0, "segment_sum": 0.0}

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

    # The sum reorders a float32 sum: within 1e-5 of each row's sum of |x|;
    # exact on 0/1 data (the tie counts), and the same bits on every run.
    sum_checks = []
    for width in (64, 128, 256):
        for dtype in (torch.float32, torch.bfloat16):
            data = torch.where(adj.mask[:, None], torch.randn(adj.mask.shape[0], width, device=dev,
                               generator=gen), 0.0).to(dtype)
            got = sk.planned_segment_sum(data, bc_plan, num_nodes)
            plain = sk.segment_sum_plain(data, bc_plan, num_nodes)
            err = (got - plain).abs()
            max_abs_err["segment_sum"] = max(max_abs_err["segment_sum"], float(err.max()))
            if bool((err > 1e-5 * sk.segment_sum_plain(data.abs(), bc_plan, num_nodes)).any()):
                raise RuntimeError(f"sum kernel off by more than 1e-5 of the row's sum of |x| at {width}/{dtype}")
            if not bitwise_equal(got, sk.planned_segment_sum(data, bc_plan, num_nodes)):
                raise RuntimeError(f"sum kernel gave other bits on a second run at {width}/{dtype}")
            ones = (torch.rand(data.shape, device=dev, generator=gen) < 0.5).to(dtype) * adj.mask[:, None].to(dtype)
            if not bitwise_equal(sk.planned_segment_sum(ones, bc_plan, num_nodes),
                                 sk.segment_sum_plain(ones, bc_plan, num_nodes)):
                raise RuntimeError(f"sum kernel != plain version on 0/1 data at {width}/{dtype}")
            sum_checks.append(f"{width}/{str(dtype)[6:]}")
    torch.cuda.synchronize()
    phase("parity", f"sum kernel within 1e-5 x sum|x| of its plain version (max abs err "
          f"{max_abs_err['segment_sum']:.3e}), bitwise on 0/1 data and run to run, at {sum_checks}")

    # ---- 6. train parity ----------------------------------------------------
    train_parity_phase(model, batches[0], minibatches[0], dev)
    repeat_check(model, batches[0], dev)

    # ---- 9. PPI parity ------------------------------------------------------
    ppi_max_abs_err = ppi_parity_phase(ppi_model, ppi_minibatches, ppi_batches, dev)

    # ---- 7. kernel timings -------------------------------------------------
    e_pad = adj.mask.shape[0]
    real = adj.mask
    e_real = int(real.sum())
    recv_rows = int(torch.unique(adj.receivers[real]).numel())
    n_super = bc_plan.tile_row_blocks.numel()
    num_blocks = adj.agg_counts.shape[0]
    valid = adj.receivers < num_nodes
    safe_recv = torch.where(valid, adj.receivers, 0).long()
    sum_index = sk.plan_rows(bc_plan, num_nodes)  # sentinel slots -> row num_nodes
    kernels = []

    def calls(fn, inputs):
        return [lambda x=inputs[i % len(inputs)]: fn(x) for i in range(16)]

    def entry(name, times, nbytes, ops, source, replaces, width):
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / F32_OPS_PER_S
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_counts[name],
            "launches_by_path": {path: counts[name] for path, counts in paths.items()},
            "launches_per_forward": PER_FORWARD[name], "launches_per_train_step": PER_TRAIN_STEP[name],
            "max_abs_err": max_abs_err[name],
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": times["library_ms"], "width": width, "dtype": "float32",
        }

    for width in (64, 128, 256):
        # the path's float32 widths: tie counts 64 and 128, the combined node
        # cotangent 128 and 256
        sums = rotating(lambda: torch.where(adj.mask[:, None], torch.randn(
            e_pad, width, device=dev, generator=gen), 0.0), e_pad * width * 4)
        segsum = {
            "ms": graph_time_ms(calls(lambda d: sk.planned_segment_sum(d, bc_plan, num_nodes), sums)),
            "plain_ms": graph_time_ms(calls(lambda d: sk.segment_sum_plain(d, bc_plan, num_nodes), sums)),
            "library_ms": graph_time_ms(calls(
                lambda d: torch.zeros(num_nodes + 1, width, device=dev).index_add_(0, sum_index, d), sums)),
        }
        sum_bytes = e_real * width * 4 + e_pad * 4 + n_super * 4 + num_nodes * width * 4
        e = entry("segment_sum", segsum, sum_bytes, e_real * width, "ptgnn_tpu_torch/csrc/segment_sum.cu",
                  "ptgnn_tpu/ops/pallas/segment_kernels.py:197", width)
        if width == 64:
            kernels.append(e)
        phase("kernels", json.dumps(e))
        del sums

    for width in (64, 128):
        # the path's float32 shapes: D = M = 64 before the residuals, 128 after
        tables = rotating(lambda: torch.randn(num_nodes, width, device=dev, generator=gen),
                          num_nodes * width * 4)
        datas = rotating(lambda: masked_messages(width, torch.float32, True), e_pad * width * 4)
        scatter_index = torch.where(valid, adj.receivers, num_nodes).long()[:, None].expand(-1, width).contiguous()

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
        for args in (
            ("broadcast_to_edges", bc, bc_bytes, 0, "ptgnn_tpu_torch/csrc/broadcast_rows.cu",
             "ptgnn_tpu/ops/pallas/segment_kernels.py:233", width),
            ("segment_extremum", ext, ext_bytes, ext_ops, "ptgnn_tpu_torch/csrc/segment_extremum.cu",
             "ptgnn_tpu/ops/pallas/segment_kernels.py:370", width),
        ):
            e = entry(*args)
            if width == 64:
                kernels.append(e)
            phase("kernels", json.dumps(e))
    # The PPI layout's sum widths (the forward 256, the backward's combined
    # cotangents 512) and broadcast width (256).
    ppi_adj = ppi_batches[0]["batch"].adjacency
    ppi_plan = sk.sum_plan_from_adjacency(ppi_adj)
    ppi_nodes = ppi_adj.agg_counts.numel()
    ppi_real = int(ppi_adj.mask.sum())
    ppi_e_pad = ppi_adj.mask.shape[0]
    ppi_index = sk.plan_rows(ppi_plan, ppi_nodes)
    ppi_valid = ppi_adj.receivers < ppi_nodes
    ppi_recv = torch.where(ppi_valid, ppi_adj.receivers, 0).long()
    ppi_recv_rows = int(torch.unique(ppi_adj.receivers[ppi_adj.mask]).numel())
    for width in (256, 512):
        sums = rotating(lambda: torch.where(ppi_adj.mask[:, None], torch.randn(
            ppi_e_pad, width, device=dev, generator=gen), 0.0), ppi_e_pad * width * 4)
        times = {
            "ms": graph_time_ms(calls(lambda d: sk.planned_segment_sum(d, ppi_plan, ppi_nodes), sums)),
            "plain_ms": graph_time_ms(calls(lambda d: sk.segment_sum_plain(d, ppi_plan, ppi_nodes), sums)),
            "library_ms": graph_time_ms(calls(
                lambda d: torch.zeros(ppi_nodes + 1, width, device=dev).index_add_(0, ppi_index, d), sums)),
        }
        nbytes = (ppi_real * width * 4 + ppi_e_pad * 4 + ppi_plan.tile_row_blocks.numel() * 4
                  + ppi_nodes * width * 4)
        e = entry("segment_sum", times, nbytes, ppi_real * width, "ptgnn_tpu_torch/csrc/segment_sum.cu",
                  "ptgnn_tpu/ops/pallas/segment_kernels.py:197", width)
        e["max_abs_err"] = ppi_max_abs_err[f"segment_sum {width} float32"]
        phase("kernels", "PPI layout " + json.dumps(e))
        del sums
    tables = rotating(lambda: torch.randn(ppi_nodes, 256, device=dev, generator=gen), ppi_nodes * 256 * 4)
    times = {
        "ms": graph_time_ms(calls(lambda t: sk.planned_broadcast_to_edges(t, ppi_plan), tables)),
        "plain_ms": graph_time_ms(calls(lambda t: sk.broadcast_plain(t, ppi_plan), tables)),
        "library_ms": graph_time_ms(calls(
            lambda t: torch.where(ppi_valid[:, None], t.index_select(0, ppi_recv), 0.0), tables)),
    }
    nbytes = (ppi_recv_rows * 256 * 4 + ppi_e_pad * 4 + ppi_plan.tile_row_blocks.numel() * 4
              + ppi_e_pad * 256 * 4)
    e = entry("broadcast_to_edges", times, nbytes, 0, "ptgnn_tpu_torch/csrc/broadcast_rows.cu",
              "ptgnn_tpu/ops/pallas/segment_kernels.py:233", 256)
    e["max_abs_err"] = 0.0  # bitwise equal (ppi-parity)
    phase("kernels", "PPI layout " + json.dumps(e))
    del tables
    kernels += ppi_kernel_entries(ppi_adj, dev, gen, ppi_max_abs_err, main_counts, paths)
    torch.cuda.synchronize()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
