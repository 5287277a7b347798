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
   (bitwise for the broadcast and the extremum; the sum bitwise equal to its
   plain version run on the CPU, within 1e-5 of each row's sum of |x| of the
   one on the card, bitwise on 0/1 data and from run to run);
6. train-parity: one train step (dropout 0) on the card against the CPU:
   the loss; each MP layer alone on the same inputs (the extremum kernel
   bitwise against the plain reduce of the card's messages, the aggregates
   and, on the card's routing decisions, every gradient to rtol 1e-4 and
   1e-4 of its largest magnitude); the whole step: the loss, and every
   gradient to rtol 1e-4
   and 1e-4 of its largest magnitude against the CPU's step on the card's
   routing decisions (which slots win a near-tie depends on the host CPU's
   rounding), with the CPU's own step's loss and routing differences; the
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
   and row permutations; the sum at 256 and 512 (bitwise equal to the CPU's
   plain version too) and the broadcast at 256 on the PPI layout; a bf16 AMP
   step with dropout that repeats bit for bit;
10. argmax-train: Graph2Class at the benchmark configuration with argmax
   (single-winner) routing of the max aggregation: ModelTrainer.train for
   one epoch and train_steps in float32 and bf16 AMP (per step: 8 argmax
   extremum, 16 broadcast and 8 sum launches; per forward 8 argmax extremum
   and 8 broadcast); one train step (dropout 0) on the card against the CPU
   as in train-parity (the loss; every gradient elementwise on the card's
   winning slots); each MP layer's
   argmax extremum on the card's own messages against its plain version
   (values bitwise, slots exactly); a train step that repeats bit for bit;
11. ggnn: the 'ggnn' stack at hidden 64 on the benchmark batches: the
   serving forward (8 extremum launches per forward), train_steps in
   float32 and bf16 AMP (per step: 8 extremum, 16 broadcast, 16 sum), the
   logits and a train step (dropout 0) on the card against the CPU, and a
   train step that repeats bit for bit;
12. cli: the Typilus train CLI for one epoch on synthetic folds written
   under build/ ('mlp' under PTGNN_TPU_ARGMAX_ROUTING, then 'ggnn'), then
   the predict CLI on the saved model;
13. varmisuse: VarMisuse at full width (``vm_padding()``: 8,192 nodes,
   65,536 edge slots, 64 graphs; hidden 64; the char CNN 256-3-128-3-3 over
   15 chars of 96 ids; 9 materialized edge types) on synthetic samples
   whose ``mean_tokens`` rises until the batches fill 75 % of the node
   budget, for the 'mlp' and the 'ggnn' factory: the host pipeline with the
   graphs, nodes and edges of each batch, report_accuracy, the eval forward
   over device-resident batches, ModelTrainer.train for one epoch with
   validation, train_steps in float32 and bf16 AMP (per 'mlp' step: 8
   extremum, 24 broadcast, 16 sum launches; per 'ggnn' step: 8 broadcast,
   16 sum), the launches of K1-K5 over each path, and a float32 train step
   (dropout 0) card against CPU on the card's routing decisions, with the
   candidate scores;
14. graph2seq: Graph2Seq at full width (``create_graph2seq_model()``
   defaults: a token-vocabulary node embedder at 128, one gated layer
   object at 7 positions and a fresh one in a mean residual block, sum
   aggregation, 4 forward edge types and 8 materialized; the GRU copy
   decoder at hidden 128 and embedding 256, ``max_seq_len`` 8; the 8-head
   self-attention summariser; ``g2s_padding()``: 16,384 nodes, 131,072 edge
   slots, 64 graphs, 16,384 memory slots) on synthetic samples whose
   ``mean_nodes`` rises until the batches fill 75 % of the node budget: the
   host pipeline with the graphs, nodes, edges and memories of each batch;
   greedy and beam-5 decode over 2 test batches, ``test.evaluate`` and the
   eval forward, with ms per batch and graphs/s; the greedy and beam loops
   under ``torch.cuda.set_sync_debug_mode("error")``; ModelTrainer.train
   for one epoch with validation and train_steps in float32 and bf16 AMP
   (per step 8 broadcast and 16 sum launches, per forward 8 sum); a float32
   train step (dropout 0) card against CPU; greedy decode card against CPU,
   the device loop against the host loop, beam 1 against greedy; the
   decoder alone at its 20,000-token vocabulary cap (eval loss, a train
   step and a greedy decode batch, timed); the decoder's and the
   summariser's stock segment sums (``index_add_`` into 64 rows), timed;
15. kernels: each kernel's time (CUDA events over a CUDA graph of launches
   on rotating inputs), its bound, its plain version's and one library
   call's time, as one JSON line; before it, the argmax extremum against
   its plain version at M 64 and 128, float32 and bf16, max and min, with
   planted ties, and the extremum, the argmax extremum and the sum on a
   skewed layout (the benchmark batch plus one hub row of 4,096 slots, which
   the kernels split) against their plain versions, timed beside
   scatter_reduce and index_add_; then the extremum, the broadcast and the
   sum on a VarMisuse batch's layout at the path's widths against their
   plain versions, and timed; then the sum and the broadcast on a Graph2Seq
   batch's layout at width 128 against their plain versions, and timed
   (entries of the kernels line);
16. sanitizer: every kernel once at a small size under compute-sanitizer's
   memcheck, racecheck and synccheck (``chip_smoke.py --sanitizer-target``
   is what it runs), or a line saying why the tool could not run;
17. layers (run after graph2seq, its kernel entries in phase 15): Graph2Class
   at the benchmark layout and width with the 'layers' stack of the other
   message-passing families (``harness.LayersStackCreator``: an MLP-MP
   layer with a hidden layer and PNA aggregation, GraphNorm, EGC with max
   aggregation on the fused route, block self-attention over the batch's
   ``att_order``, an MLP-MP layer with a [128] hidden layer and mean
   aggregation, self-attention among the supernodes, the benchmark's MLP-MP
   layer): eval forwards in float32 and bf16 AMP, train_steps in both (per
   forward 3 sum, 4 extremum and 1 broadcast launches; per step 9, 4 and
   12), train steps with edge dropout 0.1 (per step 9, 4 and 11; no fused-op
   call; finite gradients; an eval forward that the rate leaves alone), the
   logits (rtol 1e-4, atol 1e-4 x max|logit|, with each entry's output and
   the card's and the CPU's run-to-run spread) and a train step (dropout 0;
   the loss to rtol 1e-5, every gradient within 1e-4 of its largest
   magnitude on the card's routing decisions, relu's active sets among
   them) on weights loaded through ``convert.py``, card against CPU; then K1
   and K2 on PNA's messages at 64,
   K3 at 64, K2 at 256 on EGC's fused messages and K1 at width 1 on an
   edge-dropout mask against their plain versions, timed;
18. edge-features (after layers): the generic engine with edge features at
   PPI's width and layout (``ppi.harness.build_edge_feature_gnn``: a Tanh
   feature embedder of the 50 node features to 256, a feature embedder of 4
   seeded floats per forward edge to 128, 5 MLP-MP layers with sum
   aggregation, target state and 128 feature columns, so a 640-wide message
   input; and the variant with a gated layer in place of the last) on
   synthetic graphs of PPI's sizes: eval forwards in float32 and bf16 AMP and
   train_steps in both (per forward 5 sum launches and in bf16 5 typed
   matmul launches; per step 5 sum, 5 broadcast and in bf16 10 typed
   matmul), no fused-op call, and for the MLP-MP stack the output states and
   a float32 train step card against CPU on weights converted through
   ``convert.py`` (the PPI phase's limits); the typed matmul at the path's
   bf16 shapes against float64 and timed (entries of the kernels line);
19. bpe: Graph2Class at the benchmark configuration with the ``bpe``
   splitting (a 64-entry vocabulary) and ``max`` pooling: the eval forward
   (8 extremum and 8 broadcast launches per forward) and the logits card
   against CPU under the parity phase's limits;
20. data-parallel: DistributedModelTrainer at world size 1 over NCCL with
   ZeRO-1 for 3 optimizer steps at the benchmark configuration against
   ModelTrainer's same steps (every parameter within 1e-6 of its tensor's
   largest magnitude; bitwise equality printed), with the all-reduce calls
   and bytes per step and the trainer's launches; then the distributed
   Typilus CLI with ``--world-size 1`` for one epoch on synthetic folds. The
   2-rank path runs on the CPU over gloo in the tests.

Then the total seconds. The last line is {"ok": true, "device": {...}};
the line before it is the card's name and power limit as nvidia-smi
reports them, and the one before that the kernels JSON line.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 dense tensor cores
SEED = 0
NUM_BATCHES = 6
TRAIN_STEPS = 30


def counts_of(extremum=0, argmax=0, broadcast=0, segsum=0, typed=0):
    return {"segment_extremum": extremum, "segment_extremum_argmax": argmax, "broadcast_to_edges": broadcast,
            "segment_sum": segsum, "typed_matmul": typed}


PER_FORWARD = counts_of(extremum=8, broadcast=8)
PER_TRAIN_STEP = counts_of(extremum=8, broadcast=24, segsum=16)
# Argmax routing, per MLP-MP layer: the target-row broadcast and the argmax
# extremum forward; the g-row broadcast and one sum backward (no tie count).
ARGMAX_PER_FORWARD = counts_of(argmax=8, broadcast=8)
ARGMAX_PER_TRAIN_STEP = counts_of(argmax=8, broadcast=16, segsum=8)
# GGNN, per gated layer (no target state): the extremum forward; the
# extremum-row broadcast, the tie count, the g-row broadcast and the
# cotangent sum backward.
GGNN_PER_FORWARD = counts_of(extremum=8)
GGNN_PER_TRAIN_STEP = counts_of(extremum=8, broadcast=16, segsum=16)
# PPI: per MP layer one broadcast (target rows) and one sum forward, one
# broadcast (g rows) and one sum (both cotangents) backward; the typed matmul
# once forward and twice backward, where its gate opens (bf16 only).
PPI_GRAPHS = 6
PPI_TRAIN_STEPS = 20
PPI_PER_FORWARD = {
    "float32": counts_of(broadcast=5, segsum=5),
    "bf16": counts_of(broadcast=5, segsum=5, typed=5),
}
PPI_PER_TRAIN_STEP = {
    "float32": counts_of(broadcast=10, segsum=10),
    "bf16": counts_of(broadcast=10, segsum=10, typed=15),
}
# VarMisuse: the 'mlp' stack is Graph2Class's, so are its launches. The
# 'ggnn' stack's gated layer (8 positions, sum aggregation, no target state):
# the sum forward; the g-row broadcast and the cotangent sum backward. The
# global updates and the head run stock ops. K5's gate stays closed (no
# message weight block reaches 128 KB in bf16).
VM_BATCHES = 6
VM_TRAIN_STEPS = 20
VM_PER_FORWARD = {"mlp": PER_FORWARD, "ggnn": counts_of(segsum=8)}
VM_PER_TRAIN_STEP = {"mlp": PER_TRAIN_STEP, "ggnn": counts_of(broadcast=8, segsum=16)}
# Graph2Seq: 8 gated positions (one layer object at 7 of them, sum
# aggregation): the sum forward; the g-row broadcast and the cotangent sum
# backward. The decoder and the summariser run stock ops.
G2S_BATCHES = 6
G2S_TEST_BATCHES = 2
G2S_TRAIN_STEPS = 20
G2S_BEAM = 5
G2S_PER_FORWARD = counts_of(segsum=8)
G2S_PER_TRAIN_STEP = counts_of(broadcast=8, segsum=16)
# The 'layers' stack (harness.LayersStackCreator). Forward: PNA on the
# per-slot route (degrees from the plan's counts under the static mask) two
# sums and two extrema; EGC's fused max (no target state) one extremum; the
# per-slot mean (the plan's counts) one sum; the fused max MLP-MP layer a
# broadcast and an extremum. Backward: each per-slot sum one broadcast, each
# per-slot extremum two broadcasts and a sum (the tie count), each fused max
# two broadcasts and two sums. Under edge dropout the fused layers take the
# per-slot route, and the live in-degrees of PNA and of the mean are the sum
# at width 1. K5's gate stays closed: no weight block is 128 wide on both sides.
LAYERS_TRAIN_STEPS = 20
LAYERS_EDGE_DROPOUT = 0.1
LAYERS_EDGE_DROPOUT_STEPS = 5
LAYERS_PER_FORWARD = counts_of(extremum=4, broadcast=1, segsum=3)
LAYERS_PER_TRAIN_STEP = counts_of(extremum=4, broadcast=12, segsum=9)
LAYERS_PER_EDGE_DROPOUT_STEP = counts_of(extremum=4, broadcast=11, segsum=9)
LAYERS_FUSED_PER_FORWARD = 2  # EGC and the last MLP-MP layer
# Edge features (PPI's layout, hidden 256, 128 feature columns): every layer
# takes the per-slot route (the fused op takes no features), so per layer
# one sum forward and its broadcast backward; the typed matmul where its
# gate opens (bf16: D = 2 x 256 + 128 = 640 or, in the gated layer,
# 256 + 128 = 384, M = 256) once forward and once backward (dx). Five
# layers in both stacks.
EDGE_TRAIN_STEPS = 10
EDGE_PER_FORWARD = {"float32": counts_of(segsum=5), "bf16": counts_of(segsum=5, typed=5)}
EDGE_PER_TRAIN_STEP = {"float32": counts_of(broadcast=5, segsum=5),
                       "bf16": counts_of(broadcast=5, segsum=5, typed=10)}
EDGE_TYPED_SHAPES = ((640, 256), (256, 640), (384, 256), (256, 384))  # forward and dx, both stacks
# BPE: a vocabulary of 64 entries splits the synthetic labels into 1-8
# pieces (5 kept); at the factory's 10,000 every label is one piece.
BPE_VOCABULARY = 64
BPE_BATCHES = 3
DP_STEPS = 3


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


KERNEL_FILES = {  # kernel -> (its source, the TPU kernel it replaces)
    "segment_sum": ("ptgnn_tpu_torch/csrc/segment_sum.cu", "ptgnn_tpu/ops/pallas/segment_kernels.py:197"),
    "segment_extremum": ("ptgnn_tpu_torch/csrc/segment_extremum.cu", "ptgnn_tpu/ops/pallas/segment_kernels.py:370"),
    "segment_extremum_argmax": ("ptgnn_tpu_torch/csrc/segment_extremum_argmax.cu",
                                "ptgnn_tpu/ops/pallas/segment_kernels.py:726"),
    "broadcast_to_edges": ("ptgnn_tpu_torch/csrc/broadcast_rows.cu", "ptgnn_tpu/ops/pallas/segment_kernels.py:233"),
}


class LayoutKernel(NamedTuple):
    """A row kernel on one layout at one width: its wrapper, its plain
    version, one library call for the same function, a maker of random
    inputs, the bytes of one input, and the bytes and operations one call
    must move and do."""

    kernel: Callable
    plain: Callable
    library: Callable
    make: Callable
    input_bytes: int
    nbytes: int
    ops: int


def layout_kernel(kind: str, adj, width: int, dev, gen) -> LayoutKernel:
    """``kind`` (the sum, the max extremum, the max extremum with its
    winning slots, or the broadcast) on ``adj``'s layout at ``width``,
    float32. Bytes, each input read once and each output written once: a
    reduction reads the real slots' rows and slot ids and the row offsets
    (an extremum the counts too) and writes a row per node (and the slots);
    the broadcast reads the receivers' rows, the slot rows and the tile rows
    and writes a row per slot. Operations: one per real element of a
    reduction. Library calls: ``index_add_``; ``scatter_reduce`` amax
    (values only for the argmax: a partial stand-in); ``index_select`` and
    the mask."""
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    num_nodes = adj.agg_counts.numel()
    e_pad, e_real = adj.mask.shape[0], int(adj.mask.sum())
    valid = adj.receivers < num_nodes
    if kind == "broadcast_to_edges":
        plan = sk.sum_plan_from_adjacency(adj)
        safe = torch.where(valid, adj.receivers, 0).long()
        rows = int(torch.unique(adj.receivers[adj.mask]).numel())
        return LayoutKernel(
            lambda t: sk.planned_broadcast_to_edges(t, plan), lambda t: sk.broadcast_plain(t, plan),
            lambda t: torch.where(valid[:, None], t.index_select(0, safe), 0.0),
            lambda: torch.randn(num_nodes, width, device=dev, generator=gen), num_nodes * width * 4,
            rows * width * 4 + e_pad * 4 + plan.tile_row_blocks.numel() * 4 + e_pad * width * 4, 0)
    nbytes = e_real * width * 4 + e_real * 4 + (num_nodes + 1) * 4 + num_nodes * width * 4
    fill = 0.0 if kind == "segment_sum" else -3.0e38

    def make():
        data = torch.randn(e_pad, width, device=dev, generator=gen)
        return torch.where(adj.mask[:, None], data, torch.full((), fill, device=dev)).contiguous()

    if kind == "segment_sum":
        plan = sk.sum_plan_from_adjacency(adj)
        index = sk.plan_rows(plan, num_nodes)
        return LayoutKernel(
            lambda d: sk.planned_segment_sum(d, plan, num_nodes), lambda d: sk.segment_sum_plain(d, plan, num_nodes),
            lambda d: torch.zeros(num_nodes + 1, width, device=dev).index_add_(0, index, d),
            make, e_pad * width * 4, nbytes, e_real * width)
    plan = sk.plan_from_adjacency(adj)
    index = torch.where(valid, adj.receivers, num_nodes).long()[:, None].expand(-1, width).contiguous()

    def library(d):
        return torch.zeros(num_nodes + 1, width, device=dev).scatter_reduce_(0, index, d, "amax", include_self=False)

    if kind == "segment_extremum":
        return LayoutKernel(
            lambda d: sk.planned_segment_extremum(d, plan, num_nodes, True),
            lambda d: sk.segment_extremum_plain(d, plan, num_nodes, True), library,
            make, e_pad * width * 4, nbytes + num_nodes * 4, e_real * width)
    return LayoutKernel(
        lambda d: sk.planned_segment_extremum_with_argmax(d, plan, num_nodes, True),
        lambda d: sk.segment_extremum_argmax_plain(d, plan, num_nodes, True), library,
        make, e_pad * width * 4, nbytes + num_nodes * 4 + num_nodes * width * 4, e_real * width)


def layout_times(k: LayoutKernel, make=None) -> dict:
    """ms of one call of the kernel, of its plain version and of the library
    call (``graph_time_ms`` over 16 calls on inputs from ``make``, else
    ``k.make``, rotated past the L2)."""
    inputs = rotating(make or k.make, k.input_bytes)
    times = {key: graph_time_ms([lambda x=inputs[i % len(inputs)], f=f: f(x) for i in range(16)])
             for key, f in (("ms", k.kernel), ("plain_ms", k.plain), ("library_ms", k.library))}
    del inputs
    return times


def bound(nbytes: int, ops: int, peak: float = F32_OPS_PER_S) -> dict:
    """The least time the card could take: the bytes over the memory rate or
    the operations over ``peak``, whichever is longer."""
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / peak
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def beyond(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements outside rtol 1e-4, atol 1e-4 x max|want|."""
    return int(((got - want).abs() > 1e-4 * want.abs() + 1e-4 * want.abs().max()).sum())


ROUTING = ("planned_segment_extremum_with_argmax", "_primary_indicator", "_transpose_indicator",
           "extremum_indicator")


@contextlib.contextmanager
def routing_tape(tape: list, replay: bool = False, relu: bool = False):
    """Records in ``tape``, in call order, the routing decisions that the
    steps run inside it take: in the fused op, the argmax extremum's winning
    slots and the tie indicators of value routing in both orientations; in
    the differentiable extremum of the per-slot route, its tie indicator;
    with ``relu``, the active set of every ``torch.relu`` (and of the
    activations named "relu"). With ``replay``, the steps take the decisions
    of ``tape`` in place of their own. A CPU step that replays the card's
    tape resolves every near-tie as the card did, so what is left between
    the two is float32 rounding. Under argmax routing its values are its
    own messages at the card's winning slots; a replayed relu passes its own
    input where the card's was positive."""
    from ptgnn_tpu_torch.nn import layers as nn_layers
    from ptgnn_tpu_torch.ops import fused_mp
    from ptgnn_tpu_torch.ops import segment_kernels

    owner = {name: segment_kernels if name == "extremum_indicator" else fused_mp for name in ROUTING}
    real = {name: getattr(owner[name], name) for name in ROUTING}
    recorded = iter(list(tape))
    real_relu = torch.relu

    def taped_relu(x):
        if not replay:
            tape.append(("relu", x > 0))
            return real_relu(x)
        kind, theirs = next(recorded)
        if kind != "relu":
            raise RuntimeError(f"the step calls relu where the tape holds {kind}")
        return torch.where(theirs.to(x.device), x, torch.zeros((), dtype=x.dtype, device=x.device))

    def taped(name):
        def call(*args):
            own = real[name](*args)
            if not replay:
                tape.append((name, own))
                return own
            kind, theirs = next(recorded)
            if kind != name:
                raise RuntimeError(f"the step calls {name} where the tape holds {kind}")
            if name != "planned_segment_extremum_with_argmax":
                return theirs.to(own.device)
            slots = theirs[1].to(own[1].device)
            won = args[0].gather(0, slots.clamp_min(0).long()).float()
            return torch.where(slots >= 0, won, torch.zeros((), dtype=won.dtype)), slots
        return call

    for name in ROUTING:
        setattr(owner[name], name, taped(name))
    if relu:
        torch.relu = nn_layers.ACTIVATIONS["relu"] = taped_relu
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(owner[name], name, fn)
        if relu:
            torch.relu = nn_layers.ACTIVATIONS["relu"] = real_relu
    if replay and next(recorded, None) is not None:
        raise RuntimeError("the step took fewer routing decisions than the tape holds")


def routing_differences(tape_a: list, tape_b: list) -> list[int]:
    """Per routing call, the decisions on which two tapes differ: winning
    slots under argmax routing, tie-indicator or relu-mask entries
    otherwise."""
    diffs = []
    for (kind, a), (_, b) in zip(tape_a, tape_b, strict=True):
        if kind == "planned_segment_extremum_with_argmax":
            a, b = a[1], b[1]
        diffs.append(int((a.cpu() != b.cpu()).sum()))
    return diffs


def train_phase(model, batches, dev, card, name="train", per_forward=PER_FORWARD, per_step=PER_TRAIN_STEP):
    """ModelTrainer.train for one epoch, then train_steps in float32 and in
    bf16 AMP. Returns the launch counts over the whole phase."""
    from ptgnn_tpu_torch.core.trainer import ModelTrainer, shuffle_seed
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    train_graphs, valid_graphs = list(graphs(SEED)), list(graphs(SEED + 1))
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    checkpoint = out_dir / f"graph2class-{name}.pkl.gz"
    trainer = ModelTrainer(
        model, checkpoint, max_num_epochs=1, minibatch_size=300,
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
    phase(name, f"ModelTrainer.train: 1 epoch over {len(train_graphs)} graphs with validation "
          f"before and after in {t_train:.2f} s (host tensorize + batching included): "
          f"{backwards[0]} train steps, {forwards[0] - backwards[0]} validation forwards; "
          f"validation metrics {valid_metrics}")
    if backwards[0] == 0 or not checkpoint.exists():
        raise RuntimeError("ModelTrainer.train took no step or wrote no checkpoint")
    train_steps_phase(model, [g2c_minibatch(b) for b in batches], dev, card, name, per_step)
    counts = sk.launch_counts()  # the train path ends here
    for hook in hooks:
        hook.remove()
    expected = {
        k: per_forward[k] * forwards[0] + (per_step[k] - per_forward[k]) * backwards[0]
        + per_step[k] * 2 * (TRAIN_STEPS + 1)
        for k in counts
    }
    phase(name, f"launches over the {name} path: {counts}")
    if counts != expected:
        raise RuntimeError(f"train path launches {counts} != {expected} expected from its "
                           f"{forwards[0]} forwards and {backwards[0]} backwards in ModelTrainer.train")
    return counts


def eval_forward_phase(module, batches, card, name, reps, amp=False):
    """The eval loss of device-resident batches, ``reps`` timed passes after
    a warm-up pass, with ms per batch and graphs, nodes and edges per
    second. Returns the first pass's mean loss."""
    from ptgnn_tpu_torch.core.trainer import module_loss

    sizes = [(int(mb["batch"].num_graphs), int(mb["batch"].num_nodes), int(mb["batch"].num_edges)) for mb in batches]
    g, n, e = (reps * sum(s[i] for s in sizes) for i in range(3))
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
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite {name} eval losses {losses}")
    loss = float(losses[:len(batches)].mean())
    phase(name, f"{'bf16 AMP' if amp else 'float32'} eval forward over {reps * len(batches)} device-resident "
          f"batches: loss {loss:.6f}, {1e3 * elapsed / (reps * len(batches)):.3f} ms/batch, {g / elapsed:.1f} "
          f"graphs/s, {n / elapsed:.0f} nodes/s, {e / elapsed:.0f} edges/s on {card}")
    return loss


def train_steps_phase(model, minibatches, dev, card, name, per_step, steps=TRAIN_STEPS, **train_kw):
    """train_steps (``train_kw``: its learning rate and clip) in float32 and
    in bf16 AMP from fresh seeded weights, over device-resident minibatches
    of the module's keyword arguments, with the launches of every step
    checked. Returns the launch counts of both loops."""
    from ptgnn_tpu_torch.implementations.typilus.harness import train_steps
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    for dtype_name, amp in (("float32", False), ("bf16 AMP", True)):
        steps_module = model.build_neural_module(device=dev, seed=SEED)
        before = sk.launch_counts()
        stats = train_steps(steps_module, minibatches, steps=steps, enable_amp=amp, seed=SEED, **train_kw)
        got = {k: v / (steps + 1) for k, v in delta(sk.launch_counts(), before).items()}
        if got != per_step:
            raise RuntimeError(f"expected {per_step} launches per {name} step, got {got}")
        if not math.isfinite(stats["loss"]):
            raise RuntimeError(f"train_steps ({name}, {dtype_name}) gave a non-finite loss {stats['loss']}")
        phase(name, f"train_steps {dtype_name}: {steps} steps after 1 warm-up, loss {stats['loss']:.6f}, "
              f"{stats['ms_per_step']:.3f} ms/step, {stats['graphs_per_s']:.1f} graphs/s, "
              f"{stats['nodes_per_s']:.0f} nodes/s, {stats['edges_per_s']:.0f} edges/s on {card}; "
              f"launches per step {got}")
    return {k: v * 2 * (steps + 1) for k, v in per_step.items()}


def train_parity_phase(model, device_batch, host_minibatch, dev):
    """One float32 train step with dropout 0 on the card against the CPU.

    The whole step as ``step_against_cpu`` holds it; then each MP layer
    alone, from the CPU's inputs and upstream cotangent (the extremum kernel
    bitwise against the plain reduce of the card's own messages; the
    aggregates and, on the card's routing decisions, every gradient within
    rtol 1e-4 and 1e-4 of its tensor's largest magnitude); the tie counts;
    and the clip + Adam step."""
    from ptgnn_tpu_torch.core.trainer import optimizer_step
    from ptgnn_tpu_torch.graph.messagepassing.base import GraphContext
    from ptgnn_tpu_torch.ops import fused_mp
    from ptgnn_tpu_torch.ops.segment_kernels import adjacency_segment_reduce
    from ptgnn_tpu_torch.ops.typed_linear import typed_tile_matmul

    def mlp_layers(m):
        return [layer for layer in m.gnn.message_passing_layers if type(layer).__name__ == "MlpMessagePassingLayer"]

    inputs = {"gpu": [], "cpu": []}
    upstream = {}  # CPU cotangent of each MP layer's output

    def keep_upstream(index):
        def hook(_module, _args, out):
            out.register_hook(lambda g: upstream.__setitem__(index, g.detach()))
        return hook

    def keep(module, side):
        handles = [layer.register_forward_pre_hook(lambda mod, args: inputs[side].append(args[0].detach()))
                   for layer in mlp_layers(module)]
        if side == "cpu":
            handles += [layer.register_forward_hook(keep_upstream(i)) for i, layer in enumerate(mlp_layers(module))]
        return handles

    gpu, cpu, step_grads = step_against_cpu(model, g2c_minibatch(device_batch), host_minibatch, dev, "train-parity",
                                            keep)
    initial = {k: v.detach().clone() for k, v in gpu.state_dict().items()}
    batch = device_batch[0]
    cpu_batch = host_minibatch["batch"].to("cpu")

    # Each MP layer alone, on the same inputs and upstream cotangent.
    def context(b):
        return GraphContext(adjacency=b.adjacency, node_graph=b.node_graph, node_mask=b.node_mask,
                            graph_mask=b.graph_mask, references=b.references)

    # The card's messages come from cuBLAS and the CPU's from the host's BLAS,
    # whose rounding depends on the host (with AVX2 instead of AVX-512 they
    # differ by ulps), so the card and the CPU are compared at the float32
    # tolerance, and the kernel bitwise against the plain reduce of the
    # card's own messages.
    local_worst, agg_worst, bitwise_layers, rerouted = 0.0, 0.0, 0, []
    for index, (lg, lc) in enumerate(zip(mlp_layers(gpu), mlp_layers(cpu))):
        x, g_out = inputs["cpu"][index], upstream[index]
        xg, xc = x.to(dev).clone().requires_grad_(), x.clone().requires_grad_()
        lg.zero_grad()
        lc.zero_grad()
        tape = []
        with routing_tape(tape):
            lg(xg, context(batch), train=True).backward(g_out.to(dev))
        with routing_tape(tape, replay=True):
            lc(xc, context(cpu_batch), train=True).backward(g_out)
        w = lc.message_mlp.weights_0.detach()
        out_c, _, inp_c = fused_mp._fused_fwd_impl(x, w, cpu_batch.adjacency, None, x.shape[0], "max", True, 1.0)
        out_g, _, inp_g = fused_mp._fused_fwd_impl(x.to(dev), w.to(dev), batch.adjacency, None, x.shape[0], "max", True, 1.0)
        msgs_g = typed_tile_matmul(inp_g, w.to(dev), batch.adjacency.tile_types, batch.adjacency.edge_tile).cpu()
        plain = adjacency_segment_reduce(msgs_g, cpu_batch.adjacency, x.shape[0], "max", mask=cpu_batch.adjacency.mask,
                                         counts_exact=True)
        if not bitwise_equal(out_g.cpu(), plain):
            raise RuntimeError(f"MP layer {index} alone: the extremum kernel differs from the plain reduce of "
                               f"the card's own messages")
        out_g = out_g.cpu()
        if beyond(out_g, out_c):
            raise RuntimeError(f"MP layer {index} alone: the aggregates are off in {beyond(out_g, out_c)} elements")
        agg_worst = max(agg_worst, float((out_g - out_c).abs().max() / out_c.abs().max()))
        bitwise_layers += bitwise_equal(out_g, out_c)
        rerouted.append(int((fused_mp._primary_indicator(inp_g, w.to(dev), batch.adjacency, out_g.to(dev),
                                                         torch.float32).cpu()
                             != fused_mp._primary_indicator(inp_c, w, cpu_batch.adjacency, out_c, torch.float32)).sum()))
        pairs = [("input", xg.grad, xc.grad)] + [
            (name, pg.grad, pc.grad) for (name, pg), pc in zip(lg.named_parameters(), lc.parameters())]
        for name, got, want in pairs:
            got = got.cpu()
            if beyond(got, want):
                raise RuntimeError(f"MP layer {index} alone: on the card's routing decisions, the {name} "
                                   f"gradient is off in {beyond(got, want)} elements")
            local_worst = max(local_worst, float((got - want).abs().max() / want.abs().max()))
    phase("train-parity", f"each of the {len(mlp_layers(gpu))} MP layers alone, on the CPU's inputs and "
          f"upstream gradient: the extremum kernel bitwise equal to the plain reduce of the card's messages; "
          f"aggregates card vs CPU within rtol 1e-4, atol 1e-4 x max (worst {agg_worst:.3e} of max, bitwise "
          f"equal in {bitwise_layers} layers, slots routed differently per layer {rerouted}); on the card's "
          f"routing decisions every gradient within rtol 1e-4, atol 1e-4 x max|g| (worst {local_worst:.3e} of max)")

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
    off, own_worst = 0, 0.0
    for (name, pg), pc, po in zip(gpu.named_parameters(), cpu.parameters(), own):
        c = pc.detach().numpy()
        np.testing.assert_allclose(pg.detach().cpu().numpy(), c, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(c).max()), err_msg=name)
        diff = np.abs(po.numpy() - c)
        off += int((diff > 1e-4 * np.abs(c) + 1e-4 * float(np.abs(c).max())).sum())
        own_worst = max(own_worst, float(diff.max()) / lr)
    phase("train-parity", f"clip + Adam on equal gradients: every parameter within rtol 1e-4, atol 1e-4 x "
          f"max|p|; from the card's own gradients the largest parameter difference is {own_worst:.3e} "
          f"learning rates, {off} elements beyond that tolerance")


def repeat_check(model, device_batch, dev, name="train-parity"):
    """Two train steps from the same weights and dropout seed give the same
    bits: every kernel and reduction of the step adds in a fixed order."""
    from ptgnn_tpu_torch.core.trainer import module_loss

    batch, targets = device_batch
    for dtype_name, amp in (("float32", False), ("bf16 AMP", True)):
        runs = []
        for _ in range(2):
            m = model.build_neural_module(device=dev, seed=SEED)
            loss, _ = module_loss(m, {"batch": batch, "target_classes": targets}, train=True,
                                  generator=torch.Generator(device=dev).manual_seed(SEED), amp=amp)
            loss.backward()
            runs.append([loss.detach()] + [p.grad for p in m.parameters()])
        differ = sum(not torch.equal(a, b) for a, b in zip(*runs))
        if differ:
            raise RuntimeError(f"a {dtype_name} train step gave other bits on a second run in {differ} tensors")
    phase(name, f"a train step (dropout on) repeats bit for bit, float32 and bf16 AMP: the loss "
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
    eval_losses = {}
    for name, amp in (("float32", False), ("bf16", True)):
        before, before_forwards = sk.launch_counts(), forwards[0]
        eval_losses[name] = eval_forward_phase(module, batches, card, "ppi-serving", reps, amp)
        per_forward = {k: v / (forwards[0] - before_forwards) for k, v in delta(sk.launch_counts(), before).items()}
        if per_forward != PPI_PER_FORWARD[name]:
            raise RuntimeError(f"expected {PPI_PER_FORWARD[name]} launches per {name} forward, got {per_forward}")
        phase("ppi-serving", f"{name} launches per forward {per_forward}")
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
    from ptgnn_tpu_torch.core.trainer import ModelTrainer, shuffle_seed
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


def typed_matmul_checks(adj, dev, gen, max_abs_err, shapes=((512, 256), (256, 256)),
                        dtypes=(torch.bfloat16, torch.float32), name="ppi-parity"):
    """The typed matmul kernel at ``shapes`` (both PPI shapes by default) in
    ``dtypes``: within 2^-8 |ref| + 1e-5 sum|x||w| of float64 (its plain
    version too), the same bits on a second run and under a permutation of
    same-type tiles and of the rows inside each tile."""
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
    for din, m in shapes:
        for dtype in dtypes:
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
    phase(name, f"typed matmul kernel at [{nt * tile}, D] x [3, D, M], D x M and dtype {done}: within "
          f"2^-8 |ref| + 1e-5 sum|x||w| of float64 (its plain version too; kernel vs plain max abs err "
          f"{ {k: v for k, v in max_abs_err.items() if k.startswith('typed') and k.split()[1] in [f'{d}x{m}' for d, m in shapes]} }), bitwise from run to run "
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
    cpu_plan = tree_to(plan, torch.device("cpu"))
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
            if not bitwise_equal(got.cpu(), sk.segment_sum_plain(data.cpu(), cpu_plan, num_nodes)):
                raise RuntimeError(f"sum kernel != its plain version on the CPU on the PPI layout at {width}/{dtype}")
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
    phase("ppi-parity", f"on the PPI layout: sum kernel at 256 and 512 (f32, bf16) bitwise equal to its plain "
          f"version on the CPU, within 1e-5 x sum|x| of the one on the card (max abs err "
          f"{ {k: v for k, v in max_abs_err.items() if k.startswith('segment_sum')} }), bitwise on 0/1 data and "
          f"run to run; broadcast at 256 (f32, bf16) bitwise equal to its plain version")

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


def ppi_kernel_entries(adj, dev, gen, max_abs_err, counts, launches_by_path, shapes=((512, 256), (256, 256)),
                       dtypes=((torch.bfloat16, BF16_OPS_PER_S), (torch.float32, F32_OPS_PER_S)), layout="ppi"):
    """kernels-line entries of the typed matmul at ``shapes`` (both PPI
    shapes by default) and ``dtypes`` on the ``layout``'s tiles. Library
    call: today's bmm route (index_select + torch.bmm)."""
    from ptgnn_tpu_torch.ops import typed_linear as ttl

    tt, tile = adj.tile_types, adj.edge_tile
    nt = tt.shape[0]
    e = nt * tile
    entries = []
    for din, m in shapes:
        for dtype, peak in dtypes:
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
                f"launches_per_{layout.replace('-', '_')}_train_step":
                    (PPI_PER_TRAIN_STEP if layout == "ppi" else EDGE_PER_TRAIN_STEP)["bf16"]["typed_matmul"]
                    if dtype == torch.bfloat16 else 0,
                "max_abs_err": max_abs_err[f"typed_matmul {din}x{m} {dname}"],
                "ms": times["ms"], "plain_ms": times["plain_ms"],
                "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": times["library_ms"], "shape": [e, din, m, 3], "dtype": dname, "layout": layout,
            }
            entries.append(entry)
            phase("kernels", json.dumps(entry))
            del xs
    return entries


def build_bench(dev, **kw):
    """The benchmark configuration's model, its module on the card and its
    minibatches, host and device-resident."""
    from ptgnn_tpu_torch.implementations.typilus.harness import bench_graph_count, build_graph2class
    from ptgnn_tpu_torch.implementations.typilus.train import default_padding

    model, module, minibatches = build_graph2class(
        padding=default_padding(), num_metadata_graphs=bench_graph_count(NUM_BATCHES),
        mean_nodes=2500, max_graph_nodes=8000, hidden_state_size=64, seed=SEED,
        num_minibatches=NUM_BATCHES, minibatch_size=300, device=dev, **kw,
    )
    batches = [(mb["batch"].to(dev), torch.from_numpy(mb["target_classes"]).to(dev)) for mb in minibatches]
    return model, module, minibatches, batches


def mp_layers(module):
    return [layer for layer in module.gnn.message_passing_layers if hasattr(layer, "aggregation_fn")]


def g2c_minibatch(device_batch):
    """A Graph2Class (batch, targets) pair as the module's keyword arguments."""
    batch, targets = device_batch
    return {"batch": batch, "target_classes": targets}


def step_against_cpu(model, device_mb, host_mb, dev, name, hook=None):
    """One float32 train step (dropout 0) from the same weights on the card,
    on the CPU, and on the CPU with the card's routing decisions
    (``routing_tape``), of a task module's minibatch: ``device_mb`` on the
    card, ``host_mb`` its host arrays.

    Max aggregation routes each (node, column)'s cotangent to the slots that
    attain the maximum. Where the devices' few-ulp forward differences order
    a near-tie differently, a cotangent moves wholesale to another slot and
    everything upstream inherits it; how many such near-ties there are
    depends on the host CPU's arithmetic. So the CPU's own step is held on
    its loss (rtol 1e-5), and its gradients are reported beside the routing
    decisions it takes differently. The CPU's step on the card's decisions
    is held on its loss (rtol 1e-5) and on every gradient elementwise (rtol
    1e-4, atol 1e-4 x the tensor's largest magnitude).

    ``hook(module, side)``, if given, registers hooks on the card's module
    (side "gpu") and the CPU's own (side "cpu") before their steps and
    returns the handles. Returns (card module, CPU module, [(name, card
    gradient on the host, CPU gradient)])."""
    from ptgnn_tpu_torch.core.trainer import module_loss
    from ptgnn_tpu_torch.graph.structs import tree_to

    cpu_mb = tree_to(host_mb, torch.device("cpu"))

    def step(side, tape, replay=False):
        device = dev if side == "gpu" else "cpu"
        module = model.build_neural_module(device=device, seed=SEED)
        set_dropout(module, 0.0)
        handles = hook(module, side) if hook is not None and not replay else []
        with routing_tape(tape, replay):
            loss, _ = module_loss(module, device_mb if side == "gpu" else cpu_mb,
                                  train=True, generator=torch.Generator(device=device))
            loss.backward()
        for handle in handles:
            handle.remove()
        return module, float(loss.detach())

    card_tape, own_tape = [], []
    gpu, gpu_loss = step("gpu", card_tape)
    cpu, cpu_loss = step("cpu", own_tape)
    pinned, pinned_loss = step("cpu", card_tape, replay=True)
    np.testing.assert_allclose(gpu_loss, cpu_loss, rtol=1e-5)
    np.testing.assert_allclose(gpu_loss, pinned_loss, rtol=1e-5)
    grads = [(pname, pg.grad.cpu(), pc.grad, pp.grad)
             for (pname, pg), pc, pp in zip(gpu.named_parameters(), cpu.parameters(), pinned.parameters())]
    worst = 0.0
    for pname, got, _, want in grads:
        if beyond(got, want):
            raise RuntimeError(f"{name}: on the card's routing decisions, the CPU's {pname} gradient is "
                               f"off in {beyond(got, want)} elements")
        worst = max(worst, float((got - want).abs().max() / want.abs().max()))
    free = max((float((got - own).norm() / own.norm()), pname) for pname, got, own, _ in grads)
    phase(name, f"train step (dropout 0) card vs CPU: loss {gpu_loss:.7f} vs {cpu_loss:.7f} (rtol 1e-5); on the "
          f"card's routing decisions, loss {pinned_loss:.7f} and all {len(grads)} gradients within rtol 1e-4, "
          f"atol 1e-4 x max|g| (worst {worst:.3e} of max); on its own, the CPU takes "
          f"{routing_differences(card_tape, own_tape)} routing decisions differently per routing call, and "
          f"its gradients lie up to {free[0]:.3e} of their norm from the card's ({free[1]})")
    return gpu, cpu, [(pname, got, own) for pname, got, own, _ in grads]


def argmax_phase(dev, card):
    """Graph2Class at the benchmark configuration with argmax routing: the
    train path (ModelTrainer.train, train_steps), the step against the CPU,
    each layer's argmax extremum against its plain version, and a repeat.
    Returns the launch counts of the path."""
    from ptgnn_tpu_torch.ops import fused_mp
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.ops.typed_linear import typed_tile_matmul

    t0 = time.perf_counter()
    model, _, minibatches, batches = build_bench(dev, argmax_routing=True)
    phase("argmax-train", f"setup {time.perf_counter() - t0:.2f} s (model, metadata, 6 batches)")
    counts = train_phase(model, batches, dev, card, "argmax-train", ARGMAX_PER_FORWARD, ARGMAX_PER_TRAIN_STEP)

    inputs = []

    def keep_inputs(module, side):
        return [layer.register_forward_pre_hook(lambda mod, args: inputs.append(args[0].detach()))
                for layer in mp_layers(module)] if side == "gpu" else []

    gpu, _, _ = step_against_cpu(model, g2c_minibatch(batches[0]), minibatches[0], dev, "argmax-train", keep_inputs)
    adj = batches[0][0].adjacency
    cpu_adj = minibatches[0]["batch"].to("cpu").adjacency
    plan = sk.plan_from_adjacency(adj)
    rerouted, winners = [], 0
    for index, (layer, x) in enumerate(zip(mp_layers(gpu), inputs)):
        if not layer.argmax_routing:
            raise RuntimeError(f"MP layer {index} does not route by argmax")
        w = layer.message_mlp.weights_0.detach()
        _, args_g, inp = fused_mp._fused_fwd_impl(x, w, adj, None, x.shape[0], "max", True, 1.0, True)
        msgs = typed_tile_matmul(inp, w, adj.tile_types, adj.edge_tile)
        work = torch.where(adj.mask[:, None], msgs, torch.full((), -3.0e38, device=dev)).contiguous()
        vals, args = sk.planned_segment_extremum_with_argmax(work, plan, x.shape[0], True)
        plain_vals, plain_args = sk.segment_extremum_argmax_plain(work, plan, x.shape[0], True)
        if not (bitwise_equal(vals + 0.0, plain_vals + 0.0) and torch.equal(args, plain_args)
                and torch.equal(args, args_g)):
            raise RuntimeError(f"MP layer {index}: the argmax extremum kernel differs from its plain version")
        winners += int((args >= 0).sum())
        _, args_c, _ = fused_mp._fused_fwd_impl(x.cpu(), w.cpu(), cpu_adj, None, x.shape[0], "max", True, 1.0, True)
        rerouted.append(int((args_c != args.cpu()).sum()))
    torch.cuda.synchronize()
    phase("argmax-train", f"each of the {len(inputs)} MP layers on the card's own messages: the argmax extremum "
          f"kernel equals its plain version (values bitwise, {winners} winning slots exactly); from the same "
          f"inputs the CPU picks another winner in {rerouted} (node, column)s per layer")
    repeat_check(model, batches[0], dev, "argmax-train")
    return counts


def ggnn_phase(dev, card, reps: int = 3):
    """The 'ggnn' stack at hidden 64 on the benchmark batches: serving
    forwards and train_steps with their launches, then the logits and a
    train step against the CPU, and a repeat. Returns the launch counts of
    the path."""
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    t0 = time.perf_counter()
    model, module, minibatches, batches = build_bench(dev, architecture="ggnn")
    layers = module.gnn.message_passing_layers
    shared = sum(layer is layers[1] for layer in layers)
    phase("ggnn", f"setup {time.perf_counter() - t0:.2f} s; {len(layers)} stack entries, one gated layer object "
          f"at {shared} positions; {sum(p.numel() for p in module.parameters())} parameters")
    module.eval()
    forwards = [0]
    counter = module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    sk.reset_launch_counts()  # the ggnn path starts here
    sizes = [(int(mb["batch"].num_graphs), int(mb["batch"].num_nodes), int(mb["batch"].num_edges)) for mb in minibatches]
    g, n, e = (reps * sum(s[i] for s in sizes) for i in range(3))
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
    counter.remove()
    serving = sk.launch_counts()
    if serving != {k: v * forwards[0] for k, v in GGNN_PER_FORWARD.items()}:
        raise RuntimeError(f"expected {GGNN_PER_FORWARD} launches per ggnn forward, got {serving}")
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite ggnn eval losses {losses}")
    phase("ggnn", f"serving forward over {reps * len(batches)} device-resident batches: eval loss "
          f"{float(losses[:len(batches)].mean()):.6f}, {1e3 * elapsed / (reps * len(batches)):.3f} ms/batch, "
          f"{g / elapsed:.1f} graphs/s, {n / elapsed:.0f} nodes/s, {e / elapsed:.0f} edges/s on {card}; "
          f"launches over {forwards[0]} forwards {serving}")
    train_steps_phase(model, [g2c_minibatch(b) for b in batches], dev, card, "ggnn", GGNN_PER_TRAIN_STEP)
    counts = sk.launch_counts()  # the ggnn path ends here
    expected = add_counts(serving, {k: v * 2 * (TRAIN_STEPS + 1) for k, v in GGNN_PER_TRAIN_STEP.items()})
    phase("ggnn", f"launches over the ggnn path: {counts}")
    if counts != expected:
        raise RuntimeError(f"ggnn launches {counts} != {expected} expected")

    cpu = model.build_neural_module(device="cpu", seed=SEED).eval()
    with torch.inference_mode():
        gpu_logits = module._logits(batches[0][0], train=False)[0].cpu().numpy()
        cpu_logits = cpu._logits(minibatches[0]["batch"].to("cpu"), train=False)[0].numpy()
    atol = 1e-4 * float(np.abs(cpu_logits).max())
    np.testing.assert_allclose(gpu_logits, cpu_logits, rtol=1e-4, atol=atol)
    phase("ggnn", f"logits card vs CPU: max abs err {float(np.abs(gpu_logits - cpu_logits).max()):.3e} "
          f"(rtol 1e-4, atol {atol:.3e} = 1e-4 x max|logit|)")
    step_against_cpu(model, g2c_minibatch(batches[0]), minibatches[0], dev, "ggnn")
    repeat_check(model, batches[0], dev, "ggnn")
    return counts


def cli_phase(card):
    """The Typilus train CLI for one epoch on synthetic folds under build/
    ('mlp' with the argmax switch, then 'ggnn'), then the predict CLI on the
    saved model. Returns the launch counts of the path."""
    import io as stdio
    import os
    import shutil

    from ptgnn_tpu_torch.implementations.typilus import predict as typilus_predict
    from ptgnn_tpu_torch.implementations.typilus import train as typilus_train
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.utils.io import write_jsonl_gz
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    root = Path(__file__).resolve().parent / "build" / "chip_smoke" / "cli"
    shutil.rmtree(root, ignore_errors=True)
    folds = []
    for i, (fold, count) in enumerate((("train", 12), ("valid", 4), ("test", 4))):
        (root / fold).mkdir(parents=True)
        write_jsonl_gz(root / fold / "part0.jsonl.gz",
                       synthetic_typilus_graphs(count, seed=SEED + 20 + i, mean_nodes=1500, max_nodes=4000))
        folds.append(str(root / fold))
    cwd = os.getcwd()
    os.chdir(root)  # the train CLI's log file goes under the working directory
    sk.reset_launch_counts()  # the cli path starts here
    try:
        runs = {}
        for architecture, argmax in (("mlp", True), ("ggnn", False)):
            if argmax:
                os.environ[typilus_train.ARGMAX_ROUTING_ENV] = "1"
            before = sk.launch_counts()
            t0 = time.perf_counter()
            out = stdio.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    accuracy = typilus_train.run(typilus_train.build_arg_parser().parse_args(
                        [*folds, str(root / f"{architecture}.pkl.gz"), "--max-num-epochs", "1", "--quiet",
                         "--architecture", architecture]))
            finally:
                os.environ.pop(typilus_train.ARGMAX_ROUTING_ENV, None)
            launched = delta(sk.launch_counts(), before)
            if (launched["segment_extremum_argmax"] > 0) != argmax or (launched["segment_extremum"] > 0) == argmax:
                raise RuntimeError(f"the {architecture} CLI run took the wrong extremum: {launched}")
            line = [ln for ln in out.getvalue().splitlines() if ln.startswith("Test accuracy:")]
            runs[architecture] = accuracy
            phase("cli", f"train --architecture {architecture}{' (PTGNN_TPU_ARGMAX_ROUTING=1)' if argmax else ''}: "
                  f"1 epoch over {len(os.listdir(folds[0]))} file(s) of 12 graphs in {time.perf_counter() - t0:.2f} s; "
                  f"'{line[0] if line else '(no line)'}'; launches {launched}")
            if not line or not 0.0 <= accuracy <= 1.0:
                raise RuntimeError(f"the {architecture} train CLI printed no test accuracy")
        out = stdio.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            printed = typilus_predict.run(typilus_predict.build_arg_parser().parse_args(
                [str(root / "ggnn.pkl.gz"), folds[2]]))
        lines = out.getvalue().strip().splitlines()
    finally:
        os.chdir(cwd)
    counts = sk.launch_counts()  # the cli path ends here
    if printed != len(lines) or printed == 0 or not all(" Predicted: `" in ln for ln in lines):
        raise RuntimeError(f"predict printed {len(lines)} lines, counted {printed}")
    phase("cli", f"predict on the ggnn model: {printed} suggestions for the 4 test graphs in "
          f"{time.perf_counter() - t0:.2f} s, e.g. {lines[0]!r}; launches over the cli path {counts}")
    return counts


def varmisuse_samples():
    """(padding, mean_tokens, samples, validation samples): VarMisuse's
    ``vm_padding()`` and synthetic samples whose ``mean_tokens`` rises in
    steps of 10 until the batches hold at least 75 % of the 8,192-node
    budget (or the edge slots bind first)."""
    from ptgnn_tpu_torch.implementations.varmisuse.harness import full_width_samples
    from ptgnn_tpu_torch.implementations.varmisuse.train import vm_padding
    from ptgnn_tpu_torch.utils.synthetic import synthetic_varmisuse_samples

    padding = vm_padding()
    t0 = time.perf_counter()
    mean_tokens, samples, tries = full_width_samples(VM_BATCHES * padding.max_graphs, padding, seed=SEED)
    valid = list(synthetic_varmisuse_samples(padding.max_graphs, seed=SEED + 1, mean_tokens=mean_tokens))
    phase("varmisuse", f"mean_tokens search (mean_tokens, node fill of the first batches, graphs) {tries} in "
          f"{time.perf_counter() - t0:.2f} s: mean_tokens {mean_tokens}, {len(samples)} training samples")
    return padding, mean_tokens, samples, valid


def varmisuse_phase(dev, card, architecture, padding, samples, valid, reps: int = 3):
    """VarMisuse at full width in the ``architecture`` stack: the host
    pipeline, report_accuracy, the eval forward over device-resident
    batches, ModelTrainer.train for an epoch with validation, train_steps in
    float32 and bf16 AMP, with the launches of every part; then a float32
    step (dropout 0) card against CPU. Returns (the launch counts of the
    path, the host and device minibatches)."""
    from ptgnn_tpu_torch.core.trainer import ModelTrainer, shuffle_seed
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.implementations.varmisuse.harness import build_varmisuse
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    name = f"varmisuse-{architecture}"
    per_forward, per_step = VM_PER_FORWARD[architecture], VM_PER_TRAIN_STEP[architecture]
    t0 = time.perf_counter()
    model, module, minibatches = build_varmisuse(padding=padding, samples=samples, architecture=architecture,
                                                 seed=SEED, device=dev)
    t_host = time.perf_counter() - t0
    drops = sum(model.tensorize(s) is None for s in samples)
    batches = [tree_to(mb, dev) for mb in minibatches[:VM_BATCHES]]
    torch.cuda.synchronize()
    sizes = [(int(mb["batch"].num_graphs), int(mb["batch"].num_nodes), int(mb["batch"].num_edges)) for mb in minibatches]
    fill = min(n for g, n, _ in sizes[:VM_BATCHES]) / padding.max_nodes
    edges_bind = any(g < padding.max_graphs for g, _, _ in sizes[:VM_BATCHES - 1])
    stacks = {tuple(p.shape) for n, p in module.named_parameters() if n.endswith(("weights_0", "message_weights"))}
    phase(name, f"host metadata + tensorize + batching of {len(samples)} samples in {t_host:.2f} s "
          f"({1e3 * t_host / len(minibatches):.0f} ms/batch); {drops} samples dropped by the budgets; "
          f"{len(minibatches)} batches of (graphs, nodes, materialized edges) {sizes}, "
          f"{padding.max_edge_slots} edge slots each; smallest node fill {fill:.4f}; "
          f"{sum(p.numel() for p in module.parameters())} parameters; message weight stacks {sorted(stacks)}")
    if drops or not (fill >= 0.75 or edges_bind):
        raise RuntimeError(f"the batches fill {fill:.4f} of the node budget with {drops} samples dropped")

    module.eval()
    forwards, backwards = [0], [0]
    counter = module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    sk.reset_launch_counts()  # the varmisuse path starts here
    t0 = time.perf_counter()
    accuracy = model.report_accuracy(samples, module, max_minibatch_size=300, device=dev)
    t_acc = time.perf_counter() - t0
    if not 0.0 <= accuracy <= 1.0:
        raise RuntimeError(f"report_accuracy gave {accuracy}")
    phase(name, f"report_accuracy {accuracy:.4f} over {len(samples)} samples in {t_acc:.2f} s "
          f"({forwards[0]} forwards; host tensorize + batching included)")
    eval_forward_phase(module, batches, card, name, reps)
    counter.remove()
    serving = sk.launch_counts()
    if serving != {k: v * forwards[0] for k, v in per_forward.items()}:
        raise RuntimeError(f"expected {per_forward} launches per {name} forward, got {serving} over {forwards[0]}")
    phase(name, f"launches over the serving path's {forwards[0]} forwards {serving}")

    checkpoint = Path(__file__).resolve().parent / "build" / "chip_smoke" / f"{name}.pkl.gz"
    trainer = ModelTrainer(
        model, checkpoint, max_num_epochs=1, minibatch_size=300, clip_gradient_norm=0.5,
        optimizer_creator=lambda p: torch.optim.Adam(p, lr=1e-4), target_validation_metric="Accuracy",
        target_validation_metric_higher_is_better=True, device=dev, seed=SEED,
    )
    trainer.load_metadata_and_create_network(samples, parallelize=False)
    hooks = [
        trainer.neural_module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1)),
        trainer.neural_module.candidate_scores.weight.register_hook(
            lambda grad: backwards.__setitem__(0, backwards[0] + 1)),
    ]
    valid_metrics = []
    trainer.register_validation_epoch_end_hook(lambda m, mod, ep, metrics: valid_metrics.append(metrics))
    before_fw = forwards[0]
    t0 = time.perf_counter()
    trainer.train(samples, valid, initialize_metadata=False, patience=0)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    for hook in hooks:
        hook.remove()
    fw, bw = forwards[0] - before_fw, backwards[0]
    phase(name, f"ModelTrainer.train: 1 epoch over {len(samples)} samples with validation over {len(valid)} "
          f"before and after in {t_train:.2f} s (host tensorize + batching included): {bw} train steps, "
          f"{fw - bw} validation forwards; validation metrics {valid_metrics}")
    if bw == 0 or not checkpoint.exists():
        raise RuntimeError(f"{name}: ModelTrainer.train took no step or wrote no checkpoint")
    expected = {k: serving[k] + per_forward[k] * fw + (per_step[k] - per_forward[k]) * bw for k in serving}
    expected = add_counts(expected, train_steps_phase(model, batches, dev, card, name, per_step, VM_TRAIN_STEPS,
                                                      learning_rate=1e-4, clip_gradient_norm=0.5))
    counts = sk.launch_counts()  # the varmisuse path ends here
    phase(name, f"launches of K1 (segment_sum), K2 (segment_extremum), K3 (broadcast_to_edges), K4 "
          f"(segment_extremum_argmax) and K5 (typed_matmul) over the {name} path: {counts}; K5's bf16 gate "
          f"{'opened' if counts['typed_matmul'] else 'stayed closed'} (it needs D and M multiples of 128 and "
          f"128 KB weight blocks)")
    if counts != expected:
        raise RuntimeError(f"{name} launches {counts} != {expected} expected")
    needed = ("segment_sum", "segment_extremum", "broadcast_to_edges") if architecture == "mlp" else (
        "segment_sum", "broadcast_to_edges")
    if min(counts[k] for k in needed) <= 0:
        raise RuntimeError(f"{name}: a kernel of the path was never launched: {counts}")

    scores = {}

    def keep_scores(m, side):
        return [m.candidate_scores.register_forward_hook(
            lambda mod, args, out: scores.__setitem__(side, out.detach().float().cpu()))]

    step_against_cpu(model, batches[0], minibatches[0], dev, name, keep_scores)
    got, want = scores["gpu"].numpy(), scores["cpu"].numpy()
    atol = 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    phase(name, f"candidate scores (the logits) of that step card vs CPU: max abs err "
          f"{float(np.abs(got - want).max()):.3e} (rtol 1e-4, atol {atol:.3e} = 1e-4 x max|score|)")
    return counts, minibatches, batches


def varmisuse_kernel_checks(adj, dev, gen):
    """K1, K2 and K3 against their plain versions on a VarMisuse batch's
    layout (9 edge types, 65,536 slots) at the path's widths: K2 at M 64
    and 128 (max; bitwise), K3 at 64, 128, 192 and 384 (the node states and
    the backward's widened rows; bitwise), K1 at 64, 128 and 256 (bitwise
    equal to its plain version on the CPU). Then K1, K2 and K3 at width 64
    timed beside their plain versions and library calls, a line each."""
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    ext_plan, sum_plan = sk.plan_from_adjacency(adj), sk.sum_plan_from_adjacency(adj)
    cpu_plan = tree_to(sum_plan, torch.device("cpu"))
    num_nodes = adj.agg_counts.numel()
    e_pad, e_real = adj.mask.shape[0], int(adj.mask.sum())

    def masked(width, fill):
        data = torch.randn(e_pad, width, device=dev, generator=gen)
        return torch.where(adj.mask[:, None], data, torch.full((), fill, device=dev)).contiguous()

    for width in (64, 128):
        data = masked(width, -3.0e38)
        if not bitwise_equal(sk.planned_segment_extremum(data, ext_plan, num_nodes, True),
                             sk.segment_extremum_plain(data, ext_plan, num_nodes, True)):
            raise RuntimeError(f"extremum kernel != plain version on the VarMisuse layout at {width}")
    for width in (64, 128, 192, 384):
        table = torch.randn(num_nodes, width, device=dev, generator=gen)
        if not bitwise_equal(sk.planned_broadcast_to_edges(table, sum_plan), sk.broadcast_plain(table, sum_plan)):
            raise RuntimeError(f"broadcast kernel != plain version on the VarMisuse layout at {width}")
    for width in (64, 128, 256):
        data = masked(width, 0.0)
        if not bitwise_equal(sk.planned_segment_sum(data, sum_plan, num_nodes).cpu(),
                             sk.segment_sum_plain(data.cpu(), cpu_plan, num_nodes)):
            raise RuntimeError(f"sum kernel != its plain version on the CPU on the VarMisuse layout at {width}")
    torch.cuda.synchronize()
    phase("kernels", f"VarMisuse layout ({e_real} real slots of {e_pad}, {int(adj.tile_types.max()) + 1} types): "
          f"extremum at 64 and 128, broadcast at 64, 128, 192 and 384 bitwise equal to their plain versions, "
          f"the sum at 64, 128 and 256 bitwise equal to its plain version on the CPU")

    width = 64
    for name in ("segment_sum", "segment_extremum", "broadcast_to_edges"):
        k = layout_kernel(name, adj, width, dev, gen)
        entry = {"name": name, "layout": "VarMisuse batch", **layout_times(k), **bound(k.nbytes, k.ops),
                 "width": width, "dtype": "float32"}
        phase("kernels", "VarMisuse layout " + json.dumps(entry))


def graph2seq_samples():
    """(padding, mean_nodes, training, validation and test samples):
    Graph2Seq's ``g2s_padding()`` and synthetic samples whose ``mean_nodes``
    rises in steps of 10 until the batches hold at least 75 % of the
    16,384-node budget (or the edge slots bind first)."""
    from ptgnn_tpu_torch.implementations.graph2seq.harness import full_width_samples
    from ptgnn_tpu_torch.implementations.graph2seq.train import g2s_padding
    from ptgnn_tpu_torch.utils.synthetic import synthetic_graph2seq_samples

    padding = g2s_padding()
    t0 = time.perf_counter()
    mean_nodes, samples, tries = full_width_samples(G2S_BATCHES * padding.max_graphs, padding, seed=SEED)

    def more(n, seed):
        return list(synthetic_graph2seq_samples(n, seed=seed, mean_nodes=mean_nodes, max_nodes=5 * mean_nodes // 2))

    valid, test = more(padding.max_graphs, SEED + 1), more(G2S_TEST_BATCHES * padding.max_graphs, SEED + 2)
    phase("graph2seq", f"mean_nodes search (mean_nodes, node fill of the first batches, graphs) {tries} in "
          f"{time.perf_counter() - t0:.2f} s: mean_nodes {mean_nodes}, {len(samples)} training, {len(valid)} "
          f"validation and {len(test)} test samples")
    return padding, samples, valid, test


@contextlib.contextmanager
def sync_debug_error():
    """Any call that waits for the card raises inside the block."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def decode_parity(model, module, test, dev, batch_graphs):
    """Greedy decode of one test batch on the card against the CPU (same
    weights), the device loop against the host loop on the card, and beam 1
    against greedy."""
    data = test[:batch_graphs]
    card = model.greedy_decode(data, module, max_minibatch_size=batch_graphs, device=dev)
    cpu_module = model.build_neural_module(device="cpu", seed=SEED)
    for (k, a), b in zip(module.state_dict().items(), cpu_module.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise RuntimeError(f"the CPU module's weights differ at {k}")
    cpu = model.greedy_decode(data, cpu_module, max_minibatch_size=batch_graphs, device="cpu")
    if [t for t, _ in card] != [t for t, _ in cpu]:
        diffs = [i for i, (a, b) in enumerate(zip(card, cpu)) if a[0] != b[0]]
        raise RuntimeError(f"greedy tokens differ between card and CPU at samples {diffs}")
    lp_err = max(abs(a[1] - b[1]) for a, b in zip(card, cpu))
    if lp_err > 1e-4:
        raise RuntimeError(f"greedy log-probabilities card vs CPU differ by {lp_err}")
    vocab_size = len(model.decoder_model.vocabulary)
    host = model._decode_minibatches(
        data, module, functools.partial(model.decoder_model.greedy_decode, device_resident=False, top_k=vocab_size),
        batch_graphs, dev)
    if [t for t, _ in card] != [t for t, _ in host]:
        raise RuntimeError("the device loop's greedy tokens differ from the host loop's on the card")
    host_err = max(abs(a[1] - b[1]) for a, b in zip(card, host))
    beam1 = model.beam_decode(data, module, beam_size=1, max_minibatch_size=batch_graphs, device=dev)
    if [b[0][0] for b in beam1] != [t for t, _ in card]:
        raise RuntimeError("beam 1 tokens differ from greedy's on the card")
    beam_err = max(abs(b[0][1] - a[1]) for a, b in zip(card, beam1))
    copies = sum(bool(set(t) & {label.lower() for label in s["node_labels"]}) for (t, _), s in zip(card, data))
    phase("graph2seq", f"greedy decode of {len(data)} samples card vs CPU: the same tokens, log-probabilities "
          f"within {lp_err:.3e} (limit 1e-4); the device loop vs the host loop on the card: the same tokens "
          f"(log-probabilities within {host_err:.3e}); beam 1 vs greedy: the same tokens (within "
          f"{beam_err:.3e}); {copies} of the sequences hold a token of their graph, e.g. {card[0]}")


def graph2seq_vocabulary_cap(dev, card, host_batch, reps: int = 3):
    """The decoder alone with an output vocabulary at its 20,000-token cap,
    on one Graph2Seq batch's memory layout with random memories, initial
    states and targets: the eval loss, one train step and one greedy decode
    batch, timed."""
    from ptgnn_tpu_torch.core.trainer import optimizer_step
    from ptgnn_tpu_torch.implementations.graph2seq.harness import decoder_at_vocabulary_cap
    from ptgnn_tpu_torch.nn.module import init_parameters

    model = decoder_at_vocabulary_cap()
    decoder = model.build_neural_module()
    init_parameters(decoder, SEED)
    decoder = decoder.to(dev)
    vocab = model.vocabulary
    ref = host_batch["batch"].references["backbone_nodes"]
    origin, mask = torch.from_numpy(ref.graph_ids).to(dev), torch.from_numpy(ref.mask).to(dev)
    m_pad, b_pad, s = ref.mask.shape[0], host_batch["target_token_ids"].shape[0], model.max_seq_len
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    memories = torch.randn(m_pad, model.memories_hidden_dim, device=dev, generator=gen)
    initial = torch.randn(b_pad, model.hidden_size, device=dev, generator=gen)
    real = int(ref.mask.sum())
    concrete = [f"tok{i}" for i in rng.randint(0, 2 * len(vocab), real)]  # half of them out of vocabulary
    token_ids = np.zeros((b_pad, s), np.int32)
    lengths = host_batch["target_lengths"]
    token_ids[:, 0] = vocab.get_id_or_unk(model.START)
    for b in range(b_pad):
        if lengths[b]:
            token_ids[b, 1:lengths[b]] = rng.randint(3, len(vocab), lengths[b] - 1)
            token_ids[b, lengths[b] - 1] = vocab.get_id_or_unk(model.END)
    batch = {
        "input_memories": memories, "input_memories_origin_idx": origin, "memory_mask": mask,
        "initial_states": initial, "target_token_ids": torch.from_numpy(token_ids).to(dev),
        "target_lengths": torch.from_numpy(lengths).to(dev),
        "copy_matrix": torch.from_numpy(host_batch["copy_matrix"]).to(dev),
    }
    optimizer = torch.optim.Adam(decoder.parameters(), lr=1e-3)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps, out

    def eval_loss():
        with torch.inference_mode():
            return decoder(**batch)[0]

    def train_step():
        loss, _ = decoder(**batch, train=True, generator=gen)
        loss.backward()
        optimizer_step(decoder, optimizer, [1e-3])
        return loss.detach()

    def greedy():
        return model.greedy_decode(input_concrete_values=concrete, input_memories=memories,
                                   input_memories_origin_idx=origin, memory_mask=mask, initial_states=initial,
                                   neural_module=decoder, num_real_targets=int((lengths > 0).sum()))

    eval_ms, loss = timed(eval_loss)
    step_ms, step_loss = timed(train_step)
    decode_ms, decoded = timed(greedy)
    if not (math.isfinite(float(loss)) and math.isfinite(float(step_loss))):
        raise RuntimeError(f"the vocabulary-cap decoder gave losses {float(loss)}, {float(step_loss)}")
    if not decoded or not all(math.isfinite(lp) for _, lp in decoded):
        raise RuntimeError("the vocabulary-cap greedy decode gave no or non-finite results")
    phase("graph2seq", f"decoder at the {len(vocab)}-token vocabulary cap ([{b_pad}, {s - 1}, {len(vocab)}] "
          f"vocabulary scores, {m_pad} memory slots of which {real} real, copy merge over {b_pad} x "
          f"{len(vocab)} segments): eval loss {float(loss):.4f} in {eval_ms:.3f} ms, train step {step_ms:.3f} ms "
          f"(loss {float(step_loss):.4f}), greedy decode of {len(decoded)} sequences {decode_ms:.3f} ms/batch "
          f"on {card}; e.g. {decoded[0]}")


def graph2seq_stock_sums(dev, card, host_batch):
    """The two stock segment sums of Graph2Seq with the most data, each into
    the batch's 64 graph rows through ``index_add_`` (atomics on a few
    rows): the decoder's attention readout ``[M_pad, T, H]`` by memory origin,
    and the summariser's ``[N_pad, heads x 2D]`` by node graph. Timed as one
    call of ``ops.segment.segment_sum`` each, beside their bounds (each real
    element read once, the ids read, the rows written)."""
    from ptgnn_tpu_torch.ops.segment import segment_sum

    batch = host_batch["batch"]
    ref = batch.references["backbone_nodes"]
    b_pad = host_batch["target_token_ids"].shape[0]
    steps = host_batch["target_token_ids"].shape[1] - 1
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lines = []
    for label, ids, mask, shape in (
        ("decoder attention readout", ref.graph_ids, ref.mask, (ref.mask.shape[0], steps, 128)),
        ("summariser sum", batch.node_graph, batch.node_mask, (batch.node_mask.shape[0], 8 * 256)),
    ):
        ids, mask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
        datas = rotating(lambda: torch.randn(shape, device=dev, generator=gen), math.prod(shape) * 4)
        ms = graph_time_ms([lambda d=datas[i % len(datas)]: segment_sum(d, ids, b_pad, mask) for i in range(16)])
        real = int(mask.sum()) * math.prod(shape[1:])
        nbytes = real * 4 + int(mask.sum()) * 4 + b_pad * math.prod(shape[1:]) * 4
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * real / F32_OPS_PER_S
        lines.append(f"{label} {list(shape)} -> [{b_pad}, ...] {ms:.4f} ms (bound {max(bytes_ms, ops_ms):.4f} ms, "
                     f"{'bytes' if bytes_ms >= ops_ms else 'operations'})")
        del datas
    phase("graph2seq", f"stock segment sums (index_add_ into {b_pad} rows) on {card}: " + "; ".join(lines))


def graph2seq_phase(dev, card, padding, samples, valid, test, reps: int = 3):
    """Graph2Seq at full width (``create_graph2seq_model()`` defaults,
    ``g2s_padding()``): the host pipeline; serving (greedy and beam-5 decode
    over the test samples, ``test.evaluate``, the eval-loss forward over
    device-resident batches, and the decode loops under sync debug mode
    "error"); training (ModelTrainer.train for an epoch with validation,
    train_steps in float32 and bf16 AMP), with the launches of every part;
    a float32 step (dropout 0) and the greedy decode card against CPU; the
    decoder at the 20,000-token vocabulary cap. Returns (the launch counts
    of the path, the device minibatches)."""
    from ptgnn_tpu_torch.core.trainer import ModelTrainer, shuffle_seed
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.implementations.graph2seq import test as g2s_test
    from ptgnn_tpu_torch.implementations.graph2seq.harness import batch_sizes, build_graph2seq
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    name = "graph2seq"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    model, module, minibatches = build_graph2seq(padding=padding, samples=samples, seed=SEED, device=dev,
                                                 minibatch_size=padding.max_graphs)
    t_host = time.perf_counter() - t0
    drops = sum(model.tensorize(s) is None for s in samples)
    batches = [tree_to(mb, dev) for mb in minibatches[:G2S_BATCHES]]
    torch.cuda.synchronize()
    sizes = batch_sizes(minibatches)
    fill = min(n for _, n, _, _ in sizes[:G2S_BATCHES]) / padding.max_nodes
    edges_bind = any(g < padding.max_graphs for g, _, _, _ in sizes[:G2S_BATCHES - 1])
    phase(name, f"host metadata + tensorize + batching of {len(samples)} samples in {t_host:.2f} s "
          f"({1e3 * t_host / len(minibatches):.0f} ms/batch); {drops} samples dropped by the budgets; "
          f"{len(minibatches)} batches of (graphs, nodes, materialized edges, memories) {sizes}, "
          f"{padding.max_edge_slots} edge slots and {padding.reference_budget('backbone_nodes')} memory slots "
          f"each; smallest node fill {fill:.4f}; {len(model.gnn_model.node_embedding_model.vocabulary)} node "
          f"tokens, {len(model.decoder_model.vocabulary)} output tokens, "
          f"{sum(p.numel() for p in module.parameters())} parameters")
    if drops or not (fill >= 0.75 or edges_bind):
        raise RuntimeError(f"the batches fill {fill:.4f} of the node budget with {drops} samples dropped")

    module.eval()
    forwards, backwards = [0], [0]
    counter = module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    sk.reset_launch_counts()  # the graph2seq path starts here
    for warm_up in (model.greedy_decode, functools.partial(model.beam_decode, beam_size=G2S_BEAM)):
        warm_up(test[:padding.max_graphs], module, max_minibatch_size=padding.max_graphs, device=dev)
    timings = {}
    for label, fn in (
        ("greedy_decode", lambda: model.greedy_decode(test, module, max_minibatch_size=padding.max_graphs,
                                                      device=dev)),
        ("beam_decode(beam_size=5)", lambda: model.beam_decode(test, module, beam_size=G2S_BEAM,
                                                               max_minibatch_size=padding.max_graphs, device=dev)),
        ("test.evaluate", lambda: g2s_test.evaluate(model, module, test, verbose=False, device=dev)),
    ):
        before = forwards[0]
        t0 = time.perf_counter()
        out = fn()
        elapsed = time.perf_counter() - t0
        timings[label] = (out, elapsed, forwards[0] - before)
    greedy, beams, metrics = (timings[k][0] for k in timings)
    if any(r is None for r in greedy) or not all(math.isfinite(lp) and lp <= 1e-6 for _, lp in greedy):
        raise RuntimeError("greedy decode dropped a sample or gave a non-finite log-probability")
    for sample_beams in beams:
        scores = [s for _, s in sample_beams]
        if len(scores) != G2S_BEAM or scores != sorted(scores, reverse=True) or not math.isfinite(scores[0]):
            raise RuntimeError(f"beam decode gave unsorted or non-finite beams {sample_beams}")
    if not all(0.0 <= v <= 1.0 for v in metrics.values()):
        raise RuntimeError(f"test.evaluate gave {metrics}")
    for label, (_, elapsed, n) in timings.items():
        phase(name, f"{label} over {len(test)} test samples: {n} batches in {elapsed:.3f} s, "
              f"{1e3 * elapsed / n:.3f} ms/batch, {len(test) / elapsed:.1f} graphs/s on {card} (host tensorize "
              f"+ batching included)")
    phase(name, f"test.evaluate metrics (random weights) {metrics}; greedy e.g. {greedy[0]}; beams e.g. {beams[0][:2]}")

    # The decode loops of one test batch under sync debug mode "error": no
    # step waits for the card.
    decoder_model = model.decoder_model
    test_mb, raw = next(iter(model.minibatch_iterator(
        model.tensorize_dataset(iter(test), parallelize=False, return_input_data=True),
        max_minibatch_size=padding.max_graphs, parallelize=False)))
    values = [s["node_labels"][k].lower() for s in raw for k in s["backbone_sequence"]]
    with torch.inference_mode():
        memories, origin, memory_mask, initial_states, _ = module.encode(tree_to(test_mb["batch"], dev))
        vocab_size, unk_id = module.decoder.vocabulary_size, module.decoder.unk_id
        groups = [decoder_model._copy_groups(k, values, memories, origin, memory_mask, len(raw),
                                             padding.max_graphs, vocab_size, unk_id) for k in (1, G2S_BEAM)]
        torch.cuda.synchronize()
        with sync_debug_error():
            emitted, _ = decoder_model._greedy_loop(module.decoder, groups[0], initial_states)
            emits, _, _ = decoder_model._beam_loop(module.decoder, groups[1], initial_states, G2S_BEAM)
        loop_ms = []
        for loop in (lambda: decoder_model._greedy_loop(module.decoder, groups[0], initial_states),
                     lambda: decoder_model._beam_loop(module.decoder, groups[1], initial_states, G2S_BEAM)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                loop()
            torch.cuda.synchronize()
            loop_ms.append(1e3 * (time.perf_counter() - t0) / reps)
    phase(name, f"the greedy loop ({decoder_model.max_seq_len} steps, emitted {tuple(emitted.shape)}) and the "
          f"beam-{G2S_BEAM} loop (emitted {tuple(emits.shape)}) ran under torch.cuda.set_sync_debug_mode('error'): "
          f"no step waits for the card; {groups[0].g_pad} copy groups budgeted; on the device-resident test "
          f"batch the greedy loop takes {loop_ms[0]:.3f} ms and the beam loop {loop_ms[1]:.3f} ms (the encode, "
          f"the host pipeline and the transfers excluded) on {card}")

    eval_forward_phase(module, batches, card, name, reps)
    counter.remove()
    serving = sk.launch_counts()
    if serving != {k: v * forwards[0] for k, v in G2S_PER_FORWARD.items()}:
        raise RuntimeError(f"expected {G2S_PER_FORWARD} launches per {name} forward, got {serving} over "
                           f"{forwards[0]}")
    phase(name, f"launches over the serving path's {forwards[0]} forwards {serving}")

    checkpoint = Path(__file__).resolve().parent / "build" / "chip_smoke" / f"{name}.pkl.gz"
    trainer = ModelTrainer(model, checkpoint, max_num_epochs=1, minibatch_size=padding.max_graphs, device=dev,
                           seed=SEED)
    trainer.load_metadata_and_create_network(samples, parallelize=False)
    hooks = [
        trainer.neural_module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1)),
        trainer.neural_module.decoder.vocab_bias.register_hook(
            lambda grad: backwards.__setitem__(0, backwards[0] + 1)),
    ]
    valid_metrics = []
    trainer.register_validation_epoch_end_hook(lambda m, mod, ep, metrics: valid_metrics.append(metrics))
    before_fw = forwards[0]
    t0 = time.perf_counter()
    trainer.train(samples, valid, initialize_metadata=False, patience=0)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    for hook in hooks:
        hook.remove()
    fw, bw = forwards[0] - before_fw, backwards[0]
    phase(name, f"ModelTrainer.train: 1 epoch over {len(samples)} samples with validation over {len(valid)} "
          f"before and after in {t_train:.2f} s (host tensorize + batching included): {bw} train steps, "
          f"{fw - bw} validation forwards; validation metrics {valid_metrics}")
    if bw == 0 or not checkpoint.exists():
        raise RuntimeError(f"{name}: ModelTrainer.train took no step or wrote no checkpoint")
    expected = {k: serving[k] + G2S_PER_FORWARD[k] * fw + (G2S_PER_TRAIN_STEP[k] - G2S_PER_FORWARD[k]) * bw
                for k in serving}
    expected = add_counts(expected, train_steps_phase(model, batches, dev, card, name, G2S_PER_TRAIN_STEP,
                                                      G2S_TRAIN_STEPS, learning_rate=1e-3, clip_gradient_norm=None))
    counts = sk.launch_counts()  # the graph2seq path ends here
    phase(name, f"launches of K1 (segment_sum), K2 (segment_extremum), K3 (broadcast_to_edges), K4 "
          f"(segment_extremum_argmax) and K5 (typed_matmul) over the {name} path: {counts}; K5's bf16 gate "
          f"{'opened' if counts['typed_matmul'] else 'stayed closed'}")
    if counts != expected:
        raise RuntimeError(f"{name} launches {counts} != {expected} expected")
    if min(counts[k] for k in ("segment_sum", "broadcast_to_edges")) <= 0:
        raise RuntimeError(f"{name}: a kernel of the path was never launched: {counts}")

    step_against_cpu(model, batches[0], minibatches[0], dev, name)
    decode_parity(model, module, test, dev, padding.max_graphs)
    graph2seq_vocabulary_cap(dev, card, minibatches[0])
    graph2seq_stock_sums(dev, card, minibatches[0])
    phase(name, f"phase total {time.perf_counter() - t_phase:.1f} s")
    return counts, batches


def graph2seq_kernel_entries(adj, dev, gen, entry):
    """K1 and K3 on a Graph2Seq batch's layout (8 edge types, 131,072 slots)
    at the path's width 128: bitwise against their plain versions (K1 against
    its plain version on the CPU, as on the VarMisuse layout), then timed
    beside index_add_ / index_select; kernels-line entries through
    ``entry``."""
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    width = 128
    plan = sk.sum_plan_from_adjacency(adj)
    cpu_plan = tree_to(plan, torch.device("cpu"))
    num_nodes = adj.agg_counts.numel()
    e_pad, e_real = adj.mask.shape[0], int(adj.mask.sum())
    data = torch.where(adj.mask[:, None], torch.randn(e_pad, width, device=dev, generator=gen), 0.0)
    got = sk.planned_segment_sum(data, plan, num_nodes)
    if not bitwise_equal(got.cpu(), sk.segment_sum_plain(data.cpu(), cpu_plan, num_nodes)):
        raise RuntimeError("sum kernel != its plain version on the CPU on the Graph2Seq layout")
    sum_err = float((got - sk.segment_sum_plain(data, plan, num_nodes)).abs().max())
    table = torch.randn(num_nodes, width, device=dev, generator=gen)
    if not bitwise_equal(sk.planned_broadcast_to_edges(table, plan), sk.broadcast_plain(table, plan)):
        raise RuntimeError("broadcast kernel != plain version on the Graph2Seq layout")
    torch.cuda.synchronize()
    degrees = torch.bincount(adj.receivers[adj.mask].long(), minlength=num_nodes)
    phase("kernels", f"Graph2Seq layout ({e_real} real slots of {e_pad}, {int(adj.tile_types.max()) + 1} types, "
          f"in-degree max {int(degrees.max())}, mean {float(degrees[degrees > 0].float().mean()):.2f}): the sum at "
          f"{width} bitwise equal to its plain version on the CPU (max abs err against the plain version on the "
          f"card {sum_err:.3e}), the broadcast at {width} bitwise equal to its plain version")

    entries = []
    for name, err in (("segment_sum", sum_err), ("broadcast_to_edges", 0.0)):
        k = layout_kernel(name, adj, width, dev, gen)
        e = entry(name, width, layout_times(k), k)
        e.update(layout="Graph2Seq batch", max_abs_err=err, launches_per_forward=G2S_PER_FORWARD[name],
                 launches_per_train_step=G2S_PER_TRAIN_STEP[name])
        phase("kernels", "Graph2Seq layout " + json.dumps(e))
        entries.append(e)
    return entries


HUB_SLOTS = 4096


def skewed_layout_checks(host_adj, dev, gen, width: int = 64):
    """The extremum, the argmax extremum and the sum at M = D = 64 on a
    skewed layout: one benchmark batch's edges plus HUB_SLOTS more into one
    of its nodes, of random types, laid out by the batcher's own assembler.
    The kernels split the hub row into pieces of ROW_CHUNK slots. The
    extremum must equal its plain version bitwise, the argmax extremum too
    (slots exactly, a tie across the hub's pieces to its first slot); the
    sum its plain version on the CPU bitwise on every other row and within
    1e-5 of the row's sum of |x| on the hub; all the same bits on a second
    run. Each is timed beside scatter_reduce amax (values only, for the
    argmax) or index_add_, on a line of its own."""
    from ptgnn_tpu_torch.graph.batching import _assemble_layout_python, build_adjacency_struct
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.implementations.typilus.train import default_padding
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    pad = default_padding()
    real = host_adj.mask
    rng = np.random.RandomState(SEED)
    num_types = int(host_adj.edge_types.max()) + 1
    hub = int(host_adj.receivers[real][0])
    layout = _assemble_layout_python(
        np.concatenate([host_adj.senders[real], rng.randint(0, pad.max_nodes, HUB_SLOTS)]).astype(np.int32),
        np.concatenate([host_adj.receivers[real], np.full(HUB_SLOTS, hub)]).astype(np.int32),
        np.concatenate([host_adj.edge_types[real], rng.randint(0, num_types, HUB_SLOTS)]).astype(np.int32),
        np.full(int(real.sum()) + HUB_SLOTS, -1, np.int32),
        max_nodes=pad.max_nodes, e_pad=pad.max_edge_slots + 2 * HUB_SLOTS, tile=pad.edge_tile,
        agg_rows=pad.agg_rows, num_types=num_types, align=pad.agg_sum_tile,
    )
    if layout is None:
        raise RuntimeError("the skewed layout does not fit its edge slots")
    adj = tree_to(build_adjacency_struct(layout, tile=pad.edge_tile, align=pad.agg_sum_tile, num_fwd_types=num_types,
                                         introduce_backwards_edges=False), dev)
    ext_plan, sum_plan = sk.plan_from_adjacency(adj), sk.sum_plan_from_adjacency(adj)
    num_nodes = adj.agg_counts.numel()
    e_pad, e_real = adj.mask.shape[0], int(adj.mask.sum())
    rows = sk.plan_rows(sum_plan, num_nodes)
    lengths = torch.bincount(rows, minlength=num_nodes + 1)[:num_nodes]
    short = lengths <= sk.ROW_CHUNK
    if int((~short).sum()) != 1 or bool(short[hub]):
        raise RuntimeError(f"the skewed layout should have one split row, node {hub}")

    def masked(fill):
        data = torch.randn(e_pad, width, device=dev, generator=gen)
        return torch.where(adj.mask[:, None], data, torch.full((), fill, device=dev)).contiguous()

    data = masked(-3.0e38)
    got = sk.planned_segment_extremum(data, ext_plan, num_nodes, True)
    ext_err = float((got - sk.segment_extremum_plain(data, ext_plan, num_nodes, True)).abs().max())
    if not (bitwise_equal(got, sk.segment_extremum_plain(data, ext_plan, num_nodes, True))
            and bitwise_equal(got, sk.planned_segment_extremum(data, ext_plan, num_nodes, True))):
        raise RuntimeError("extremum kernel != plain version (or a second run) on the skewed layout")
    data = masked(-3.0e38)
    data[torch.nonzero(rows == hub)[::7, 0], 1] = 9.0  # a tie across the hub's pieces
    vals, args = sk.planned_segment_extremum_with_argmax(data, ext_plan, num_nodes, True)
    plain_vals, plain_args = sk.segment_extremum_argmax_plain(data, ext_plan, num_nodes, True)
    again_vals, again_args = sk.planned_segment_extremum_with_argmax(data, ext_plan, num_nodes, True)
    argmax_err = float((vals - plain_vals).abs().max())
    if not (bitwise_equal(vals, plain_vals) and torch.equal(args, plain_args)
            and bitwise_equal(vals, again_vals) and torch.equal(args, again_args)):
        raise RuntimeError("argmax extremum kernel != plain version (or a second run) on the skewed layout")
    if int(args[hub, 1]) != int(torch.nonzero((rows == hub) & adj.mask)[0, 0]):
        raise RuntimeError("argmax extremum kernel did not keep the first slot of the hub's tie")
    data = masked(0.0)
    got = sk.planned_segment_sum(data, sum_plan, num_nodes)
    cpu_plan = tree_to(sum_plan, torch.device("cpu"))
    cpu = sk.segment_sum_plain(data.cpu(), cpu_plan, num_nodes)
    err = (got.cpu() - cpu).abs()
    if not (bitwise_equal(got.cpu()[short.cpu()], cpu[short.cpu()])
            and bool((err <= 1e-5 * sk.segment_sum_plain(data.abs().cpu(), cpu_plan, num_nodes)).all())
            and bitwise_equal(got, sk.planned_segment_sum(data, sum_plan, num_nodes))):
        raise RuntimeError("sum kernel off its plain version on the CPU (or a second run) on the skewed layout")
    phase("kernels", f"skewed layout ({e_real} real slots, node {hub} with {int(lengths[hub])} slots in "
          f"{len(torch.unique(torch.nonzero(rows == hub)[:, 0] // adj.edge_tile))} tiles): extremum bitwise equal "
          f"to its plain version, argmax extremum too (values bitwise, slots exactly; a tie over "
          f"every seventh hub slot went to its first slot), sum bitwise equal "
          f"to the CPU's on every other row and within 1e-5 x sum|x| on the hub (its error "
          f"{float(err[hub].max()):.3e}), all the same bits on a second run")

    for name, err_abs in (("segment_extremum", ext_err), ("segment_extremum_argmax", argmax_err),
                          ("segment_sum", float(err.max()))):
        k = layout_kernel(name, adj, width, dev, gen)
        entry = {"name": name, "layout": f"bench batch + one hub row of {int(lengths[hub])} slots",
                 **layout_times(k), **bound(k.nbytes, k.ops), "max_abs_err": err_abs, "width": width,
                 "dtype": "float32"}
        phase("kernels", "skewed layout " + json.dumps(entry))


def argmax_kernel_checks(adj, dev, gen):
    """The argmax extremum kernel against its plain version on the benchmark
    layout at M 64 and 128, float32 and bf16, max and min, with planted ties:
    values bitwise apart from the sign of zero, slots exactly, and the same
    bits on a second run. Returns the largest absolute value difference."""
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    plan = sk.plan_from_adjacency(adj)
    num_nodes = adj.agg_counts.numel()
    rows = sk.plan_rows(plan, num_nodes)
    real = torch.nonzero(adj.mask)[:, 0]
    busiest = int(torch.bincount(rows[real], minlength=num_nodes + 1)[:num_nodes].argmax())
    worst, done, ties = 0.0, [], 0
    for width in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            for is_max in (True, False):
                data = torch.round(torch.randn(adj.mask.shape[0], width, device=dev, generator=gen) * 2) / 2
                data[rows == busiest, 0] = 5.0 if is_max else -5.0  # one value on all its slots
                data[real[0], 1], data[real[1:], 1] = -0.0, 0.0  # every row ties at zero
                fill = torch.finfo(dtype).max if dtype == torch.bfloat16 else 3.0e38
                data = torch.where(adj.mask[:, None], data.to(dtype),
                                   torch.full((), -fill if is_max else fill, dtype=dtype, device=dev)).contiguous()
                vals, args = sk.planned_segment_extremum_with_argmax(data, plan, num_nodes, is_max)
                again_vals, again_args = sk.planned_segment_extremum_with_argmax(data, plan, num_nodes, is_max)
                plain_vals, plain_args = sk.segment_extremum_argmax_plain(data, plan, num_nodes, is_max)
                if not (bitwise_equal(vals + 0.0, plain_vals + 0.0) and torch.equal(args, plain_args)):
                    raise RuntimeError(f"argmax extremum kernel != plain version at {width}/{dtype}/max={is_max}")
                if not (bitwise_equal(vals, again_vals) and torch.equal(args, again_args)):
                    raise RuntimeError(f"argmax extremum kernel gave other bits on a second run at {width}/{dtype}")
                first = int(torch.nonzero((rows == busiest) & adj.mask)[0, 0])
                if int(args[busiest, 0]) != first:
                    raise RuntimeError("argmax extremum kernel did not keep the first of a tie across tiles")
                worst = max(worst, float((vals - plain_vals).abs().max()))
                ties += int(((data.float() == vals.index_select(0, torch.where(rows < num_nodes, rows, 0))) &
                             adj.mask[:, None]).sum() - (args >= 0).sum())
                done.append(f"{width}/{str(dtype)[6:]}/{'max' if is_max else 'min'}")
    torch.cuda.synchronize()
    phase("kernels", f"argmax extremum kernel == plain version (values bitwise apart from the sign of zero, "
          f"slots exactly, the same bits on a second run) at {done}; {ties} tied losers in all, node {busiest}'s "
          f"tie over {int(((rows == busiest) & adj.mask).sum())} slots in "
          f"{len(torch.unique(torch.nonzero((rows == busiest) & adj.mask)[:, 0] // adj.edge_tile))} tiles went "
          f"to its first slot")
    return worst


def argmax_kernel_entry(adj, dev, gen, max_abs_err, launches, launches_by_path):
    """kernels-line entries of the argmax extremum at M = 64 and 128 (the
    path's widths), float32; returns the M = 64 one. Library call:
    scatter_reduce amax into zeros, the values alone (no PyTorch call gives
    first-occurrence slots too): a partial stand-in."""
    entries = []
    for width in (64, 128):
        k = layout_kernel("segment_extremum_argmax", adj, width, dev, gen)
        entry = {
            "name": "segment_extremum_argmax", "route": "cuda",
            "source": KERNEL_FILES["segment_extremum_argmax"][0],
            "replaces": KERNEL_FILES["segment_extremum_argmax"][1],
            "launches": launches, "launches_by_path": launches_by_path,
            "launches_per_train_step": ARGMAX_PER_TRAIN_STEP["segment_extremum_argmax"],
            "max_abs_err": max_abs_err, **layout_times(k), **bound(k.nbytes, k.ops),
            "library_call": "scatter_reduce amax, values only (partial stand-in)",
            "width": width, "dtype": "float32",
        }
        phase("kernels", json.dumps(entry))
        entries.append(entry)
    return entries[0]


def jax_layout_params(module):
    """The module's weights as the JAX package's params pytree of numpy
    arrays (``{"gnn": {"node_embedder": ..., "mp_layers": [...]}, <head>:
    ...}``, one ``mp_layers`` entry per unique layer object, ``{}`` for
    PNA's aggregation, the edge embedder under ``gnn.edge_embedder``): what
    ``convert.load_jax_params`` loads."""
    index = module.gnn._layer_param_index
    layers = [{} for _ in range(max(index) + 1)]
    tree = {"gnn": {"node_embedder": {}, "mp_layers": layers}}
    for position, layer in enumerate(module.gnn.message_passing_layers):
        if hasattr(layer, "aggregation"):
            layers[index[position]]["aggregation"] = {}
    for key, value in module.state_dict().items():
        parts = key.split(".")
        if parts[:2] == ["gnn", "node_embedder"]:
            node, rest = tree["gnn"]["node_embedder"], parts[2:]
        elif parts[:2] == ["gnn", "edge_feature_embedder"]:
            node, rest = tree["gnn"].setdefault("edge_embedder", {}), parts[2:]
        elif parts[:2] == ["gnn", "message_passing_layers"]:
            node, rest = layers[index[int(parts[2])]], parts[3:]
        else:
            node, rest = tree.setdefault(parts[0], {}), parts[1:]
        for part in rest[:-1]:
            node = node.setdefault(part, {})
        node[rest[-1]] = value.detach().cpu().numpy()
    return tree


def cpu_arithmetic() -> str:
    """The CPU reference's arithmetic: ATen's vector capability, AMX, the
    float32 matmul precision, oneDNN and the thread count."""
    amx = getattr(torch.cpu, "_is_amx_tile_supported", lambda: "unknown")()
    return (f"CPU capability {torch.backends.cpu.get_cpu_capability()}, AMX {amx}, float32 matmul precision "
            f"{torch.get_float32_matmul_precision()}, oneDNN {'on' if torch.backends.mkldnn.is_available() and torch.backends.mkldnn.enabled else 'off'}, "
            f"{torch.get_num_threads()} threads")


@contextlib.contextmanager
def cpu_reference():
    """The CPU reference's float32 route: the highest matmul precision and
    oneDNN off (with it on, GELU runs oneDNN's own kernel, whose rounding
    follows the host's instruction set), whatever the host offers."""
    precision, onednn = torch.get_float32_matmul_precision(), torch.backends.mkldnn.enabled
    torch.set_float32_matmul_precision("highest")
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.mkldnn.enabled = onednn


def layers_against_cpu(model, host_minibatch, device_batch, device_minibatch, dev, name="layers"):
    """The 'layers' stack on the card against the CPU on weights converted
    through ``convert.py`` (dropout 0): the logits (rtol 1e-4, atol 1e-4 x
    max|logit|) with the error after the embedder and each stack entry, a
    second forward on each side, then a train step: the loss (rtol 1e-5)
    and every gradient within 1e-4 x its max |g| on the card's routing
    decisions, relu's active sets among them. The CPU side runs under
    ``cpu_reference()``. Returns the logits of both sides and the largest
    errors."""
    from ptgnn_tpu_torch.convert import load_jax_params
    from ptgnn_tpu_torch.core.trainer import module_loss
    from ptgnn_tpu_torch.graph.structs import tree_to

    tree = jax_layout_params(model.build_neural_module(device="cpu", seed=SEED + 1))
    sides = {}
    for side in ("gpu", "cpu", "own"):
        m = model.build_neural_module(device=dev if side == "gpu" else torch.device("cpu"), seed=SEED)
        load_jax_params(m, tree)
        set_dropout(m, 0.0)
        sides[side] = m
    host = tree_to(host_minibatch, torch.device("cpu"))
    outs = {"gpu": [], "cpu": []}
    hooks = [entry.register_forward_hook(lambda mod, args, out, side=side: outs[side].append(out.float().cpu()))
             for side in outs for entry in [sides[side].gnn.node_embedder, *sides[side].gnn.message_passing_layers]]
    with torch.inference_mode():
        gpu_logits = sides["gpu"]._logits(device_batch, train=False)[0].cpu()
        with cpu_reference():
            cpu_logits = sides["cpu"]._logits(host["batch"], train=False)[0]
    for hook in hooks:
        hook.remove()
    with torch.inference_mode():
        gpu_again = sides["gpu"]._logits(device_batch, train=False)[0].cpu()
        with cpu_reference():
            cpu_again = sides["cpu"]._logits(host["batch"], train=False)[0]
            arithmetic = cpu_arithmetic()
    layer_err = [f"{float((g - c).abs().max()):.2e}/{float(c.abs().max()):.2e}" for g, c in zip(outs["gpu"], outs["cpu"])]
    # rtol 1e-4 and 1e-4 of the logit scale, as the parity phase holds the
    # 'mlp' stack: GraphNorm's sums add in atomic order on the card, which
    # moves the logits by up to half of 1e-5 x max|logit| from run to run.
    atol = 1e-4 * float(cpu_logits.abs().max())
    logit_err = float((gpu_logits - cpu_logits).abs().max())
    phase(name, f"card vs CPU ({arithmetic}) max abs err / max |x| after the embedder and each stack entry: "
          f"{layer_err}; logits {logit_err:.3e} ({int(((gpu_logits - cpu_logits).abs() > 1e-5).sum())} of "
          f"{gpu_logits.numel()} past 1e-5); a second forward: card vs card "
          f"{float((gpu_again - gpu_logits).abs().max()):.3e}, CPU vs CPU {float((cpu_again - cpu_logits).abs().max()):.3e}")
    torch.testing.assert_close(gpu_logits, cpu_logits, rtol=1e-4, atol=atol)

    def step(side, mb, tape, replay=False):
        device = dev if side == "gpu" else torch.device("cpu")
        with routing_tape(tape, replay, relu=True), (cpu_reference() if side != "gpu" else contextlib.nullcontext()):
            loss, _ = module_loss(sides[side], mb, train=True, generator=torch.Generator(device=device))
            loss.backward()
        return float(loss.detach())

    card_tape, own_tape = [], []
    gpu_loss = step("gpu", device_minibatch, card_tape)
    cpu_loss = step("cpu", host, card_tape, replay=True)
    own_loss = step("own", host, own_tape)
    np.testing.assert_allclose(gpu_loss, cpu_loss, rtol=1e-5)
    np.testing.assert_allclose(gpu_loss, own_loss, rtol=1e-5)
    worst, reached, failed = 0.0, 0, []
    for (pname, pg), pc in zip(sides["gpu"].named_parameters(), sides["cpu"].parameters()):
        if pc.grad is None:
            if pg.grad is not None and bool(pg.grad.any()):
                raise RuntimeError(f"{name}: {pname} has a gradient on the card alone")
            continue
        got, want = pg.grad.cpu(), pc.grad
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max())
        if not (bool(torch.isfinite(got).all()) and err <= 1e-4 * scale):
            failed.append(f"{pname}: {err / scale:.2e} of max |g|")
        worst = max(worst, err / scale)
        reached += 1
    if failed:
        raise RuntimeError(f"{name}: gradients beyond 1e-4 x their max |g| on the card's routing decisions: {failed}")
    phase(name, f"card vs CPU on converted weights (dropout 0): logits max abs err {logit_err:.3e} (rtol 1e-4, "
          f"atol {atol:.3e} = 1e-4 x max|logit|); train step loss {gpu_loss:.7f} vs {cpu_loss:.7f} (rtol 1e-5); "
          f"on the card's routing decisions all {reached} gradients within 1e-4 x their max |g| (worst "
          f"{worst:.3e}); on its own the CPU's loss is {own_loss:.7f} and it takes "
          f"{routing_differences(card_tape, own_tape)} routing decisions differently per call")
    return {"gpu_logits": gpu_logits, "cpu_logits": cpu_logits, "logit_err": logit_err, "atol": atol,
            "worst_gradient": worst, "cpu_module": sides["cpu"], "host_batch": host["batch"]}


def layers_gate_repeats(runs: int) -> None:
    """``chip_smoke.py --layers-gate RUNS``: the 'layers' card-against-CPU
    gate (``layers_against_cpu``) RUNS times in one process on the
    benchmark batches, each run's logits also held against the first run's
    on the same side (the card's move by GraphNorm's atomic sums, the CPU's
    should not move) and against the CPU's logits on its default route
    (oneDNN on, outside ``cpu_reference``), then a summary line. Exits 1 if
    a run failed."""
    from ptgnn_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    phase("build", f"{cuda_build.build_all():.2f} s")
    model, _, minibatches, batches = build_bench(dev, architecture="layers")
    first, errors, failures = None, [], []
    for run in range(runs):
        try:
            got = layers_against_cpu(model, minibatches[0], batches[0][0], g2c_minibatch(batches[0]), dev,
                                     name=f"layers-gate {run + 1}/{runs}")
        except (AssertionError, RuntimeError) as failure:
            failures.append(run + 1)
            phase(f"layers-gate {run + 1}/{runs}", f"FAILED: {failure}")
            continue
        first = first or got
        errors.append(got["logit_err"])
        with torch.inference_mode():
            default = got["cpu_module"]._logits(got["host_batch"], train=False)[0]
        phase(f"layers-gate {run + 1}/{runs}", f"against the first run: card "
              f"{float((got['gpu_logits'] - first['gpu_logits']).abs().max()):.3e}, CPU "
              f"{float((got['cpu_logits'] - first['cpu_logits']).abs().max()):.3e}; the CPU's default route "
              f"({cpu_arithmetic()}) against the pinned one {float((default - got['cpu_logits']).abs().max()):.3e}, "
              f"against the card {float((default - got['gpu_logits']).abs().max()):.3e}")
    phase("layers-gate", f"{runs} runs on {card}: {len(failures)} failed {failures}; logits card vs CPU "
          f"{['%.3e' % e for e in errors]} (limit {first['atol'] if first else float('nan'):.3e})")
    if failures:
        sys.exit(1)


def layers_phase(dev, card, reps: int = 3):
    """The 'layers' stack (PNA, GraphNorm, EGC, block self-attention, an
    MLP-MP layer with a hidden layer, reference self-attention, the
    benchmark's MLP-MP layer) at hidden 64 on the benchmark batches: eval
    forwards in float32 and bf16 AMP, train_steps in both, train steps with
    edge dropout (no fused-op call, finite gradients, an eval forward that
    the rate leaves alone), then the logits and a train step (dropout 0) on
    converted weights on the card against the CPU. Returns the launch counts
    of the path, its device batches and the inputs that the PNA and EGC
    layers saw in a float32 eval forward of the first batch."""
    from ptgnn_tpu_torch.core.trainer import module_loss
    from ptgnn_tpu_torch.implementations.typilus.harness import train_steps
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    name = "layers"
    t_phase = time.perf_counter()
    model, module, minibatches, batches = build_bench(dev, architecture="layers")
    mbs = [g2c_minibatch(b) for b in batches]
    layers = module.gnn.message_passing_layers
    torch.cuda.synchronize()
    phase(name, f"setup {time.perf_counter() - t_phase:.2f} s; stack {[type(layer).__name__ for layer in layers]}; "
          f"{sum(p.numel() for p in module.parameters())} parameters; typed weights "
          f"{[tuple(p.shape) for n, p in module.named_parameters() if 'weights_' in n or n.endswith('bases')]}; "
          f"att_order {tuple(batches[0][0].att_order.shape)}")

    fused = []
    with counting_fused_calls(fused):
        module.eval()
        forwards = [0]
        counter = module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
        sk.reset_launch_counts()  # the layers path starts here
        for amp in (False, True):
            eval_forward_phase(module, mbs, card, name, reps, amp=amp)
        counter.remove()
        serving = sk.launch_counts()
        phase(name, f"launches over {forwards[0]} eval forwards {serving}; fused-op calls {len(fused)}")
        if serving != {k: v * forwards[0] for k, v in LAYERS_PER_FORWARD.items()}:
            raise RuntimeError(f"expected {LAYERS_PER_FORWARD} launches per layers forward, got {serving}")
        if len(fused) != LAYERS_FUSED_PER_FORWARD * forwards[0]:
            raise RuntimeError(f"{len(fused)} fused-op calls in {forwards[0]} forwards")
        train_counts = train_steps_phase(model, mbs, dev, card, name, LAYERS_PER_TRAIN_STEP,
                                         steps=LAYERS_TRAIN_STEPS)

        # Edge dropout: every layer leaves the fused route.
        drop = model.build_neural_module(device=dev, seed=SEED)
        drop.gnn.edge_dropout_rate = LAYERS_EDGE_DROPOUT
        fused.clear()
        before = sk.launch_counts()
        stats = train_steps(drop, mbs, steps=LAYERS_EDGE_DROPOUT_STEPS, seed=SEED)
        loss, _ = module_loss(drop, mbs[0], train=True, generator=torch.Generator(device=dev).manual_seed(SEED))
        loss.backward()
        steps = LAYERS_EDGE_DROPOUT_STEPS + 2
        per_step = {k: v / steps for k, v in delta(sk.launch_counts(), before).items()}
        grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in drop.parameters() if p.grad is not None)
        if per_step != LAYERS_PER_EDGE_DROPOUT_STEP or fused:
            raise RuntimeError(f"edge dropout step: launches {per_step} (expected {LAYERS_PER_EDGE_DROPOUT_STEP}), "
                               f"{len(fused)} fused-op calls")
        if not (math.isfinite(stats["loss"]) and math.isfinite(float(loss.detach())) and grads_finite):
            raise RuntimeError(f"edge dropout step: loss {stats['loss']} / {float(loss)}, finite grads {grads_finite}")
        counts = sk.launch_counts()  # the layers path ends here
        phase(name, f"train_steps float32 with edge dropout {LAYERS_EDGE_DROPOUT}: {LAYERS_EDGE_DROPOUT_STEPS} steps "
              f"after 1 warm-up, loss {stats['loss']:.6f}, {stats['ms_per_step']:.3f} ms/step, "
              f"{stats['graphs_per_s']:.1f} graphs/s, {stats['edges_per_s']:.0f} edges/s on {card}; launches per "
              f"step {per_step}; 0 fused-op calls; one more step: loss {float(loss.detach()):.6f}, all gradients finite")
        expected = add_counts(add_counts(serving, train_counts),
                              {k: v * steps for k, v in LAYERS_PER_EDGE_DROPOUT_STEP.items()})
        phase(name, f"launches over the layers path: {counts}")
        if counts != expected:
            raise RuntimeError(f"layers launches {counts} != {expected} expected")

        # The rate leaves an eval forward alone: the fused route, the same logits.
        drop.eval()
        fused.clear()
        with torch.inference_mode():
            with_rate = drop._logits(batches[0][0], train=False)[0]
            drop.gnn.edge_dropout_rate = 0.0
            without = drop._logits(batches[0][0], train=False)[0]
        err = float((with_rate - without).abs().max())
        if len(fused) != 2 * LAYERS_FUSED_PER_FORWARD or err > 1e-5 * float(without.abs().max()):
            raise RuntimeError(f"edge dropout changed an eval forward: {len(fused)} fused calls, max abs err {err}")
        phase(name, f"an eval forward with edge dropout {LAYERS_EDGE_DROPOUT} takes the fused route "
              f"({LAYERS_FUSED_PER_FORWARD} calls) and gives the logits of rate 0 (max abs err {err:.3e}; "
              f"GraphNorm's index_add_ adds in atomic order)")

    # The inputs of PNA's and EGC's layers in a float32 eval forward, for the
    # kernels against their plain versions.
    seen = {}
    hooks = [layers[i].register_forward_pre_hook(lambda mod, args, i=i: seen.__setitem__(i, args[0].detach()))
             for i in (0, 2)]
    hooks.append(layers[0].aggregation.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("pna", args[0].detach())))
    with torch.inference_mode():
        module._logits(batches[0][0], train=False)
    for hook in hooks:
        hook.remove()
    seen["bases"] = layers[2].bases.detach()

    layers_against_cpu(model, minibatches[0], batches[0][0], mbs[0], dev)
    phase(name, f"phase total {time.perf_counter() - t_phase:.1f} s")
    return counts, batches, seen


def layers_kernel_entries(adj, seen, dev, gen, entry):
    """The kernels at the layers path's new shapes against their plain
    versions, then timed beside a library call (kernels-line entries through
    ``entry``): K1 (the sum) and K2 (the extremum) on PNA's messages at width
    64, K3 (the broadcast) of PNA's input states at 64, K2 at width 256 on
    EGC's fused messages, and K1 at width 1 on an edge-dropout mask (the
    live-slot count)."""
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.ops.typed_linear import typed_tile_matmul

    num_nodes = adj.agg_counts.numel()
    sum_plan = sk.sum_plan_from_adjacency(adj)
    cpu_sum_plan = tree_to(sum_plan, torch.device("cpu"))
    neutral = torch.full((), -3.0e38, device=dev)
    with torch.no_grad():
        egc_messages = typed_tile_matmul(seen[2].index_select(0, adj.senders.clamp(max=num_nodes - 1).long()),
                                         seen["bases"], adj.tile_types, adj.edge_tile)
    keep = torch.rand(adj.mask.shape, device=dev, generator=gen) >= LAYERS_EDGE_DROPOUT
    cases = {
        "sum 64 (PNA messages)": ("segment_sum", torch.where(adj.mask[:, None], seen["pna"].float(), 0.0)),
        "sum 1 (live slots under edge dropout)": ("segment_sum", (adj.mask & keep)[:, None].float()),
        "extremum 64 (PNA messages)": ("segment_extremum", torch.where(adj.mask[:, None], seen["pna"].float(),
                                                                       neutral)),
        "extremum 256 (EGC's fused messages)": ("segment_extremum", torch.where(adj.mask[:, None], egc_messages,
                                                                                neutral)),
        "broadcast 64 (PNA's input states)": ("broadcast_to_edges", seen[0].float()),
    }
    entries = []
    for case, (kname, data) in cases.items():
        data = data.contiguous()
        width = data.shape[1]
        k = layout_kernel(kname, adj, width, dev, gen)
        got = k.kernel(data)
        if kname == "segment_sum":
            if not bitwise_equal(got.cpu(), sk.segment_sum_plain(data.cpu(), cpu_sum_plan, num_nodes)):
                raise RuntimeError(f"sum kernel != its plain version on the CPU at {case}")
            err = float((got - k.plain(data)).abs().max())
            if err > 1e-5 * float(sk.segment_sum_plain(data.abs(), sum_plan, num_nodes).max()):
                raise RuntimeError(f"sum kernel off its plain version on the card at {case}")
        else:
            if not bitwise_equal(got, k.plain(data)):
                raise RuntimeError(f"{kname} kernel != its plain version at {case}")
            err = 0.0
        e = entry(kname, width, layout_times(k, lambda d=data: d.clone()), k)
        e.update(layout="Graph2Class batch, layers stack", case=case, max_abs_err=err,
                 launches_per_forward=LAYERS_PER_FORWARD[kname],
                 launches_per_train_step=LAYERS_PER_TRAIN_STEP[kname],
                 launches_per_edge_dropout_step=LAYERS_PER_EDGE_DROPOUT_STEP[kname])
        phase("kernels", "layers path " + json.dumps(e))
        entries.append(e)
    torch.cuda.synchronize()
    phase("kernels", f"layers path: {list(cases)} equal to their plain versions (the sums bitwise to their plain "
          f"versions on the CPU, the extrema and the broadcast bitwise on the card)")
    return entries


SANITIZER_TOOLS = ("memcheck", "racecheck", "synccheck")


def sanitizer_target() -> None:
    """What compute-sanitizer runs (``chip_smoke.py --sanitizer-target``):
    every kernel once at a small size, on a layout with a row that the row
    reductions split into pieces, then a synchronise."""
    from ptgnn_tpu_torch.graph.batching import _assemble_layout_python
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.ops import typed_linear as ttl

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    recv = np.concatenate([rng.randint(0, 200, 900), np.full(300, 7)]).astype(np.int32)
    layout = _assemble_layout_python(
        rng.randint(0, 200, len(recv)).astype(np.int32), recv, rng.randint(0, 3, len(recv)).astype(np.int32),
        np.full(len(recv), -1, np.int32), max_nodes=256, e_pad=4096, tile=32, agg_rows=64, num_types=3, align=128,
    )
    plan = sk.with_row_index(sk.AggregationPlan(*(torch.from_numpy(layout[i]).to(dev) for i in (3, 6, 7))))
    g = torch.Generator(device=dev).manual_seed(SEED)
    data = torch.randn(4096, 64, device=dev, generator=g)
    sk.planned_segment_sum(data, plan, 256)
    sk.planned_segment_extremum(data, plan, 256, True)
    sk.planned_segment_extremum_with_argmax(data, plan, 256, True)
    sk.planned_broadcast_to_edges(torch.randn(256, 64, device=dev, generator=g), plan)
    tile_types = torch.randint(0, 3, (4096 // 32,), device=dev, generator=g, dtype=torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        ttl.typed_matmul_kernel(torch.randn(4096, 128, device=dev, generator=g).to(dtype),
                                torch.randn(3, 128, 256, device=dev, generator=g).to(dtype), tile_types, 32)
    torch.cuda.synchronize()
    print("sanitizer target: every kernel launched", flush=True)


def sanitizer_phase() -> None:
    """Each kernel once under compute-sanitizer's memcheck, racecheck and
    synccheck, where the tool is installed and can attach to the card; a
    line saying why not otherwise. Fails on any error the tool reports."""
    tool = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if not Path(tool).exists():
        phase("sanitizer", "compute-sanitizer is not installed here: no kernel was checked by it")
        return
    summaries = []
    for name in SANITIZER_TOOLS:
        proc = subprocess.run(
            [tool, "--tool", name, "--error-exitcode", "97", sys.executable, str(Path(__file__).resolve()),
             "--sanitizer-target"], capture_output=True, text=True, timeout=300,
        )
        out = proc.stdout + proc.stderr
        if "Device not supported" in out:
            phase("sanitizer", f"{tool} is installed but cannot attach to this card here (it reports "
                  f"'Device not supported'): no kernel was checked by it")
            return
        summary = [line.strip("= ") for line in out.splitlines() if "SUMMARY" in line]
        if proc.returncode != 0 or "every kernel launched" not in out:
            raise RuntimeError(f"compute-sanitizer {name} exit {proc.returncode}: {out[-2000:]}")
        summaries.append(f"{name}: {summary[-1] if summary else 'no summary'}")
    phase("sanitizer", f"every kernel once under compute-sanitizer ({tool}): {summaries}")



@contextlib.contextmanager
def counting_fused_calls(calls: list):
    """Appends to ``calls`` once per call of the fused message op while the
    block runs."""
    from ptgnn_tpu_torch.graph.messagepassing import base as mp_base

    real = mp_base.fused_typed_message_aggregation

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    mp_base.fused_typed_message_aggregation = counted
    try:
        yield
    finally:
        mp_base.fused_typed_message_aggregation = real


def edge_features_against_cpu(model, host_minibatch, device_minibatch, dev, name="edge-features"):
    """The edge-feature stack on converted weights (``convert.py``, dropout
    0), card against CPU (``cpu_reference()``): the real nodes' output
    states (rtol 1e-4, atol 1e-4 x max|x|) and one float32 train step (the
    loss to rtol 1e-5, every gradient, the edge embedder's included, to rtol
    1e-4 and 1e-4 of its largest magnitude): the PPI phase's limits."""
    from ptgnn_tpu_torch.convert import load_jax_params
    from ptgnn_tpu_torch.core.trainer import module_loss
    from ptgnn_tpu_torch.graph.structs import tree_to

    tree = jax_layout_params(model.build_neural_module(device="cpu", seed=SEED + 1))
    if "edge_embedder" not in tree["gnn"]:
        raise RuntimeError("the converted tree holds no edge embedder")
    sides = {}
    for side, device in (("gpu", dev), ("cpu", torch.device("cpu"))):
        sides[side] = load_jax_params(model.build_neural_module(device=device, seed=SEED), tree)
        set_dropout(sides[side], 0.0)
    host = tree_to(host_minibatch, torch.device("cpu"))
    mask = host["batch"].node_mask
    with torch.inference_mode():
        g_out = sides["gpu"].gnn(device_minibatch["batch"])[0].output_node_representations.cpu()[mask]
        with cpu_reference():
            c_out = sides["cpu"].gnn(host["batch"])[0].output_node_representations[mask]
            arithmetic = cpu_arithmetic()
    atol = 1e-4 * float(c_out.abs().max())
    out_err = float((g_out - c_out).abs().max())
    torch.testing.assert_close(g_out, c_out, rtol=1e-4, atol=atol)
    losses = {}
    for side in ("gpu", "cpu"):
        device = dev if side == "gpu" else torch.device("cpu")
        with cpu_reference() if side == "cpu" else contextlib.nullcontext():
            loss, _ = module_loss(sides[side], device_minibatch if side == "gpu" else host, train=True,
                                  generator=torch.Generator(device=device))
            loss.backward()
        losses[side] = float(loss.detach())
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-5)
    worst, names = (0.0, ""), []
    for (pname, pg), pc in zip(sides["gpu"].named_parameters(), sides["cpu"].parameters()):
        got, want = pg.grad.cpu(), pc.grad
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4 * float(want.abs().max()),
                                   err_msg=pname)
        worst = max(worst, (float((got - want).abs().max() / want.abs().max().clamp_min(1e-30)), pname))
        names.append(pname)
    if not any(n.startswith("gnn.edge_feature_embedder.") for n in names):
        raise RuntimeError("the edge embedder got no gradient")
    phase(name, f"card vs CPU ({arithmetic}) on converted weights (dropout 0): output states max abs err "
          f"{out_err:.3e} (rtol 1e-4, atol {atol:.3e} = 1e-4 x max|x|); float32 train step loss {losses['gpu']:.4f} "
          f"vs {losses['cpu']:.4f} (rtol 1e-5), all {len(names)} gradients (the edge embedder's among them) within "
          f"rtol 1e-4, atol 1e-4 x max|g| (worst {worst[0]:.3e} of max, {worst[1]})")


def edge_features_phase(dev, card, reps: int = 3):
    """The generic engine with edge features at PPI's width and layout: the
    5-layer MLP-MP stack reading 128 embedded feature columns, and the
    variant with a gated layer. For each: eval forwards in float32 and bf16
    AMP and train_steps in both, with the launches of every forward and step
    checked and no fused-op call; for the MLP-MP stack, the output states
    and a float32 step card against CPU on converted weights. Returns the
    launch counts of the path and the first batch's adjacency."""
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.implementations.ppi.harness import (
        PPI_GRAPH_SIZES,
        build_edge_feature_gnn,
        synthetic_edge_feature_graphs,
    )
    from ptgnn_tpu_torch.implementations.ppi.train import ppi_padding
    from ptgnn_tpu_torch.implementations.typilus.harness import train_steps
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    name = "edge-features"
    t_phase = time.perf_counter()
    graphs = synthetic_edge_feature_graphs(PPI_GRAPHS, SEED, **PPI_GRAPH_SIZES)
    fused, checks = [], []
    sk.reset_launch_counts()  # the edge-features path starts here
    with counting_fused_calls(fused):
        for gated in (False, True):
            stack = "gated" if gated else "mlp"
            t0 = time.perf_counter()
            model, module, minibatches = build_edge_feature_gnn(padding=ppi_padding(), graphs=graphs, gated=gated,
                                                                seed=SEED, device=dev)
            t_host = time.perf_counter() - t0
            mbs = [tree_to(mb, dev) for mb in minibatches]
            torch.cuda.synchronize()
            batch = minibatches[0]["batch"]
            slot = batch.adjacency.edge_feature_slot
            phase(name, f"{stack} stack: host metadata + tensorize + batching of {len(graphs)} graphs {t_host:.2f} s; "
                  f"{len(mbs)} batches of (graphs, nodes, edges) "
                  f"{[(int(m['batch'].num_graphs), int(m['batch'].num_nodes), int(m['batch'].num_edges)) for m in minibatches]}; "
                  f"first batch {int((slot >= 0).sum())} of {slot.shape[0]} slots read a feature row "
                  f"({int(slot.max()) + 1} rows of {batch.edge_feature_data['features'].shape[1]} floats); layers "
                  f"{[type(l).__name__ for l in module.gnn.message_passing_layers]}; typed weights "
                  f"{[tuple(p.shape) for n, p in module.named_parameters() if 'weights' in n]}")
            module.eval()
            forwards = [0]
            counter = module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
            for amp in (False, True):
                dtype = "bf16" if amp else "float32"
                before, n0 = sk.launch_counts(), forwards[0]
                eval_forward_phase(module, mbs, card, f"{name} {stack}", reps, amp=amp)
                got = delta(sk.launch_counts(), before)
                want = {k: v * (forwards[0] - n0) for k, v in EDGE_PER_FORWARD[dtype].items()}
                if got != want:
                    raise RuntimeError(f"{stack} {dtype} eval forwards launched {got}, expected {want}")
                checks.append(f"{stack} {dtype} forward")
            counter.remove()
            for amp in (False, True):
                dtype = "bf16" if amp else "float32"
                steps_module = model.build_neural_module(device=dev, seed=SEED)
                before = sk.launch_counts()
                stats = train_steps(steps_module, mbs, steps=EDGE_TRAIN_STEPS, enable_amp=amp, seed=SEED)
                per_step = {k: v / (EDGE_TRAIN_STEPS + 1) for k, v in delta(sk.launch_counts(), before).items()}
                if per_step != EDGE_PER_TRAIN_STEP[dtype]:
                    raise RuntimeError(f"{stack} {dtype} step launched {per_step}, expected {EDGE_PER_TRAIN_STEP[dtype]}")
                if not math.isfinite(stats["loss"]):
                    raise RuntimeError(f"{stack} {dtype} train_steps gave a non-finite loss {stats['loss']}")
                phase(name, f"{stack} stack train_steps {'bf16 AMP' if amp else 'float32'}: {EDGE_TRAIN_STEPS} steps "
                      f"after 1 warm-up, loss {stats['loss']:.4f}, {stats['ms_per_step']:.3f} ms/step, "
                      f"{stats['nodes_per_s']:.0f} nodes/s, {stats['edges_per_s']:.0f} edges/s on {card}; launches "
                      f"per step {per_step}")
                checks.append(f"{stack} {dtype} step")
            if not gated:
                first = (model, minibatches[0], mbs[0])
    counts = sk.launch_counts()  # the edge-features path ends here
    phase(name, f"launches over the edge-features path {counts}, each forward and step as counted "
          f"({checks}); fused-op calls {len(fused)}")
    if fused:
        raise RuntimeError(f"{len(fused)} fused-op calls on the edge-feature path")
    edge_features_against_cpu(*first, dev)
    phase(name, f"phase total {time.perf_counter() - t_phase:.1f} s")
    return counts, first[2]["batch"].adjacency


def bpe_phase(dev, card, reps: int = 3):
    """Graph2Class at the benchmark configuration with the ``bpe`` splitting
    (a 64-entry vocabulary) and ``max`` pooling of the pieces: the eval
    forward over device-resident batches (per forward 8 extremum and 8
    broadcast launches), then the logits card against CPU under the parity
    phase's limits. Returns the launch counts of the path."""
    from ptgnn_tpu_torch.implementations.typilus.train import MlpStackCreator, default_padding, graph2class_model
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    name = "bpe"
    t0 = time.perf_counter()
    model = graph2class_model(MlpStackCreator(64, 0.1), hidden_state_size=64, padding=default_padding(),
                              token_splitting="bpe", subtoken_combination="max")
    embedder = model.gnn_model.node_embedding_model
    embedder.max_vocabulary_size = BPE_VOCABULARY
    model.compute_metadata(graphs(), parallelize=False)
    minibatches = []
    for mb, _ in model.minibatch_iterator(model.tensorize_dataset(graphs(), parallelize=False),
                                          max_minibatch_size=300, parallelize=False):
        minibatches.append(mb)
        if len(minibatches) == BPE_BATCHES:
            break
    module = model.build_neural_module(device=dev, seed=SEED).eval()
    mbs = [{"batch": mb["batch"].to(dev), "target_classes": torch.from_numpy(mb["target_classes"]).to(dev)}
           for mb in minibatches]
    lengths = np.concatenate([mb["batch"].node_data["lengths"][:int(mb["batch"].num_nodes)] for mb in minibatches])
    phase(name, f"setup {time.perf_counter() - t0:.2f} s; BPE vocabulary {len(embedder.vocabulary)} entries; "
          f"pieces per node label (count of labels with 0..5 pieces kept) {np.bincount(lengths, minlength=6).tolist()}")
    forwards = [0]
    counter = module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    sk.reset_launch_counts()  # the bpe path starts here
    eval_forward_phase(module, mbs, card, name, reps)
    counts = sk.launch_counts()  # the bpe path ends here
    counter.remove()
    if counts != {k: v * forwards[0] for k, v in PER_FORWARD.items()}:
        raise RuntimeError(f"bpe forwards launched {counts}, expected {PER_FORWARD} x {forwards[0]}")
    cpu_module = model.build_neural_module(device="cpu", seed=SEED).eval()
    worst = 0.0
    for mb, host in zip(mbs, minibatches):
        with torch.inference_mode():
            gpu_logits = module._logits(mb["batch"], train=False)[0].cpu().numpy()
            cpu_logits = cpu_module._logits(host["batch"].to("cpu"), train=False)[0].numpy()
        atol = 1e-4 * float(np.abs(cpu_logits).max())
        np.testing.assert_allclose(gpu_logits, cpu_logits, rtol=1e-4, atol=atol)
        top2 = np.sort(cpu_logits, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 1e-4
        np.testing.assert_array_equal(gpu_logits.argmax(-1)[decided], cpu_logits.argmax(-1)[decided])
        worst = max(worst, float(np.abs(gpu_logits - cpu_logits).max()) / max(float(np.abs(cpu_logits).max()), 1e-30))
    phase(name, f"launches over {forwards[0]} forwards {counts}; logits card vs CPU on {len(mbs)} batches within "
          f"rtol 1e-4, atol 1e-4 x max|logit| (worst {worst:.3e} of max|logit|), argmax equal on decided slots")
    return counts


def data_parallel_phase(dev, card):
    """DistributedModelTrainer at world size 1 over NCCL (a ``file://``
    rendezvous), ZeRO-1 on, at the benchmark configuration, for one
    shuffled epoch of about DP_STEPS optimizer steps, against ModelTrainer's
    same epoch from the same seed (node 0 keeps its shuffle order): every parameter within 1e-6 of its tensor's largest magnitude
    (and whether bitwise equal), the all-reduce calls and bytes per step,
    and the launches of the trainer's forwards and steps. Then the
    distributed Typilus CLI with ``--world-size 1`` for one epoch on
    synthetic folds. Returns the launch counts of the path."""
    import io as stdio
    import os
    import random
    import tempfile

    import torch.distributed as dist

    from ptgnn_tpu_torch.core.trainer import ModelTrainer, shuffle_seed
    from ptgnn_tpu_torch.implementations.typilus import traindistributed
    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model, default_padding
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.parallel import DistributedModelTrainer, initialize_multi_host, moment_elements
    from ptgnn_tpu_torch.utils.io import write_jsonl_gz
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    name = "data-parallel"
    t_phase = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    # The graphs of DP_STEPS full batches in order, and one more graph that
    # closes the last of them (the trainers drop the partial batch it opens).
    probe = create_graph2class_gnn_model(hidden_state_size=64, padding=default_padding())
    every = list(graphs(SEED))
    probe.compute_metadata(iter(every), parallelize=False)
    batched = [raw for _, raw in probe.minibatch_iterator(
        probe.tensorize_dataset(iter(every), parallelize=False, return_input_data=True),
        max_minibatch_size=300, parallelize=False)]
    if len(batched) <= DP_STEPS:
        raise RuntimeError(f"the benchmark graphs make {len(batched)} batches, fewer than {DP_STEPS + 1}")
    train_graphs = [g for raw in batched[:DP_STEPS] for g in raw] + batched[DP_STEPS][:1]
    valid_graphs = list(graphs(SEED + 1))[:6]
    common = dict(max_num_epochs=1, minibatch_size=300, clip_gradient_norm=1.0, device=dev, seed=SEED,
                  optimizer_creator=lambda p: torch.optim.Adam(p, lr=2.5e-4),
                  target_validation_metric="Accuracy", target_validation_metric_higher_is_better=True)
    run = dict(validate_on_start=False, patience=0, parallelize=False, shuffle_training_data=True)
    # The full batches of the first epoch's shuffled order, as the trainers make it.
    dp_steps = sum(1 for _ in probe.minibatch_iterator(
        probe.tensorize_dataset(iter(train_graphs), parallelize=False), max_minibatch_size=300,
        yield_partial_minibatches=False, shuffle_input=True, parallelize=False,
        shuffle_rng=random.Random(shuffle_seed(SEED, 0))))

    single = ModelTrainer(create_graph2class_gnn_model(hidden_state_size=64, padding=default_padding()),
                          out_dir / "dp-single.pkl.gz", **common)
    single.load_metadata_and_create_network(train_graphs, parallelize=False)
    t0 = time.perf_counter()
    single.train(train_graphs, valid_graphs, initialize_metadata=False, **run)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    initialize_multi_host("nccl", f"file://{rendezvous}/store", world_size=1, rank=0)
    try:
        trainer = DistributedModelTrainer(create_graph2class_gnn_model(hidden_state_size=64, padding=default_padding()),
                                          out_dir / "dp-ranked.pkl.gz", zero1=True, **common)
        trainer.load_metadata_and_create_network(train_graphs, parallelize=False)
        module = trainer.neural_module
        forwards, backwards, traffic = [0], [0], {}
        hooks = [module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1)),
                 module.node_to_class.weight.register_hook(lambda g: backwards.__setitem__(0, backwards[0] + 1))]
        trainer.register_train_epoch_end_hook(lambda *_: traffic.update(
            calls=trainer.data_parallel.allreduce_calls, bytes=trainer.data_parallel.allreduce_bytes))
        optimizers = []
        trainer.register_training_start_hook(lambda model, module, optimizer: optimizers.append(optimizer))
        sk.reset_launch_counts()  # the data-parallel path starts here
        t0 = time.perf_counter()
        trainer.train(train_graphs, valid_graphs, initialize_metadata=False, **run)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        trainer_counts = sk.launch_counts()
        for hook in hooks:
            hook.remove()
        moments = moment_elements(optimizers[0])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    steps = (trainer._opt_steps_this_epoch, single._opt_steps_this_epoch)
    if steps != (dp_steps, dp_steps) or backwards[0] != dp_steps or dp_steps < 2:
        raise RuntimeError(f"optimizer steps (distributed, single) {steps}, backwards {backwards[0]}: expected {dp_steps}")
    expected = {k: PER_FORWARD[k] * forwards[0] + (PER_TRAIN_STEP[k] - PER_FORWARD[k]) * backwards[0]
                for k in trainer_counts}
    if trainer_counts != expected:
        raise RuntimeError(f"data-parallel trainer launches {trainer_counts} != {expected} expected from "
                           f"{forwards[0]} forwards and {backwards[0]} steps")
    worst, bitwise = 0.0, True
    for (pname, a), b in zip(single.neural_module.named_parameters(), trainer.neural_module.parameters()):
        a, b = a.detach(), b.detach()
        err = float((a - b).abs().max())
        bitwise &= bool(torch.equal(a, b))
        if err > 1e-6 * float(a.abs().max()):
            raise RuntimeError(f"{pname}: the data-parallel step is {err} from ModelTrainer's")
        worst = max(worst, err / max(float(a.abs().max()), 1e-30))
    params = sum(p.numel() for p in module.parameters())
    phase(name, f"DistributedModelTrainer (NCCL, world size 1, ZeRO-1 holding {moments} moment elements for "
          f"{params} parameters) vs ModelTrainer: {dp_steps} optimizer steps each over the same shuffled batches and "
          f"dropout seeds, then validation; parameters within 1e-6 of each max (worst {worst:.3e}), bitwise equal: "
          f"{bitwise}; train + validation {t_train:.2f} s (ModelTrainer {t_single:.2f} s); all-reduces over the train steps "
          f"{traffic.get('calls', 0) / dp_steps:.1f} calls and {traffic.get('bytes', 0) / dp_steps:.0f} bytes per "
          f"step; launches {trainer_counts} from {forwards[0]} forwards and {backwards[0]} steps")

    root = out_dir / "dp-cli"
    shutil.rmtree(root, ignore_errors=True)
    folds = []
    for i, (fold, count) in enumerate((("train", 12), ("valid", 4), ("test", 4))):
        (root / fold).mkdir(parents=True)
        write_jsonl_gz(root / fold / "part0.jsonl.gz",
                       synthetic_typilus_graphs(count, seed=SEED + 30 + i, mean_nodes=1500, max_nodes=4000))
        folds.append(str(root / fold))
    cwd = os.getcwd()
    os.chdir(root)  # the CLI's log file goes under the working directory
    before = sk.launch_counts()
    t0 = time.perf_counter()
    try:
        out = stdio.StringIO()
        with contextlib.redirect_stdout(out):
            accuracy = traindistributed.run(traindistributed.build_arg_parser().parse_args(
                [*folds, str(root / "dist.pkl.gz"), "--max-num-epochs", "1", "--max-nodes", "8192",
                 "--world-size", "1", "--quiet"]))
    finally:
        os.chdir(cwd)
    cli = delta(sk.launch_counts(), before)
    line = [ln for ln in out.getvalue().splitlines() if ln.startswith("Test accuracy:")]
    if not line or accuracy is None or not 0.0 <= accuracy <= 1.0 or not (root / "dist.pkl.gz").exists():
        raise RuntimeError(f"traindistributed printed {line}, returned {accuracy}")
    if min(cli[k] for k in ("segment_extremum", "broadcast_to_edges", "segment_sum")) <= 0:
        raise RuntimeError(f"the distributed CLI run missed a kernel: {cli}")
    counts = add_counts(trainer_counts, cli)  # the data-parallel path ends here
    phase(name, f"traindistributed --world-size 1 (NCCL, ZeRO-1): 1 epoch over 12 graphs in "
          f"{time.perf_counter() - t0:.2f} s; '{line[0]}'; launches {cli}")
    phase(name, f"launches over the data-parallel path {counts}; the 2-rank path runs on the CPU over gloo "
          f"(tests/test_torch_parallel_dp.py): this machine has one card; phase total "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:] == ["--sanitizer-target"]:
        sanitizer_target()
        return
    if sys.argv[1:2] == ["--layers-gate"]:
        layers_gate_repeats(int(sys.argv[2]))
        return
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.ops import cuda_build
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    t_start = time.perf_counter()
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
    model, module, minibatches, batches = build_bench(dev)
    module.eval()
    sizes = [(int(mb["batch"].num_graphs), int(mb["batch"].num_nodes), int(mb["batch"].num_edges))
             for mb in minibatches]
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

    # ---- 10-12. argmax routing, GGNN, the CLIs ------------------------------
    argmax_counts = argmax_phase(dev, card)
    ggnn_counts = ggnn_phase(dev, card)
    cli_counts = cli_phase(card)

    # ---- 13. VarMisuse at full width, both factories -----------------------
    vm_pad, _, vm_samples, vm_valid = varmisuse_samples()
    vm_counts = {}
    for architecture in ("mlp", "ggnn"):
        vm_counts[architecture], _, vm_batches = varmisuse_phase(dev, card, architecture, vm_pad, vm_samples,
                                                                  vm_valid)

    # ---- 14. Graph2Seq at full width -----------------------------------------
    g2s_counts, g2s_batches = graph2seq_phase(dev, card, *graph2seq_samples())

    # ---- 17. the other message-passing families at full width ---------------
    layers_counts, layers_batches, layers_seen = layers_phase(dev, card)

    # ---- 18-20. edge features, the BPE embedder, data parallelism -----------
    edge_counts, edge_adj = edge_features_phase(dev, card)
    bpe_counts = bpe_phase(dev, card)
    dp_counts = data_parallel_phase(dev, card)
    paths = {"serving": serving_counts, "train": train_counts,
             "ppi-serving": ppi_serving_counts, "ppi-train": ppi_train_counts,
             "argmax-train": argmax_counts, "ggnn": ggnn_counts, "cli": cli_counts,
             "varmisuse-mlp": vm_counts["mlp"], "varmisuse-ggnn": vm_counts["ggnn"],
             "graph2seq": g2s_counts, "layers": layers_counts, "edge-features": edge_counts,
             "bpe": bpe_counts, "data-parallel": dp_counts}
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
    cpu_bc_plan = tree_to(bc_plan, torch.device("cpu"))
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

    # The sum adds each row's slots in slot order, as index_add_ does on the
    # CPU: bitwise equal to the plain version run there. index_add_ on the
    # card adds in another order: within 1e-5 of each row's sum of |x|.
    # Exact on 0/1 data (the tie counts), and the same bits on every run.
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
            if not bitwise_equal(got.cpu(), sk.segment_sum_plain(data.cpu(), cpu_bc_plan, num_nodes)):
                raise RuntimeError(f"sum kernel != its plain version on the CPU at {width}/{dtype}")
            if not bitwise_equal(got, sk.planned_segment_sum(data, bc_plan, num_nodes)):
                raise RuntimeError(f"sum kernel gave other bits on a second run at {width}/{dtype}")
            ones = (torch.rand(data.shape, device=dev, generator=gen) < 0.5).to(dtype) * adj.mask[:, None].to(dtype)
            if not bitwise_equal(sk.planned_segment_sum(ones, bc_plan, num_nodes),
                                 sk.segment_sum_plain(ones, bc_plan, num_nodes)):
                raise RuntimeError(f"sum kernel != plain version on 0/1 data at {width}/{dtype}")
            sum_checks.append(f"{width}/{str(dtype)[6:]}")
    torch.cuda.synchronize()
    phase("parity", f"sum kernel bitwise equal to its plain version on the CPU, within 1e-5 x sum|x| of the "
          f"plain version on the card (max abs err {max_abs_err['segment_sum']:.3e}), bitwise on 0/1 data and "
          f"run to run, at {sum_checks}")

    # ---- 6. train parity ----------------------------------------------------
    train_parity_phase(model, batches[0], minibatches[0], dev)
    repeat_check(model, batches[0], dev)

    # ---- 9. PPI parity ------------------------------------------------------
    ppi_max_abs_err = ppi_parity_phase(ppi_model, ppi_minibatches, ppi_batches, dev)

    # ---- 7. kernel timings -------------------------------------------------
    kernels = []

    def entry(name, width, times, k):
        return {
            "name": name, "route": "cuda", "source": KERNEL_FILES[name][0], "replaces": KERNEL_FILES[name][1],
            "launches": main_counts[name],
            "launches_by_path": {path: counts[name] for path, counts in paths.items()},
            "launches_per_forward": PER_FORWARD[name], "launches_per_train_step": PER_TRAIN_STEP[name],
            "max_abs_err": max_abs_err[name],
            "ms": times["ms"], "plain_ms": times["plain_ms"], **bound(k.nbytes, k.ops),
            "library_ms": times["library_ms"], "width": width, "dtype": "float32",
        }

    # The path's float32 widths: the sum's tie counts 64 and 128 and combined
    # node cotangent 128 and 256; D = M = 64 before the residuals, 128 after.
    for name, widths in (("segment_sum", (64, 128, 256)), ("broadcast_to_edges", (64, 128)),
                         ("segment_extremum", (64, 128))):
        for width in widths:
            k = layout_kernel(name, adj, width, dev, gen)
            e = entry(name, width, layout_times(k), k)
            if width == 64:
                kernels.append(e)
            phase("kernels", json.dumps(e))
    # The PPI layout's sum widths (the forward 256, the backward's combined
    # cotangents 512) and broadcast width (256).
    ppi_adj = ppi_batches[0]["batch"].adjacency
    for name, width in (("segment_sum", 256), ("segment_sum", 512), ("broadcast_to_edges", 256)):
        k = layout_kernel(name, ppi_adj, width, dev, gen)
        e = entry(name, width, layout_times(k), k)
        # the broadcast bitwise equal to its plain version (ppi-parity)
        e["max_abs_err"] = ppi_max_abs_err[f"segment_sum {width} float32"] if name == "segment_sum" else 0.0
        phase("kernels", "PPI layout " + json.dumps(e))
    kernels += ppi_kernel_entries(ppi_adj, dev, gen, ppi_max_abs_err, main_counts, paths)
    # The edge-feature path's typed matmul shapes (bf16; forward and dx of
    # both stacks) on its layout.
    edge_max_abs_err = {}
    typed_matmul_checks(edge_adj, dev, gen, edge_max_abs_err, shapes=EDGE_TYPED_SHAPES, dtypes=(torch.bfloat16,),
                        name="kernels")
    kernels += ppi_kernel_entries(edge_adj, dev, gen, edge_max_abs_err, main_counts, paths, shapes=EDGE_TYPED_SHAPES,
                                  dtypes=((torch.bfloat16, BF16_OPS_PER_S),), layout="edge-features")
    skewed_layout_checks(minibatches[0]["batch"].adjacency, dev, gen)
    varmisuse_kernel_checks(vm_batches[0]["batch"].adjacency, dev, gen)
    kernels += graph2seq_kernel_entries(g2s_batches[0]["batch"].adjacency, dev, gen, entry)
    kernels += layers_kernel_entries(layers_batches[0][0].adjacency, layers_seen, dev, gen, entry)
    argmax_err = argmax_kernel_checks(adj, dev, gen)
    kernels.append(argmax_kernel_entry(adj, dev, gen, argmax_err, main_counts["segment_extremum_argmax"],
                                       {k: v["segment_extremum_argmax"] for k, v in paths.items()}))
    torch.cuda.synchronize()
    sanitizer_phase()

    phase("total", f"{time.perf_counter() - t_start:.1f} s from the start, the kernel builds included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
