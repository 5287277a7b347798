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
   (per step 8 broadcast and 34 sum launches, per loss forward 20 sum); a float32
   train step (dropout 0) card against CPU; greedy decode card against CPU,
   the device loop against the host loop, beam 1 against greedy; the
   decoder alone at its 20,000-token vocabulary cap (eval loss, a train
   step and a greedy decode batch, timed); the decoder's and the
   summariser's segment sums (sort + K1 into 64 rows), timed;
15. kernels: each kernel's time (CUDA events over a CUDA graph of launches
   on rotating inputs), its bound, its plain version's and one library
   call's time, as one JSON line; the broadcast (K3) at every (row bytes,
   dtype) that a path launched it at (each wrapper call is tallied by
   width: D, M and the backward's widened g | ties | node_states table, in
   float32 and bf16 AMP), on that path's layout (Graph2Class's, PPI's,
   Graph2Seq's, the layers stack's, a 2-way node shard's interior and
   boundary), bitwise against its plain version, with its one-tile floor
   (the same harness over the layout's first tile); before it, the argmax extremum against
   its plain version at M 64 and 128, float32 and bf16, max and min, with
   planted ties, and the extremum, the argmax extremum and the sum on a
   skewed layout (the benchmark batch plus one hub row of 4,096 slots, which
   the kernels split) against their plain versions, timed beside
   scatter_reduce and index_add_; then the extremum, the broadcast and the
   sum on a VarMisuse batch's layout at the path's widths against their
   plain versions, and timed; then the sum on a Graph2Seq batch's layout at
   width 128 against its plain version, and timed; the keyed dropout (K7)
   at every (E, C, column offset, tile, dtype) a path launched it at, and at
   Graph2Seq's [131072, 128] block in both orientations in float32 and
   bf16, bitwise against its plain version and timed beside it, with its
   launches by path (``chip_smoke.py --keyed-dropout`` runs the Graph2Seq
   shapes alone)
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
   matmul launches; per step 5 broadcast, 15-21 sum and in bf16 10 typed
   matmul), no fused-op call, and for the MLP-MP stack the output states and
   a float32 train step card against CPU on weights converted through
   ``convert.py`` (the PPI phase's limits) and its float32 step on the
   sort + K1 sums against the ``index_add_`` route; the typed matmul at the
   path's bf16 shapes against float64 and timed (entries of the kernels
   line);
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
   4-rank path runs on four cards under ``--world 4`` (below) and on the
   CPU over gloo in the tests;
21. edge-parallel: ``shard_adjacency`` cuts a benchmark batch into 4
   tile-aligned shards; each shard's K2 and K1 over its own row index on the
   card, combined as the all-reduce would (the max bitwise the unsharded
   K2's, the sum within 1e-5 of each row's sum of |x|); ``EdgeParallel`` at
   world 1 over NCCL for 3 SGD steps (dropout 0), each from the single-
   device step's weights, against that step (every parameter within 1e-5
   of its largest magnitude);
22. node-parallel: ``shard_batch_by_nodes`` splits a benchmark batch 2 and 4
   ways under the BFS reorder; the port's node-sharded forward
   (``GraphNeuralNetwork._forward_node_sharded``) runs every shard in this
   one process, a thread a shard, with the boundary rows passed in-process,
   forward and backward, against the unsharded stack through the
   permutation (states within 1e-5 of their max, each gradient within 1e-4
   of its max), with the boundary rows and the bytes a layer exchanges; K1,
   K2 and K3 held to their plain versions on every shard's interior,
   boundary and merged layouts; ``NodeParallel`` at world 1 over NCCL
   against the single-device step as in 21; ``NodeShardedModelTrainer``
   (node shards 1) for an epoch; ``traindistributed --world-size 1
   --node-shards 1``; PPI at hidden 256 node-sharded in bf16 AMP (K5 open)
   and in float32 against the unsharded steps (losses, gradients, stepped
   parameters), and K5 held on its interior and boundary layouts. The 2-
   and 4-rank paths run on four cards under ``--world 4`` (below) and on
   the CPU over gloo in the tests.
23. native-assembler (after node-parallel; the library is built in phase 2):
   the C++ layout assembler (``ptgnn_tpu_torch/native/``) against the numpy
   oracle on the benchmark batch, a PPI batch and a 2-way node-parallel
   boundary layout (bitwise; host ms per layout, medians of 7, in turns);
   four ModelTrainer epochs of about 18 benchmark batches (54 synthetic
   graphs, worker threads on) with each assembler in turns, bitwise equal,
   and the device's busy share of a profiled epoch with each;
24. prefetch: two epochs at ``prefetch_to_device`` 1 beside phase 23's at
   2: losses and parameters bitwise equal, and the seconds of each;
25. oom: the allocator capped (``set_per_process_memory_fraction``) between
   a benchmark step's peak and that of one batch at a 16,384-node padding;
   an epoch with that batch in it skips it under ``catch_device_ooms`` (one
   real ``torch.OutOfMemoryError`` caught) and raises without; the cap is
   lifted in a ``finally``;
26. autotune: ``typilus train --autotune`` through the CLI's ``main`` on
   synthetic folds of the benchmark's graphs over the full default grid
   (9 candidates): each candidate's median ms/step and edges/s, the pick,
   the epoch trained at it; then K1-K3 against their plain versions on the
   picked padding's layout;
27. checkpoint: ``DistributedCheckpointer`` at world 1 over NCCL with
   ZeRO-1: an async save after step 3 while steps 4-5 run; a restore into a
   fresh module and optimizer (parameters and both Adam moments bitwise);
   the resumed step 4 bitwise the uninterrupted one; retention at 2 steps
   with the sidecars; the save, commit and restore seconds;
28. profiling: ``profile_trace`` around 3 Graph2Class train steps writes a
   Chrome trace under build/ that holds K1-K3 under their symbols; one
   MLP-MP layer's traced device ms beside ``mp_layer_roofline``'s bound.

29. compiled: the compiled steps (``core/compiled_step.py``: every
   single-device step a CUDA graph per batch signature) against the same
   step functions called eagerly: 10 train steps from the same weights and
   seeds, bit for bit in the losses, every parameter and both Adam
   moments (Graph2Class at the benchmark configuration in float32 and bf16
   AMP with dropout on, PPI bf16 with K5 in the graph, VarMisuse 'mlp',
   Graph2Seq), then ms/step (the median of 5 runs of 20), the device's busy
   share of a profiled run, the capture seconds and pool bytes of each;
   ``predict_probs`` bitwise and its ms/batch; ModelTrainer epochs of 17
   benchmark steps with the host pipeline, compiled against eager, at
   gradient accumulation 1 and 2, bitwise.
30. multiprocess-tensorize: the forked tensorize (``tensorize_dataset``'s
   ``use_multiprocessing``, the default of ``ModelTrainer.train``) against
   the thread pool on phase 23's Graph2Class epoch: the seconds from the
   call to the first sample of each (the fork of this process with its
   CUDA context live), four epochs in turns (forked, threads, threads,
   forked) bitwise equal in losses and parameters with their seconds, the
   device's busy share of a profiled epoch of each; a tensorize raising on
   its 5th sample in the child surfaces as RuntimeError with the child's
   traceback; DistributedModelTrainer at world 1 over NCCL with and
   without the fork, bitwise; no child left behind;
31. linear-residual: the benchmark stack at width 64 with its two concat
   residuals replaced by LinearResidualLayers: an eval forward and its
   logits against the CPU, a train step (dropout 0) against the CPU
   (``step_against_cpu``), with K1-K3's launches counted on a path of
   their own.

Every phase that runs ModelTrainer.train, a task model's report or a
train CLI with the worker threads on forks a tensorize child (their
default); the bitwise gates of the epochs hold with it.

Every path above that trains or serves through an entry point runs compiled
steps on the card. Their launch counters count executions: a capture's
launches are put back and each replay adds them, as do the hook counters
(``Tally``), so the per-forward and per-step constants hold; a compiled
step's warm-up (one call per signature) is an execution like any other.

Phases 10, 14 and 17 also hold argmax routing on a feature-tracking batch
with a featureless graph against a single-winner oracle, and a float32
Graph2Seq and layers step that repeats bit for bit in PyTorch's default
mode. Every K1 launch counts in the per-forward and per-step constants,
those of ``ops/segment.py``'s sums (over sorted ids) and of the backward
of its gathers (``take_rows``) included.

Then the total seconds. The last line is {"ok": true, "device": {...}};
the line before it is the card's name and power limit as nvidia-smi
reports them, and the one before that the kernels JSON line.

The multi-card path, on four cards of one host (it raises with fewer and
never falls back):

    python3 chip_smoke.py --world 4 [--legs kernels,nccl,dp,edge,node,hybrid,checkpoint,epoch,cli]

(every leg, or those named) builds the kernels once, runs leg 1 in this process, then spawns 4 ranks
(``spawn``, a ``file://`` rendezvous in a temporary directory, NCCL,
``initialize_multi_host``, one card a rank), joined with a time limit:

1. kernels: K1-K5 on cards 0-3, each called from a thread whose current
   device is card 0, bitwise against their plain versions (K1's on the
   CPU, K5's on integer data) and card 0's results; then phase 29's
   compiled step and phase 30's DistributedModelTrainer epoch at world 1;
2. DistributedModelTrainer with ZeRO-1 at the benchmark configuration
   (Adam eps 1e-3), float32 unclipped and bf16 AMP clipped at 1.0, 3 steps
   of 4 minibatches: step 1 within 1e-5 of each parameter's max of one
   card's steps on the weighted mean gradient, step 3 within 4 times the
   reference's own spread when its sum is taken in other orders;
   compiled against eager bitwise (losses, parameters, both moments); each
   rank's share of the moments, the all-reduces, and the launches against
   the world-1 constants; DataParallel's train step compiled against eager,
   timed, and NCCL's share of a profiled run;
3. EdgeParallel, a benchmark batch's edges over the 4 cards: 3 SGD steps
   within 1e-5 of each parameter's max of the single-device step;
   compiled against eager bitwise;
4. NodeParallel over the 4 cards (BFS reorder): the forward states bitwise
   the in-process 4-shard stack's (``node_sharded_stack``); gradients
   within 1e-4 of each max of the unsharded step; steps as in 3; PPI at
   hidden 256 in bf16 AMP (K5 in the cross-card graph) and float32;
   compiled against eager bitwise; the boundary rows and bytes;
5. the 2 data x 2 node hybrid: a step within 1e-4 of each update's max of
   the unsharded weighted-mean step; ZeRO-1 over the data group;
   NodeShardedModelTrainer for an epoch, compiled against eager bitwise,
   only the node's assembler (rank 0) tensorizing and resharding;
6. DistributedCheckpointer with ZeRO-1 at world 4 (phase 27's round trip,
   Adam eps 1e-3): the resumed step bitwise a twin run's step through a
   new DataParallel, and within 1e-5 of each parameter's max of the
   uninterrupted step (its DataParallel's rebuilt buckets add in another
   order); then, in the ranks, the epoch: DistributedModelTrainer for 2
   epochs over 288 benchmark graphs, the second timed alone, one node's
   assembler (rank 0) handing the others their slots: each rank's slots
   of the first 3 groups bitwise an in-process minibatch_iterator's, and
   ranks 1-3 with no tensorize, forked child, finalize or reshard;
7. traindistributed --world-size 4, and with --node-shards 2, for an
   epoch each (after the ranks end);
8. readings: ms per step of legs 2-5 against the world-1 step, each epoch
   at world 4 against world 1 with each rank's host seconds (tensorize,
   assemble, finalize, reshard, handoff) and handoff bytes a slot, NCCL's
   share, the launches by path on every rank.

A failed gate is recorded and the legs go on; the run then prints every
failure and exits non-zero. The ranks' logs go to build/chip_smoke/world/.
The last line is {"ok": true, "device": {..., "count": 4}}.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import math
import shutil
import statistics
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


# Every K1 launch counts, those of ops/segment.py's sums (K1 over the sorted
# ids: GraphNorm, the reduces, the heads, the decoder) and of the backward of
# its gathers (``take_rows``: a K1 sum of each row's cotangents) included.
# Graph2Class's train step: the readout gather's backward sum once.
PER_FORWARD = counts_of(extremum=8, broadcast=8)
PER_TRAIN_STEP = counts_of(extremum=8, broadcast=24, segsum=17)
# Argmax routing, per MLP-MP layer: the target-row broadcast and the argmax
# extremum forward; the g-row broadcast and one sum backward (no tie count).
ARGMAX_PER_FORWARD = counts_of(argmax=8, broadcast=8)
ARGMAX_PER_TRAIN_STEP = counts_of(argmax=8, broadcast=16, segsum=9)
# GGNN, per gated layer (no target state): the extremum forward; the
# extremum-row broadcast, the tie count, the g-row broadcast and the
# cotangent sum backward.
GGNN_PER_FORWARD = counts_of(extremum=8)
GGNN_PER_TRAIN_STEP = counts_of(extremum=8, broadcast=16, segsum=17)
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
# K6, the typed dW (tallied beside the counts above): one a layer in a bf16
# step, the dW of each MP layer's typed message product.
PPI_DW_PER_TRAIN_STEP = {"float32": 0, "bf16": 5}
# VarMisuse: the 'mlp' stack is Graph2Class's; the head's sums add three K1
# a forward and eight a step (its gathers' backward included). The 'ggnn'
# stack's gated layer (8 positions, sum aggregation, no target state): the
# sum forward; the g-row broadcast and the cotangent sum backward; the global
# updates and the head add five K1 a forward and twelve a step.
# K5's gate stays closed (no message weight block reaches 128 KB in bf16).
VM_BATCHES = 6
VM_TRAIN_STEPS = 20
VM_PER_FORWARD = {"mlp": counts_of(extremum=8, broadcast=8, segsum=3), "ggnn": counts_of(segsum=13)}
VM_PER_TRAIN_STEP = {"mlp": counts_of(extremum=8, broadcast=24, segsum=24),
                     "ggnn": counts_of(broadcast=8, segsum=28)}
# Graph2Seq: 8 gated positions (one layer object at 7 of them, sum
# aggregation): the sum forward; the g-row broadcast and the cotangent sum
# backward. The summariser adds four sums, so the encode launches 12; a loss
# forward 20 (the teacher-forced decoder 8); a decode loop (greedy or beam,
# max_seq_len steps) 72; a train step 34.
G2S_BATCHES = 6
G2S_TEST_BATCHES = 2
G2S_TRAIN_STEPS = 20
G2S_BEAM = 5
G2S_PER_FORWARD = counts_of(segsum=20)
G2S_PER_ENCODE = counts_of(segsum=12)
G2S_PER_DECODE_LOOP = counts_of(segsum=72)
G2S_PER_TRAIN_STEP = counts_of(broadcast=8, segsum=34)
# The 'layers' stack (harness.LayersStackCreator). Forward: PNA on the
# per-slot route (degrees from the plan's counts under the static mask) two
# sums and two extrema; EGC's fused max (no target state) one extremum; the
# per-slot mean (the plan's counts) one sum; the fused max MLP-MP layer a
# broadcast and an extremum. Backward: each per-slot sum one broadcast, each
# per-slot extremum two broadcasts and a sum (the tie count), each fused max
# two broadcasts and two sums. Under edge dropout the fused layers take the
# per-slot route, and the live in-degrees of PNA and of the mean are the sum
# at width 1. ops/segment.py's sums (GraphNorm, the readout) add four K1 a
# forward; with the backward of the gathers (the per-slot layers' senders,
# receivers and weight stacks, PNA's means, GraphNorm's and the readout's
# rows) seventeen a step, twenty-two under edge dropout. K5's gate stays closed: no weight block is 128 wide on both sides.
LAYERS_TRAIN_STEPS = 20
LAYERS_EDGE_DROPOUT = 0.1
LAYERS_EDGE_DROPOUT_STEPS = 5
LAYERS_PER_FORWARD = counts_of(extremum=4, broadcast=1, segsum=7)
LAYERS_PER_TRAIN_STEP = counts_of(extremum=4, broadcast=12, segsum=26)
LAYERS_PER_EDGE_DROPOUT_STEP = counts_of(extremum=4, broadcast=11, segsum=31)
LAYERS_FUSED_PER_FORWARD = 2  # EGC and the last MLP-MP layer
# Edge features (PPI's layout, hidden 256, 128 feature columns): every layer
# takes the per-slot route (the fused op takes no features), so per layer
# one sum forward and its broadcast backward; the typed matmul where its
# gate opens (bf16: D = 2 x 256 + 128 = 640 or, in the gated layer,
# 256 + 128 = 384, M = 256) once forward and once backward (dx). Five
# layers in both stacks. The backward of the gathers adds K1 sums a step:
# the feature rows' once, and per layer the senders' (and the MLP-MP
# layer's receivers') and, where K5's gate is closed, the weight stack's.
EDGE_TRAIN_STEPS = 10
EDGE_PER_FORWARD = {"float32": counts_of(segsum=5), "bf16": counts_of(segsum=5, typed=5)}
EDGE_PER_TRAIN_STEP = {
    "mlp": {"float32": counts_of(broadcast=5, segsum=21), "bf16": counts_of(broadcast=5, segsum=16, typed=10)},
    "gated": {"float32": counts_of(broadcast=5, segsum=20), "bf16": counts_of(broadcast=5, segsum=15, typed=10)},
}
EDGE_TYPED_SHAPES = ((640, 256), (256, 640), (384, 256), (256, 384))  # forward and dx, both stacks
# BPE: a vocabulary of 64 entries splits the synthetic labels into 1-8
# pieces (5 kept); at the factory's 10,000 every label is one piece.
BPE_VOCABULARY = 64
BPE_BATCHES = 3
DP_STEPS = 3


class Tally(list):
    """A hook's counter (``[0]``) that compiled steps replay: a capture runs
    the hook once and launches nothing, so the count is put back after it
    and each replay adds what the capture added, as the kernels' launch
    counters (``core/compiled_step.py``). It counts executions on the card."""

    def __init__(self):
        from ptgnn_tpu_torch.core import compiled_step

        super().__init__([0])
        compiled_step.REPLAYED_COUNTERS.append((self, "n"))

    @property
    def n(self) -> int:
        return self[0]

    @n.setter
    def n(self, value: int) -> None:
        self[0] = value


def executions(stats: dict, steps: int) -> int:
    """The steps a ``train_steps`` call ran on the card: its warm-up step,
    ``steps`` timed steps and a warm-up call per compiled signature."""
    from ptgnn_tpu_torch.core.compiled_step import WARMUP_CALLS

    return steps + 1 + WARMUP_CALLS * len(stats["captures"])


# Where a rank of the multi-card path sends the phase lines (``world_rank``).
PHASE_SINK: Callable[[str, str], None] | None = None


def phase(name: str, msg: str) -> None:
    if PHASE_SINK is not None:
        PHASE_SINK(name, msg)
        return
    print(f"[{name}] {msg}", flush=True)


def synchronize() -> None:
    """Wait for the card: a no-op where there is none (the multi-card legs
    also run on the CPU, in tests/test_torch_multicard.py)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def card_lines() -> list:
    """Each card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


def card_line() -> str:
    return card_lines()[0]


def graphs(seed: int = SEED):
    from ptgnn_tpu_torch.implementations.typilus.harness import bench_graph_count
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    return synthetic_typilus_graphs(
        bench_graph_count(NUM_BATCHES), seed=seed, mean_nodes=2500, max_nodes=8000
    )


class Launches(dict):
    """The kernels' launch counts by kernel name; ``by_width`` holds the
    broadcast's (K3's) by (row bytes, dtype name), ``by_shape`` the typed
    dW's (K6's) by (tiles, tile, Din, M, types), ``keyed`` the keyed
    dropout's (K7's) by (E, C, column offset, tile, dtype name). K6 and K7
    are tallied beside the counts by kernel, not among them: equality
    compares the counts by kernel only (the five kernels each path's
    constants hold exactly)."""

    def __init__(self, counts=(), by_width=None, by_shape=None, keyed=None):
        super().__init__(counts)
        self.by_width = dict(by_width or {})
        self.by_shape = dict(by_shape or {})
        self.keyed = dict(keyed or {})

    @property
    def typed_dw(self) -> int:
        return sum(self.by_shape.values())


def launch_counts() -> Launches:
    """The launch counters now, with K3's tally by width and K6's and K7's
    by shape."""
    from ptgnn_tpu_torch.ops import keyed_dropout as kd
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.ops import typed_linear as ttl

    counts = sk.launch_counts()
    counts.pop("keyed_dropout_elements")  # elements hashed, not launches
    if counts.pop("typed_dw") != sum(ttl.typed_dw_kernel.launches_by_shape.values()):
        raise RuntimeError("the typed dW's launches and its tally by shape disagree")
    if counts.pop("keyed_dropout") != sum(kd.keyed_dropout_kernel.launches_by_shape.values()):
        raise RuntimeError("the keyed dropout's launches and its tally by shape disagree")
    return Launches(counts, sk.broadcast_launches_by_width(), ttl.typed_dw_kernel.launches_by_shape,
                    kd.keyed_dropout_kernel.launches_by_shape)


def _by_width(counts) -> dict:
    return getattr(counts, "by_width", {})


def _by_shape(counts) -> dict:
    return getattr(counts, "by_shape", {})


def _tally_sum(a: dict, b: dict, sign: int = 1) -> dict:
    out = dict(a)
    for k, n in b.items():
        out[k] = out.get(k, 0) + sign * n
    return {k: n for k, n in out.items() if n}


def _keyed(counts) -> dict:
    return getattr(counts, "keyed", {})


def delta(after, before):
    return Launches({k: after[k] - before[k] for k in after}, _tally_sum(_by_width(after), _by_width(before), -1),
                    _tally_sum(_by_shape(after), _by_shape(before), -1), _tally_sum(_keyed(after), _keyed(before), -1))


def add_counts(a, b):
    return Launches({k: a[k] + b[k] for k in a}, _tally_sum(_by_width(a), _by_width(b)),
                    _tally_sum(_by_shape(a), _by_shape(b)), _tally_sum(_keyed(a), _keyed(b)))


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


def layout_kernel(kind: str, adj, width: int, dev, gen, dtype=torch.float32, plan=None) -> LayoutKernel:
    """``kind`` (the sum, the max extremum, the max extremum with its
    winning slots, or the broadcast) on ``adj``'s layout at ``width``,
    float32 (the broadcast also in ``dtype``, over ``plan`` if given, else
    the supertile plan). Bytes, each input read once and each output
    written once: a reduction reads the real slots' rows and slot ids and
    the row offsets (an extremum the counts too) and writes a row per node
    (and the slots); the broadcast reads the receivers' rows, the slot rows
    and the tile rows and writes a row per slot, rows of ``width`` elements
    of ``dtype``. Operations: one per real element of a reduction. Library
    calls: ``index_add_``; ``scatter_reduce`` amax (values only for the
    argmax: a partial stand-in); ``index_select`` and the mask."""
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    num_nodes = adj.agg_counts.numel()
    e_pad, e_real = adj.mask.shape[0], int(adj.mask.sum())
    valid = adj.receivers < num_nodes
    if kind == "broadcast_to_edges":
        plan = sk.sum_plan_from_adjacency(adj) if plan is None else plan
        slots = plan.local_rows.shape[0]
        plan_rows = sk.plan_rows(plan, num_nodes)
        real = plan_rows < num_nodes
        safe = torch.where(real, plan_rows, 0)
        rows = int(torch.unique(plan_rows[real]).numel())
        row_bytes = width * torch.empty((), dtype=dtype).element_size()
        return LayoutKernel(
            lambda t: sk.planned_broadcast_to_edges(t, plan), lambda t: sk.broadcast_plain(t, plan),
            lambda t: torch.where(real[:, None], t.index_select(0, safe), torch.zeros((), dtype=t.dtype, device=dev)),
            lambda: torch.randn(num_nodes, width, device=dev, generator=gen).to(dtype), num_nodes * row_bytes,
            rows * row_bytes + slots * 4 + plan.tile_row_blocks.numel() * 4 + slots * row_bytes, 0)
    if dtype != torch.float32 or plan is not None:
        raise ValueError(f"layout_kernel: {kind} is timed in float32 on the batch's own plan")
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


def one_tile_plan(adj):
    """``adj``'s supertile plan cut to its first tile: the broadcast over it
    is one launch that moves almost nothing, the launch floor."""
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    plan = sk.sum_plan_from_adjacency(adj)
    return sk.AggregationPlan(plan.local_rows[:plan.tile].contiguous(), plan.tile_row_blocks[:1].contiguous(),
                              plan.counts)


def broadcast_width_entries(adj, layout: str, keys, by_path: dict, dev, gen, entry) -> list:
    """K3 on ``adj``'s layout at every (row bytes, dtype name) of ``keys``:
    bitwise equal to its plain version, then timed (``layout_times``) beside
    its one-tile floor (the same harness over the layout's first tile).
    ``by_path``: each path's K3 launches by (row bytes, dtype). Kernels-line
    entries through ``entry``."""
    entries = []
    for row_bytes, dtype_name in sorted(keys):
        dtype = getattr(torch, dtype_name)
        width = row_bytes // torch.empty((), dtype=dtype).element_size()
        k = layout_kernel("broadcast_to_edges", adj, width, dev, gen, dtype)
        table = k.make()
        if not bitwise_equal(k.kernel(table), k.plain(table)):
            raise RuntimeError(f"broadcast kernel != plain version on the {layout} at {width} {dtype_name}")
        floor = layout_kernel("broadcast_to_edges", adj, width, dev, gen, dtype, plan=one_tile_plan(adj))
        launches = {path: widths[(row_bytes, dtype_name)] for path, widths in by_path.items()
                    if widths.get((row_bytes, dtype_name))}
        e = entry("broadcast_to_edges", width, layout_times(k), k, dtype_name)
        e.update(layout=layout, row_bytes=row_bytes, max_abs_err=0.0, floor_ms=layout_times(floor)["ms"],
                 launches_at_width=sum(launches.values()), launches_by_path_at_width=launches)
        phase("kernels", f"{layout} " + json.dumps(e))
        entries.append(e)
    return entries


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
    from ptgnn_tpu_torch.core.trainer import ModelTrainer
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
    forwards, backwards = Tally(), Tally()
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
    steps_counts = train_steps_phase(model, [g2c_minibatch(b) for b in batches], dev, card, name, per_step)
    counts = launch_counts()  # the train path ends here
    for hook in hooks:
        hook.remove()
    expected = {
        k: per_forward[k] * forwards[0] + (per_step[k] - per_forward[k]) * backwards[0]
        + steps_counts[k]
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

    total = 0
    for dtype_name, amp in (("float32", False), ("bf16 AMP", True)):
        steps_module = model.build_neural_module(device=dev, seed=SEED)
        before = launch_counts()
        stats = train_steps(steps_module, minibatches, steps=steps, enable_amp=amp, seed=SEED, **train_kw)
        runs = executions(stats, steps)
        total += runs
        got = {k: v / runs for k, v in delta(launch_counts(), before).items()}
        if got != per_step:
            raise RuntimeError(f"expected {per_step} launches per {name} step, got {got}")
        if not math.isfinite(stats["loss"]):
            raise RuntimeError(f"train_steps ({name}, {dtype_name}) gave a non-finite loss {stats['loss']}")
        phase(name, f"train_steps {dtype_name}: {steps} steps after 1 warm-up, loss {stats['loss']:.6f}, "
              f"{stats['ms_per_step']:.3f} ms/step, {stats['graphs_per_s']:.1f} graphs/s, "
              f"{stats['nodes_per_s']:.0f} nodes/s, {stats['edges_per_s']:.0f} edges/s on {card}; "
              f"launches per step {got}")
    return {k: v * total for k, v in per_step.items()}


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


def segment_sum_routes(model, batches, dev, card, name, steps: int = 10):
    """The float32 train step (train_steps, ``steps`` steps after a warm-up)
    with ops/segment.py's sums, and so the backward of its gathers
    (``take_rows``), on the segment sum kernel over the sorted ids (the
    port's route, the same bits on every run) and, for comparison in this
    one run, on the stock ``index_add_`` that they replaced (atomic
    order)."""
    from ptgnn_tpu_torch.implementations.typilus.harness import train_steps
    from ptgnn_tpu_torch.ops import segment

    class IndexAdd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, data, rows, num_segments):
            ctx.save_for_backward(rows)
            out = data.new_zeros((num_segments + 1, data.shape[1]), dtype=torch.float32)
            return out.index_add_(0, rows.long(), data.float())[:num_segments]

        @staticmethod
        def backward(ctx, g):
            (rows,) = ctx.saved_tensors
            return segment.masked_take(g, rows, 0.0), None, None

    kernel_route = segment._SortedSegmentSum.apply
    ms = {}
    for label, route in (("sort + K1", kernel_route), ("index_add_", IndexAdd.apply),
                         ("sort + K1 again", kernel_route)):
        segment._SortedSegmentSum.apply = route
        try:
            stats = train_steps(model.build_neural_module(device=dev, seed=SEED), batches, steps=steps, seed=SEED,
                                learning_rate=1e-3, clip_gradient_norm=None)
        finally:
            segment._SortedSegmentSum.apply = kernel_route
        ms[label] = stats["ms_per_step"]
    phase(name, f"float32 train step with ops/segment.py's sums and its gathers' backward on the sort + K1 route "
          f"vs the stock index_add_ route they replaced (ms/step over {steps} steps, alternated in this run): "
          f"{ms} on {card}")


def repeat_step_bits(model, device_mb, dev, name):
    """Two float32 train steps (dropout on) from the same weights and seed
    must give the same bits, in PyTorch's default mode: the port's kernels,
    ``ops/segment.py``'s sums and the backward of its gathers
    (``take_rows``) add in a fixed order."""
    from ptgnn_tpu_torch.core.trainer import module_loss

    def run():
        m = model.build_neural_module(device=dev, seed=SEED)
        loss, _ = module_loss(m, device_mb, train=True, generator=torch.Generator(device=dev).manual_seed(SEED))
        loss.backward()
        return [("loss", loss.detach())] + [(n, p.grad) for n, p in m.named_parameters() if p.grad is not None]

    first, second = run(), run()
    differ = [n for (n, a), (_, b) in zip(first, second) if not torch.equal(a, b)]
    if differ:
        raise RuntimeError(f"{name}: a float32 step gave other bits on a second run in {len(differ)} of "
                           f"{len(first)} tensors: {differ}")
    phase(name, f"a float32 train step (dropout on) repeats bit for bit in PyTorch's default mode: the loss "
          f"and all {len(first) - 1} gradient tensors")


def argmax_mixed_features_check(dev):
    """Argmax routing on a feature-tracking batch that holds a featureless
    graph (graphs of 25 and 30 nodes, max, float32): the fused op's output
    and gradients on the card against autograd through a single-winner
    (first slot) per-column max on the CPU, within 1e-5 of each one's max,
    with and without target state. (The JAX package gives such a graph's
    slots one pair id, -1, and its node gradients go wrong; the port numbers
    the pairs apart from the feature slots.)"""
    from ptgnn_tpu_torch.graph.batching import GraphBatcher
    from ptgnn_tpu_torch.graph.structs import BatchPadding, TensorizedGraphData
    from ptgnn_tpu_torch.ops.fused_mp import fused_typed_message_aggregation

    pad = BatchPadding(max_nodes=64, max_edge_slots=16 * 64, max_graphs=4, edge_tile=16, agg_rows=16, agg_sum_tile=0)
    rng = np.random.RandomState(SEED)
    batcher = GraphBatcher(2, pad, introduce_backwards_edges=True, add_self_edges=True, track_edge_features=True)
    mb = batcher.initialize()
    for n, featured in ((25, False), (30, True)):
        adj = [(rng.randint(0, n, 40).astype(np.int32), rng.randint(0, n, 40).astype(np.int32)) for _ in range(2)]
        batcher.extend(TensorizedGraphData(num_nodes=n, node_tensorized_data=[0] * n, adjacency_lists=adj,
                                           edge_features=[0] * 80 if featured else None, reference_nodes={}), mb)
    batch = batcher.finalize(mb, node_data={}, reference_names=[])
    host = batch.to("cpu").adjacency
    card_adj = batch.to(dev).adjacency
    worst = []
    for use_target_state in (True, False):
        states = torch.from_numpy(rng.randn(pad.max_nodes, 8).astype(np.float32))
        weights = torch.from_numpy((rng.randn(batcher.num_edge_types, (16 if use_target_state else 8), 6) * 0.5)
                                   .astype(np.float32))
        cot = torch.from_numpy(rng.randn(pad.max_nodes, 6).astype(np.float32))
        # the oracle on the CPU
        x, w = states.clone().requires_grad_(True), weights.clone().requires_grad_(True)
        senders, receivers = host.senders.long(), host.receivers.long()
        inp = x[senders.clamp(max=pad.max_nodes - 1)]
        if use_target_state:
            inp = torch.cat([inp, x[receivers.clamp(max=pad.max_nodes - 1)]], dim=-1)
        msgs = torch.bmm(inp[:, None, :], w[host.edge_types.long()])[:, 0]
        winners = torch.full((pad.max_nodes, 6), -1, dtype=torch.long)
        with torch.no_grad():
            for node in range(pad.max_nodes):
                slots = torch.nonzero(host.mask & (receivers == node))[:, 0]
                if len(slots):
                    winners[node] = slots[(msgs[slots] == msgs[slots].max(0).values).float().argmax(0)]
        want = msgs.gather(0, winners.clamp_min(0)) * (winners >= 0)
        (want * cot).sum().backward()
        # the card
        xc, wc = states.to(dev).requires_grad_(True), weights.to(dev).requires_grad_(True)
        out = fused_typed_message_aggregation(xc, wc, card_adj, pad.max_nodes, "max", use_target_state,
                                              argmax_routing=True)
        (out * cot.to(dev)).sum().backward()
        for label, got, ref in (("out", out.detach(), want.detach()), ("dx", xc.grad, x.grad), ("dW", wc.grad, w.grad)):
            err = float((got.cpu() - ref).abs().max() / ref.abs().max())
            worst.append(f"{label}{'' if use_target_state else ' (no target state)'} {err:.2e}")
            if err > 1e-5:
                raise RuntimeError(f"argmax routing on the mixed feature batch: {label} off by {err:.3e} of its max")
    phase("argmax-train", f"argmax routing on a feature-tracking batch with a featureless graph (25 + 30 nodes), "
          f"card vs the single-winner oracle on the CPU, within 1e-5 of each max: {', '.join(worst)}")


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
    forwards = Tally()
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
        before, before_forwards = launch_counts(), forwards[0]
        eval_losses[name] = eval_forward_phase(module, batches, card, "ppi-serving", reps, amp)
        per_forward = {k: v / (forwards[0] - before_forwards) for k, v in delta(launch_counts(), before).items()}
        if per_forward != PPI_PER_FORWARD[name]:
            raise RuntimeError(f"expected {PPI_PER_FORWARD[name]} launches per {name} forward, got {per_forward}")
        phase("ppi-serving", f"{name} launches per forward {per_forward}")
    counts = launch_counts()  # the ppi-serving path ends here
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
    forwards, backwards = Tally(), Tally()
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
                for k in launch_counts()}
    got = launch_counts()
    phase("ppi-train", f"ModelTrainer.train (bf16 AMP): 1 epoch over {len(samples)} graphs with validation "
          f"over {len(valid)} before and after in {t_train:.2f} s (host tensorize + batching included): {bw} "
          f"train steps, {fw - bw} validation forwards; validation metrics {valid_metrics}; launches {got}")
    if bw == 0 or not (out_dir / "ppi.pkl.gz").exists():
        raise RuntimeError("ModelTrainer.train took no PPI step or wrote no checkpoint")
    if got != expected:
        raise RuntimeError(f"ModelTrainer.train launches {got} != {expected} expected from {fw} forwards and {bw} backwards")
    if got.typed_dw != PPI_DW_PER_TRAIN_STEP["bf16"] * bw:
        raise RuntimeError(f"ModelTrainer.train launched the typed dW {got.typed_dw} times over {bw} bf16 steps")
    for name, amp in (("float32", False), ("bf16", True)):
        steps_module = model.build_neural_module(device=dev, seed=SEED)
        before = launch_counts()
        stats = train_steps(steps_module, batches, steps=PPI_TRAIN_STEPS, enable_amp=amp, learning_rate=1e-3, seed=SEED)
        runs = executions(stats, PPI_TRAIN_STEPS)
        added = delta(launch_counts(), before)
        per_step = {k: v / runs for k, v in added.items()}
        if per_step != PPI_PER_TRAIN_STEP[name]:
            raise RuntimeError(f"expected {PPI_PER_TRAIN_STEP[name]} launches per {name} PPI step, got {per_step}")
        if added.typed_dw != PPI_DW_PER_TRAIN_STEP[name] * runs:
            raise RuntimeError(f"expected {PPI_DW_PER_TRAIN_STEP[name]} typed dW launches per {name} PPI step, "
                               f"got {added.typed_dw / runs}")
        if not math.isfinite(stats["loss"]):
            raise RuntimeError(f"PPI train_steps ({name}) gave a non-finite loss {stats['loss']}")
        phase("ppi-train", f"train_steps {name}: {PPI_TRAIN_STEPS} steps after 1 warm-up, loss {stats['loss']:.6f}, "
              f"{stats['ms_per_step']:.3f} ms/step, {stats['graphs_per_s']:.2f} graphs/s, "
              f"{stats['nodes_per_s']:.0f} nodes/s, {stats['edges_per_s']:.0f} edges/s on {card}; "
              f"launches per step {per_step}, typed dW {added.typed_dw / runs}")
        expected = add_counts(expected, {k: v * runs for k, v in PPI_PER_TRAIN_STEP[name].items()})
    counts = launch_counts()  # the ppi-train path ends here
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
                       dtypes=((torch.bfloat16, BF16_OPS_PER_S), (torch.float32, F32_OPS_PER_S)), layout="ppi",
                       per_step=PPI_PER_TRAIN_STEP):
    """kernels-line entries of the typed matmul at ``shapes`` (both PPI
    shapes by default) and ``dtypes`` on the ``layout``'s tiles, with its
    launches per bf16 train step of the layout's path (``per_step``, where
    there is a constant for them). Library call: today's bmm route
    (index_select + torch.bmm)."""
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
                "max_abs_err": max_abs_err[f"typed_matmul {din}x{m} {dname}"],
                "ms": times["ms"], "plain_ms": times["plain_ms"],
                "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": times["library_ms"], "shape": [e, din, m, 3], "dtype": dname, "layout": layout,
            }
            if per_step is not None:
                entry[f"launches_per_{layout.replace('-', '_')}_train_step"] = (
                    per_step["bf16"]["typed_matmul"] if dtype == torch.bfloat16 else 0)
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
    argmax_mixed_features_check(dev)
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
    forwards = Tally()
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
    serving = launch_counts()
    if serving != {k: v * forwards[0] for k, v in GGNN_PER_FORWARD.items()}:
        raise RuntimeError(f"expected {GGNN_PER_FORWARD} launches per ggnn forward, got {serving}")
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite ggnn eval losses {losses}")
    phase("ggnn", f"serving forward over {reps * len(batches)} device-resident batches: eval loss "
          f"{float(losses[:len(batches)].mean()):.6f}, {1e3 * elapsed / (reps * len(batches)):.3f} ms/batch, "
          f"{g / elapsed:.1f} graphs/s, {n / elapsed:.0f} nodes/s, {e / elapsed:.0f} edges/s on {card}; "
          f"launches over {forwards[0]} forwards {serving}")
    steps_counts = train_steps_phase(model, [g2c_minibatch(b) for b in batches], dev, card, "ggnn",
                                     GGNN_PER_TRAIN_STEP)
    counts = launch_counts()  # the ggnn path ends here
    expected = add_counts(serving, steps_counts)
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
            before = launch_counts()
            t0 = time.perf_counter()
            out = stdio.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    accuracy = typilus_train.run(typilus_train.build_arg_parser().parse_args(
                        [*folds, str(root / f"{architecture}.pkl.gz"), "--max-num-epochs", "1", "--quiet",
                         "--architecture", architecture]))
            finally:
                os.environ.pop(typilus_train.ARGMAX_ROUTING_ENV, None)
            launched = delta(launch_counts(), before)
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
    counts = launch_counts()  # the cli path ends here
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
    from ptgnn_tpu_torch.core.trainer import ModelTrainer
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
    forwards, backwards = Tally(), Tally()
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
    serving = launch_counts()
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
    counts = launch_counts()  # the varmisuse path ends here
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
    return counts, minibatches, batches, model


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


def compiled_decode(model, module, test, dev, card, batch_graphs, groups, initial_states, reps: int = 5):
    """The decode loops compiled (``GruCopyingDecoderModel.decode_loop``: a
    CUDA graph per signature, its warm-up under sync debug mode "error")
    against the same loops called directly. On one test batch's copy
    groups: the greedy, the sampled (temperature 0.8, the generator
    reseeded before each run) and the beam-G2S_BEAM loops bit for bit (the
    emitted ids, the parents, the scores), each one's ms per loop (the mean
    of ``reps``) and the device's busy share of a profiled run of ``reps``.
    Then ``greedy_decode`` and ``beam_decode`` over the test samples with
    the compiled loops and with the loops called directly: the same tokens
    and log-probabilities exactly, ms per batch (the host pipeline and the
    compiled encoder included) and busy share. Last, the capture s and pool
    MiB of every signature the decode loops and the encoder hold."""
    decoder_model = model.decoder_model
    generator = torch.Generator(device=dev)
    loops = {
        "greedy": (decoder_model.decode_loop("greedy", module.decoder, dev), (groups[0], initial_states, None)),
        "sampled (T 0.8)": (decoder_model.decode_loop("greedy", module.decoder, dev, generator),
                            (groups[0], initial_states, torch.tensor(0.8, device=dev))),
        f"beam-{G2S_BEAM}": (decoder_model.decode_loop("beam", module.decoder, dev),
                             (groups[1], initial_states, G2S_BEAM)),
    }

    def timed(call, count):
        """(ms per call over ``count`` calls, the busy share of a profiled
        run of two, the last call's result)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(count):
            out = call()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / count
        with device_profile() as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return ms, busy_share(prof, wall), out

    t_start = time.perf_counter()

    lines = []
    with torch.inference_mode():
        for label, (loop, args) in loops.items():
            out = {}
            for mode, fn in (("eager", loop.fn), ("compiled", loop), ("compiled again", loop)):
                generator.manual_seed(SEED + 21)
                out[mode] = [t.clone() for t in fn(*args)]
            for mode in ("compiled", "compiled again"):
                if not all(bitwise_equal(a, b) for a, b in zip(out[mode], out["eager"])):
                    raise RuntimeError(f"graph2seq: the {mode} {label} loop != the eager loop")
            (c_ms, c_busy, _), (e_ms, e_busy, _) = (timed(lambda: fn(*args), reps) for fn in (loop, loop.fn))
            lines.append(f"{label} {c_ms:.3f} ms compiled, {e_ms:.3f} eager ({e_ms / c_ms:.2f}x), busy "
                         f"{100 * c_busy:.1f} / {100 * e_busy:.1f} %")
    phase("graph2seq", f"decode loops on the test batch ({decoder_model.max_seq_len} steps), "
          f"compiled against eager: outputs bitwise equal (emitted ids, parents, scores; the sampled loop from "
          f"one reseeded generator); {'; '.join(lines)} on {card}")

    def decode(beam: bool):
        if beam:
            return model.beam_decode(test, module, beam_size=G2S_BEAM, max_minibatch_size=batch_graphs, device=dev)
        return model.greedy_decode(test, module, max_minibatch_size=batch_graphs, device=dev)

    compiled_loop = decoder_model.decode_loop
    batches = -(-len(test) // batch_graphs)
    lines = []
    for beam in (False, True):
        results, ms, busy = {}, {}, {}
        for mode in ("compiled", "eager", "compiled again"):
            if mode == "eager":
                decoder_model.decode_loop = lambda *args, **kwargs: compiled_loop(*args, **kwargs).fn
            try:
                call_ms, busy[mode], results[mode] = timed(lambda: decode(beam), 1)
                ms[mode] = call_ms / batches
            finally:
                decoder_model.__dict__.pop("decode_loop", None)
        if not results["compiled"] == results["eager"] == results["compiled again"]:
            raise RuntimeError(f"graph2seq: {'beam' if beam else 'greedy'} decode with the compiled loops != with "
                               f"the eager loops")
        lines.append(f"{f'beam_decode(beam_size={G2S_BEAM})' if beam else 'greedy_decode'} "
                     + ", ".join(f"{m} {ms[m]:.3f} ms/batch (busy {100 * busy[m]:.1f} %)" for m in ms))
    captures = []
    for cache_name in ("_decode_loops_compiled_cache", "_encoder_compiled_cache"):
        owner = decoder_model if cache_name.startswith("_decode") else model
        for key, entry in owner.__dict__.get(cache_name, {}).items():
            for cap in entry[-1].stats():
                captures.append(f"{key[0] if cache_name.startswith('_decode') else 'encoder'} "
                                f"{cap.seconds:.3f} s, {cap.pool_bytes / 2**20:.1f} MiB")
    phase("graph2seq", f"over the {len(test)} test samples ({batches} batches), the same tokens and "
          f"log-probabilities with the compiled loops as with the eager ones; " + "; ".join(lines)
          + f" on {card}; capture (warm-up included) per signature: {'; '.join(captures)}; these decode "
          f"checks took {time.perf_counter() - t_start:.1f} s")


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
    """The two segment sums of ``ops/segment.py`` in Graph2Seq with the most
    data, each into the batch's 64 graph rows (a stable sort of the ids, then
    K1 over them): the decoder's attention readout ``[M_pad, T, H]`` by
    memory origin, and the summariser's ``[N_pad, heads x 2D]`` by node
    graph. Timed as one call of ``ops.segment.segment_sum`` each, beside
    their bounds (each real element read once, the ids read, the rows
    written)."""
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
    phase("graph2seq", f"ops/segment.py's sums (sort + K1 into {b_pad} rows) on {card}: " + "; ".join(lines))


def graph2seq_phase(dev, card, padding, samples, valid, test, reps: int = 3):
    """Graph2Seq at full width (``create_graph2seq_model()`` defaults,
    ``g2s_padding()``): the host pipeline; serving (greedy and beam-5 decode
    over the test samples, ``test.evaluate``, the eval-loss forward over
    device-resident batches, the decode loops under sync debug mode
    "error", and compiled against eager: :func:`compiled_decode`); training (ModelTrainer.train for an epoch with validation,
    train_steps in float32 and bf16 AMP), with the launches of every part;
    a float32 step (dropout 0) and the greedy decode card against CPU; the
    decoder at the 20,000-token vocabulary cap. Returns (the launch counts
    of the path, the device minibatches)."""
    from ptgnn_tpu_torch.core.trainer import ModelTrainer
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
    forwards, backwards = Tally(), Tally()
    counter = module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    sk.reset_launch_counts()  # the graph2seq path starts here
    # The decode loops, counted as they run (the encoder is compiled: its
    # warm-ups are encodes with no loop after them).
    loop_calls = Tally()
    for loop_name in ("_greedy_loop", "_beam_loop"):
        def counted(*args, _loop=getattr(model.decoder_model, loop_name), **kwargs):
            loop_calls.n += 1
            return _loop(*args, **kwargs)

        setattr(model.decoder_model, loop_name, counted)
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
        before = loop_calls.n
        t0 = time.perf_counter()
        out = fn()
        elapsed = time.perf_counter() - t0
        timings[label] = (out, elapsed, loop_calls.n - before)
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
                                             padding.max_graphs, vocab_size, unk_id)[0] for k in (1, G2S_BEAM)]
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
    compiled_decode(model, module, test, dev, card, padding.max_graphs, groups, initial_states)

    encodes = forwards[0]  # the decode batches', the compiled encoder's warm-ups and the one above
    eval_forward_phase(module, batches, card, name, reps)
    counter.remove()
    for loop_name in ("_greedy_loop", "_beam_loop"):
        delattr(model.decoder_model, loop_name)  # the model is pickled into checkpoints below
    serving = launch_counts()
    loss_forwards, loops = forwards[0] - encodes, loop_calls.n
    want = {k: G2S_PER_ENCODE[k] * encodes + G2S_PER_DECODE_LOOP[k] * loops + G2S_PER_FORWARD[k] * loss_forwards
            for k in serving}
    if serving != want:
        raise RuntimeError(f"{name} serving launches {serving} != {want} expected from {encodes} encodes, "
                           f"{loops} decode loops and {loss_forwards} loss forwards")
    phase(name, f"launches over the serving path's {encodes} encodes, {loops} decode loops and "
          f"{loss_forwards} loss forwards {serving}; the phase so far {time.perf_counter() - t_phase:.1f} s")

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
    counts = launch_counts()  # the graph2seq path ends here
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
    segment_sum_routes(model, batches, dev, card, name)
    repeat_step_bits(model, batches[0], dev, name)
    phase(name, f"phase total {time.perf_counter() - t_phase:.1f} s")
    return counts, batches, model


def graph2seq_kernel_entries(adj, dev, gen, entry):
    """K1 on a Graph2Seq batch's layout (8 edge types, 131,072 slots) at the
    path's width 128: bitwise against its plain version on the CPU (as on
    the VarMisuse layout), then timed beside index_add_; a kernels-line
    entry through ``entry``. K3 on this layout: ``broadcast_width_entries``."""
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
    torch.cuda.synchronize()
    degrees = torch.bincount(adj.receivers[adj.mask].long(), minlength=num_nodes)
    phase("kernels", f"Graph2Seq layout ({e_real} real slots of {e_pad}, {int(adj.tile_types.max()) + 1} types, "
          f"in-degree max {int(degrees.max())}, mean {float(degrees[degrees > 0].float().mean()):.2f}): the sum at "
          f"{width} bitwise equal to its plain version on the CPU (max abs err against the plain version on the "
          f"card {sum_err:.3e})")
    k = layout_kernel("segment_sum", adj, width, dev, gen)
    e = entry("segment_sum", width, layout_times(k), k)
    e.update(layout="Graph2Seq batch", max_abs_err=sum_err, launches_per_forward=G2S_PER_FORWARD["segment_sum"],
             launches_per_train_step=G2S_PER_TRAIN_STEP["segment_sum"])
    phase("kernels", "Graph2Seq layout " + json.dumps(e))
    return [e]


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
        forwards = Tally()
        counter = module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
        sk.reset_launch_counts()  # the layers path starts here
        for amp in (False, True):
            eval_forward_phase(module, mbs, card, name, reps, amp=amp)
        counter.remove()
        serving = launch_counts()
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
        before = launch_counts()
        stats = train_steps(drop, mbs, steps=LAYERS_EDGE_DROPOUT_STEPS, seed=SEED)
        loss, _ = module_loss(drop, mbs[0], train=True, generator=torch.Generator(device=dev).manual_seed(SEED))
        loss.backward()
        steps = executions(stats, LAYERS_EDGE_DROPOUT_STEPS) + 1
        per_step = {k: v / steps for k, v in delta(launch_counts(), before).items()}
        grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in drop.parameters() if p.grad is not None)
        if per_step != LAYERS_PER_EDGE_DROPOUT_STEP or fused:
            raise RuntimeError(f"edge dropout step: launches {per_step} (expected {LAYERS_PER_EDGE_DROPOUT_STEP}), "
                               f"{len(fused)} fused-op calls")
        if not (math.isfinite(stats["loss"]) and math.isfinite(float(loss.detach())) and grads_finite):
            raise RuntimeError(f"edge dropout step: loss {stats['loss']} / {float(loss)}, finite grads {grads_finite}")
        counts = launch_counts()  # the layers path ends here
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
    repeat_step_bits(model, mbs[0], dev, "layers")
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


# K6, the typed dW (csrc/typed_dw.cu), at (tiles, tile, Din, M, types):
# PPI's message layers (a whole batch's 960 tiles), the edge-feature stacks'
# D = 640 and 384, Graph2Class's 64- and 128-wide layers under AMP (17 edge
# types), and the card tests' small cases: Din and M of 128-512, a tile of
# 48 (not a multiple of the 64-row box) and of 32, M = 384 (two column
# blocks), types with no tile.
TYPED_DW_SHAPES = ((960, 128, 512, 256, 3), (960, 128, 640, 256, 3), (960, 128, 384, 256, 3),
                   (384, 128, 128, 64, 17), (384, 128, 256, 128, 17), (40, 128, 128, 128, 3),
                   (30, 48, 256, 512, 4), (50, 32, 512, 128, 3), (20, 128, 256, 384, 5))


def typed_dw_inputs(shape, dev, gen, g_pad: int = 0):
    """bf16 x [E, Din] and g [E, M] (g a view of rows ``M + g_pad`` wide),
    and int32 tile types of ragged shares (type t drawn with weight 2^-t, in
    no order), the last tile's type out of range; with 4 types or more,
    type 1 has no tile."""
    n_tiles, tile, din, m, num_types = shape
    e = n_tiles * tile
    x = torch.randn(e, din, device=dev, generator=gen).bfloat16()
    g = torch.randn(e, m + g_pad, device=dev, generator=gen).bfloat16()[:, :m]
    weights = torch.tensor([2.0 ** -t for t in range(num_types)], device=dev)
    if num_types >= 4:
        weights[1] = 0.0
    tt = torch.multinomial(weights, n_tiles, replacement=True, generator=gen).int()
    tt[-1] = num_types
    return x, g, tt


def typed_dw_reference(x, g, tt, tile, num_types):
    """float64 dW of each type, each element's sum of |x||g|, and each
    type's slot count."""
    rows = tt.long().repeat_interleave(tile)
    ref, scale, slots = [], [], []
    for t in range(num_types):
        sel = torch.nonzero(rows == t)[:, 0]
        xs, gs = x.index_select(0, sel).double(), g.index_select(0, sel).double()
        ref.append(xs.T @ gs)
        scale.append(xs.abs().T @ gs.abs())
        slots.append(sel.numel())
    return torch.stack(ref), torch.stack(scale), slots


def typed_dw_tolerance(scale, slots, tile):
    """A float32 sum of n terms in any order lies within (n - 1) 2^-24 of the
    sum of their magnitudes. The kernel adds each 16-row product of a
    64-row stage to its accumulator (a chain of at most slots / 16 adds,
    16 more inside one wgmma step), then the chunks' partials (at most
    slots / tile of them); the plain version's float32 product chains at
    most slots adds. Each type's bound, times the elements' sums of |x||g|."""
    per_type = torch.tensor([(n / 16 + n / tile + 64) * 2.0 ** -24 for n in slots], dtype=torch.float64,
                            device=scale.device)
    plain = torch.tensor([(n + 64) * 2.0 ** -24 for n in slots], dtype=torch.float64, device=scale.device)
    return per_type[:, None, None] * scale, plain[:, None, None] * scale


def typed_dw_checks(shape, dev, gen) -> float:
    """K6 at ``shape`` against the float64 product of the same bf16 operands
    (and its plain version too), within the bounds of
    ``typed_dw_tolerance``; zeros for a type with no tile; the same bits on
    a second run, from a row-strided g read in place, and replayed from a
    CUDA graph on new inputs. Returns the largest |kernel - plain|."""
    from ptgnn_tpu_torch.ops import typed_linear as ttl

    n_tiles, tile, din, m, num_types = shape
    x, g, tt = typed_dw_inputs(shape, dev, gen, g_pad=8)
    got = ttl.typed_dw_kernel(x, g, tt, tile, num_types)
    plain = ttl.typed_weight_gradient_plain(x, g, tt, tile, num_types)
    ref, scale, slots = typed_dw_reference(x, g, tt, tile, num_types)
    tol_kernel, tol_plain = typed_dw_tolerance(scale, slots, tile)
    for which, out, tol in (("kernel", got, tol_kernel), ("plain version", plain, tol_plain)):
        if out.dtype != torch.float32 or bool(((out.double() - ref).abs() > tol).any()):
            worst = float(((out.double() - ref).abs() / tol.clamp_min(1e-300)).max())
            raise RuntimeError(f"typed dW {which} off float64 at {shape} ({worst:.3g} x its bound)")
    for t, n in enumerate(slots):
        if n == 0 and bool(got[t].any()):
            raise RuntimeError(f"typed dW of type {t}, which has no tile, is not zero at {shape}")
    if not bitwise_equal(got, ttl.typed_dw_kernel(x, g, tt, tile, num_types)):
        raise RuntimeError(f"typed dW gave other bits on a second run at {shape}")
    if not bitwise_equal(got, ttl.typed_dw_kernel(x, g.contiguous(), tt, tile, num_types)):
        raise RuntimeError(f"typed dW of a row-strided g differs from that of its copy at {shape}")
    x2, g2, _ = typed_dw_inputs(shape, dev, gen)
    static_x, static_g = x.clone(), g.contiguous()
    ttl.typed_dw_kernel(static_x, static_g, tt, tile, num_types)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ttl.typed_dw_kernel(static_x, static_g, tt, tile, num_types)
    static_x.copy_(x2)
    static_g.copy_(g2)
    graph.replay()
    torch.cuda.synchronize()
    if not bitwise_equal(captured, ttl.typed_dw_kernel(x2, g2, tt, tile, num_types)):
        raise RuntimeError(f"typed dW replayed from a CUDA graph differs from the eager call at {shape}")
    return float((got - plain).abs().max())


def typed_dw_entry(shape, dev, gen, max_abs_err, launches: int, launches_by_path: dict) -> dict:
    """The kernels-line entry of K6 at ``shape``: its time (a CUDA graph of
    16 launches over inputs rotated past the L2), its bound (x and g read,
    dW written, once; 2 E Din M operations at the bf16 peak), its plain
    version's, the library call it replaces (the per-type masked float32
    torch.matmul products of the operands cast up, ``library_ms``), and the
    route the fused op's backward took at this shape before K6
    (``replaced_ms``: those products, or the per-tile float32 bmm and its
    one-hot type sum, by ``fused_mp._use_masked_dw_route``)."""
    from ptgnn_tpu_torch.ops import fused_mp
    from ptgnn_tpu_torch.ops import typed_linear as ttl

    n_tiles, tile, din, m, num_types = shape
    e = n_tiles * tile
    _, _, tt = typed_dw_inputs(shape, dev, gen)
    pairs = rotating(lambda: typed_dw_inputs(shape, dev, gen)[:2], e * (din + m) * 2)

    def calls(fn):
        return [lambda p=pairs[i % len(pairs)]: fn(*p) for i in range(16)]

    def masked(x, g):
        rows = tt.long().repeat_interleave(tile)
        xf, gf = x.float(), g.float()
        return torch.stack([xf.T @ (gf * (rows == t)[:, None]) for t in range(num_types)])

    def per_tile(x, g):
        per = torch.bmm(x.float().reshape(n_tiles, tile, din).transpose(1, 2), g.float().reshape(n_tiles, tile, m))
        onehot = (torch.arange(num_types, device=dev)[:, None] == tt.long()[None, :]).float()
        return (onehot @ per.reshape(n_tiles, din * m)).reshape(num_types, din, m)

    times = {
        "ms": graph_time_ms(calls(lambda x, g: ttl.typed_dw_kernel(x, g, tt, tile, num_types))),
        "plain_ms": graph_time_ms(calls(lambda x, g: ttl.typed_weight_gradient_plain(x, g, tt, tile, num_types))),
        "library_ms": graph_time_ms(calls(masked)),
    }
    masked_route = fused_mp._use_masked_dw_route(n_tiles, e, din, m, num_types, 2)
    times["replaced_ms"] = times["library_ms"] if masked_route else graph_time_ms(calls(per_tile))
    del pairs
    nbytes = e * (din + m) * 2 + num_types * din * m * 4 + n_tiles * 4
    entry = {
        "name": "typed_dw", "route": "cuda", "source": "ptgnn_tpu_torch/csrc/typed_dw.cu",
        "replaces": "the per-type masked float32 products (ops/fused_mp.py::_weight_gradient, "
                    "ops/typed_linear.py::_TypedMatmul.backward)",
        "launches": launches, "launches_by_path": launches_by_path, "max_abs_err": max_abs_err,
        **times, **bound(nbytes, 2 * e * din * m, BF16_OPS_PER_S),
        "replaced_route": "masked" if masked_route else "per-tile", "shape": list(shape), "dtype": "bfloat16",
    }
    entry["chunk_len"], entry["partial_slots"] = ttl.typed_dw_plan(
        n_tiles, tile, din, m, num_types, torch.cuda.get_device_properties(dev).multi_processor_count)
    phase("kernels", json.dumps(entry))
    return entry


def typed_dw_phase(dev, shapes, launches_by_path=None) -> list:
    """K6 checked at every shape of ``shapes`` and timed there beside its
    bound, its plain version, the library call and the route it replaced;
    raises where it is not faster than the replaced route (its gate opens
    at these shapes)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    launches_by_path = launches_by_path or {}
    entries, slower = [], []
    for shape in shapes:
        err = typed_dw_checks(shape, dev, gen)
        by_path = {path: n for path, n in ((p, c.get(shape, 0)) for p, c in launches_by_path.items()) if n}
        e = typed_dw_entry(shape, dev, gen, err, sum(by_path.values()), by_path)
        entries.append(e)
        if e["ms"] >= e["replaced_ms"]:
            slower.append((shape, e["ms"], e["replaced_ms"]))
    torch.cuda.synchronize()
    phase("typed-dw", f"K6 within its float32 bounds of float64 (the plain version too), zeros for a type with no "
          f"tile, bitwise from run to run, from a row-strided g and in a CUDA graph replay, at {list(shapes)}")
    if slower:
        raise RuntimeError(f"K6 is not faster than the route it replaced at (shape, ms, replaced ms) {slower}")
    return entries


def typed_dw_main() -> None:
    """``chip_smoke.py --typed-dw``: build, K6's registers, its checks and
    timings at TYPED_DW_SHAPES."""
    from ptgnn_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    phase("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}; torch {torch.__version__}")
    build_s = cuda_build.build_all()
    phase("build", f"{build_s:.2f} s for {sorted(cuda_build.BUILD_LOG) or 'nothing (cached)'}")
    for line in cuda_build.BUILD_LOG.get("typed_dw", "").splitlines():
        if "Used" in line or "spill" in line:
            phase("build", f"typed_dw: {line.strip()}")
    entries = typed_dw_phase(dev, TYPED_DW_SHAPES)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


# K7, the keyed dropout (csrc/keyed_dropout.cu), by (E, C, column offset,
# tile, dtype): the Graph2Seq benchmark's message-input block, 131,072 slots
# of 128 columns, in the forward orientation (a type a slot) and the
# transpose one (a type a 128-slot tile), float32 and bf16.
KEYED_DROPOUT_SHAPES = tuple((131072, 128, 0, tile, dtype) for dtype in ("float32", "bfloat16") for tile in (1, 128))
KEYED_DROPOUT_KEEP = 0.9


def keyed_dropout_inputs(shape, dev, gen):
    """x [E, C] of the shape's dtype, and the edge ids of a 16,384-node
    padding: int32 endpoints (padding ids 0, 16384 and a negative one among
    them) and a type a tile of the shape's slots."""
    from ptgnn_tpu_torch.ops import keyed_dropout as kd

    e, c, _, tile, dtype = shape
    x = torch.randn(e, c, device=dev, generator=gen).to(getattr(torch, dtype))
    src, dst = (torch.randint(0, 16384, (e,), device=dev, generator=gen, dtype=torch.int32) for _ in range(2))
    src[:3] = torch.tensor([0, 16384, -1], device=dev, dtype=torch.int32)[:e]
    types = torch.randint(0, 8, (e // tile,), device=dev, generator=gen, dtype=torch.int32)
    return x, kd.EdgeIds(src, dst, types, tile)


def keyed_dropout_err(x, seed, ids, col_offset: int) -> float:
    """The largest |K7 - its plain version| at x, ``seed`` and ``col_offset``;
    raises unless the two are equal bit for bit."""
    from ptgnn_tpu_torch.ops import keyed_dropout as kd

    got = kd.keyed_dropout_kernel(x, seed, ids, KEYED_DROPOUT_KEEP, col_offset)
    want = kd.keyed_dropout_plain(x, seed, ids, KEYED_DROPOUT_KEEP, col_offset)
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if not bitwise_equal(got, want):
        raise RuntimeError(f"K7 differs from its plain version by up to {err} at {tuple(x.shape)} {x.dtype}, tile "
                           f"{ids.tile}, seed {int(seed)}, column offset {col_offset}")
    return err


def keyed_dropout_checks(shape, dev, gen) -> float:
    """K7 bitwise its plain version at ``shape`` (its column offset and
    tile) for seeds 0, 2^31 + 5 and 2^32 - 1; the largest |difference|."""
    x, ids = keyed_dropout_inputs(shape, dev, gen)
    return max(keyed_dropout_err(x, torch.tensor(seed, dtype=torch.int64, device=dev), ids, shape[2])
               for seed in (0, 2**31 + 5, 2**32 - 1))


def keyed_dropout_entry(shape, dev, gen, max_abs_err: float, launches_by_path: dict) -> dict:
    """The kernels-line entry of K7 at ``shape``: its time (a CUDA graph of
    16 launches over inputs rotated past the L2), its bound (x read and the
    output written once, three 4-byte ids a row), and its plain version's,
    the int64 composition the fused op ran before K7. ``max_abs_err`` is
    the largest |K7 - plain| of the checks and of the timed inputs."""
    from ptgnn_tpu_torch.ops import keyed_dropout as kd

    e, c, col_offset, tile, dtype = shape
    esize = getattr(torch, dtype).itemsize
    _, ids = keyed_dropout_inputs(shape, dev, gen)
    xs = rotating(lambda: keyed_dropout_inputs(shape, dev, gen)[0], e * c * esize)
    seed = torch.tensor(2**31 + 5, dtype=torch.int64, device=dev)
    max_abs_err = max(max_abs_err, keyed_dropout_err(xs[0], seed, ids, col_offset))

    def calls(fn):
        return [lambda x=xs[i % len(xs)]: fn(x, seed, ids, KEYED_DROPOUT_KEEP, col_offset) for i in range(16)]

    times = {"ms": graph_time_ms(calls(kd.keyed_dropout_kernel)),
             "plain_ms": graph_time_ms(calls(kd.keyed_dropout_plain))}
    del xs
    entry = {
        "name": "keyed_dropout", "route": "cuda", "source": "ptgnn_tpu_torch/csrc/keyed_dropout.cu",
        "replaces": "the int64 PyTorch mask and select (ops/keyed_dropout.py::keyed_dropout_plain)",
        "launches": sum(launches_by_path.values()), "launches_by_path": launches_by_path,
        "max_abs_err": max_abs_err, **times, **bound(2 * e * c * esize + 3 * e * 4, 0), "shape": [e, c],
        "col_offset": col_offset, "tile": tile, "dtype": dtype,
    }
    phase("kernels", json.dumps(entry))
    return entry


def keyed_dropout_phase(dev, shapes, launches_by_path=None) -> list:
    """K7 checked bitwise against its plain version and timed beside it at
    every (E, C, column offset, tile, dtype) of ``shapes``; raises where it
    is not faster than the plain version."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    launches_by_path = launches_by_path or {}
    entries = []
    for shape in shapes:
        err = keyed_dropout_checks(shape, dev, gen)
        by_path = {path: n for path, n in ((p, c.get(shape, 0)) for p, c in launches_by_path.items()) if n}
        entries.append(keyed_dropout_entry(shape, dev, gen, err, by_path))
    torch.cuda.synchronize()
    phase("keyed-dropout", f"K7 bitwise its plain version at (E, C, column offset, tile, dtype) {list(shapes)}, "
          "seeds 0, 2^31 + 5 and 2^32 - 1")
    slower = [(e["shape"], e["col_offset"], e["tile"], e["dtype"], e["ms"], e["plain_ms"])
              for e in entries if e["ms"] >= e["plain_ms"]]
    if slower:
        raise RuntimeError(f"K7 is not faster than its plain version at (shape, column offset, tile, dtype, ms, "
                           f"plain ms) {slower}")
    return entries


def keyed_dropout_main() -> None:
    """``chip_smoke.py --keyed-dropout``: build, K7's registers, its checks
    and timings at KEYED_DROPOUT_SHAPES."""
    from ptgnn_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    phase("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}; torch {torch.__version__}")
    build_s = cuda_build.build_all()
    phase("build", f"{build_s:.2f} s for {sorted(cuda_build.BUILD_LOG) or 'nothing (cached)'}")
    for line in cuda_build.BUILD_LOG.get("keyed_dropout", "").splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            phase("build", f"keyed_dropout: {line.strip()}")
    entries = keyed_dropout_phase(dev, KEYED_DROPOUT_SHAPES)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


SANITIZER_TOOLS = ("memcheck", "racecheck", "synccheck")


def sanitizer_target() -> None:
    """What compute-sanitizer runs (``chip_smoke.py --sanitizer-target``):
    every kernel once at a small size, on a layout with a row that the row
    reductions split into pieces, then a synchronise."""
    from ptgnn_tpu_torch.graph.batching import _assemble_layout_python
    from ptgnn_tpu_torch.ops import keyed_dropout as kd
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
    ttl.typed_dw_kernel(torch.randn(4096, 128, device=dev, generator=g).bfloat16(),
                        torch.randn(4096, 256, device=dev, generator=g).bfloat16(), tile_types, 32, 3)
    for dtype in ("float32", "bfloat16"):
        x, ids = keyed_dropout_inputs((4096, 40, 3, 32, dtype), dev, g)
        kd.keyed_dropout_kernel(x, torch.tensor(5, device=dev), ids, KEYED_DROPOUT_KEEP, 3)
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
            forwards = Tally()
            counter = module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
            for amp in (False, True):
                dtype = "bf16" if amp else "float32"
                before, n0 = launch_counts(), forwards[0]
                eval_forward_phase(module, mbs, card, f"{name} {stack}", reps, amp=amp)
                got = delta(launch_counts(), before)
                want = {k: v * (forwards[0] - n0) for k, v in EDGE_PER_FORWARD[dtype].items()}
                if got != want:
                    raise RuntimeError(f"{stack} {dtype} eval forwards launched {got}, expected {want}")
                checks.append(f"{stack} {dtype} forward")
            counter.remove()
            for amp in (False, True):
                dtype = "bf16" if amp else "float32"
                steps_module = model.build_neural_module(device=dev, seed=SEED)
                before = launch_counts()
                stats = train_steps(steps_module, mbs, steps=EDGE_TRAIN_STEPS, enable_amp=amp, seed=SEED)
                per_step = {k: v / executions(stats, EDGE_TRAIN_STEPS)
                            for k, v in delta(launch_counts(), before).items()}
                if per_step != EDGE_PER_TRAIN_STEP[stack][dtype]:
                    raise RuntimeError(f"{stack} {dtype} step launched {per_step}, expected "
                                       f"{EDGE_PER_TRAIN_STEP[stack][dtype]}")
                if not math.isfinite(stats["loss"]):
                    raise RuntimeError(f"{stack} {dtype} train_steps gave a non-finite loss {stats['loss']}")
                phase(name, f"{stack} stack train_steps {'bf16 AMP' if amp else 'float32'}: {EDGE_TRAIN_STEPS} steps "
                      f"after 1 warm-up, loss {stats['loss']:.4f}, {stats['ms_per_step']:.3f} ms/step, "
                      f"{stats['nodes_per_s']:.0f} nodes/s, {stats['edges_per_s']:.0f} edges/s on {card}; launches "
                      f"per step {per_step}")
                checks.append(f"{stack} {dtype} step")
            if not gated:
                first = (model, minibatches[0], mbs[0])
    counts = launch_counts()  # the edge-features path ends here
    phase(name, f"launches over the edge-features path {counts}, each forward and step as counted "
          f"({checks}); fused-op calls {len(fused)}")
    if fused:
        raise RuntimeError(f"{len(fused)} fused-op calls on the edge-feature path")
    edge_features_against_cpu(*first, dev)
    segment_sum_routes(first[0], [first[2]], dev, card, f"{name} mlp")
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
    forwards = Tally()
    counter = module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    sk.reset_launch_counts()  # the bpe path starts here
    eval_forward_phase(module, mbs, card, name, reps)
    counts = launch_counts()  # the bpe path ends here
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


def data_parallel_phase(dev, card, model, batches, epochs):
    """DistributedModelTrainer at world size 1 over NCCL (a ``file://``
    rendezvous), ZeRO-1 on, at the benchmark configuration, for one
    shuffled epoch of about DP_STEPS optimizer steps, against ModelTrainer's
    same epoch from the same seed (node 0 keeps its shuffle order): every parameter within 1e-6 of its tensor's largest magnitude
    (and whether bitwise equal), the all-reduce calls and bytes per
    execution of the compiled step, and the launches of the trainer's
    forwards and steps (each execution: the DDP warm-ups and the replays).
    Then the distributed Typilus CLI with ``--world-size 1`` for one epoch
    on synthetic folds, and the compiled steps against eager
    (:func:`dp_compiled_checks`). Returns the launch counts of the path."""
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
    from ptgnn_tpu_torch.parallel.dp import DDP_WARMUP_CALLS
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
        forwards, backwards, traffic = Tally(), Tally(), {}
        hooks = [module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1)),
                 module.node_to_class.weight.register_hook(lambda g: backwards.__setitem__(0, backwards[0] + 1))]
        # read at the epoch's end: train() frees the compiled steps' graphs as it returns
        trainer.register_train_epoch_end_hook(lambda *_: traffic.update(
            calls=trainer.data_parallel.allreduce_calls, bytes=trainer.data_parallel.allreduce_bytes,
            captures=len(trainer.data_parallel.train_step_compiled)))
        optimizers = []
        trainer.register_training_start_hook(lambda model, module, optimizer: optimizers.append(optimizer))
        sk.reset_launch_counts()  # the data-parallel path starts here
        t0 = time.perf_counter()
        trainer.train(train_graphs, valid_graphs, initialize_metadata=False, **run)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        trainer_counts = launch_counts()
        for hook in hooks:
            hook.remove()
        moments = moment_elements(optimizers[0])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    steps = (trainer._opt_steps_this_epoch, single._opt_steps_this_epoch)
    # the compiled train step ran its DDP warm-ups once, then a replay a step
    executions = dp_steps + DDP_WARMUP_CALLS * traffic["captures"]
    if steps != (dp_steps, dp_steps) or backwards[0] != executions or dp_steps < 2:
        raise RuntimeError(f"optimizer steps (distributed, single) {steps}, backwards {backwards[0]}: expected "
                           f"{dp_steps} steps and {executions} executions")
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
          f"{bitwise}; train + validation {t_train:.2f} s (ModelTrainer {t_single:.2f} s); all-reduces over the "
          f"{executions} executions of the train step ({DDP_WARMUP_CALLS} DDP warm-ups, {dp_steps} replays) "
          f"{traffic.get('calls', 0) / executions:.2f} calls and {traffic.get('bytes', 0) / executions:.0f} bytes "
          f"per execution; launches {trainer_counts} from {forwards[0]} forwards and {backwards[0]} steps")

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
    before = launch_counts()
    t0 = time.perf_counter()
    try:
        out = stdio.StringIO()
        with contextlib.redirect_stdout(out):
            accuracy = traindistributed.run(traindistributed.build_arg_parser().parse_args(
                [*folds, str(root / "dist.pkl.gz"), "--max-num-epochs", "1", "--max-nodes", "8192",
                 "--world-size", "1", "--quiet"]))
    finally:
        os.chdir(cwd)
    cli = delta(launch_counts(), before)
    line = [ln for ln in out.getvalue().splitlines() if ln.startswith("Test accuracy:")]
    if not line or accuracy is None or not 0.0 <= accuracy <= 1.0 or not (root / "dist.pkl.gz").exists():
        raise RuntimeError(f"traindistributed printed {line}, returned {accuracy}")
    if min(cli[k] for k in ("segment_extremum", "broadcast_to_edges", "segment_sum")) <= 0:
        raise RuntimeError(f"the distributed CLI run missed a kernel: {cli}")
    phase(name, f"traindistributed --world-size 1 (NCCL, ZeRO-1): 1 epoch over 12 graphs in "
          f"{time.perf_counter() - t0:.2f} s; '{line[0]}'; launches {cli}")
    before = launch_counts()
    world_one(lambda: dp_compiled_checks(dev, card, model, batches, epochs))
    compiled_counts = delta(launch_counts(), before)
    counts = add_counts(add_counts(trainer_counts, cli), compiled_counts)  # the data-parallel path ends here
    phase(name, f"launches over the data-parallel path {counts}; the 4-rank path runs under --world 4 on four "
          f"cards and on the CPU over gloo (tests/test_torch_multicard.py); phase total "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


DP_EPOCH_GRAPHS = 30  # about 10 benchmark batches


DP_EPOCH_MINIBATCH = 300  # dp_epoch's samples a minibatch


def dp_epoch(model, train, valid, dev, *, zero1: bool, accumulate: int, eager_steps: bool, name: str,
             epochs: int = 1, slot_digests: list | None = None, **train_kw):
    """``epochs`` DistributedModelTrainer epochs (``model``: the benchmark
    Graph2Class model with its metadata; dropout 0.1, Adam with the clip)
    over ``train``, each followed by validation, its steps compiled or
    (``eager_steps``) called directly; the host pipeline sequential unless
    ``train_kw`` (more ``train`` arguments) says otherwise. Returns the
    step losses, the parameters, Adam's state, the validation metrics, the
    seconds of the first epoch (its captures included) and of each epoch
    (``epoch_seconds``: a later epoch from the end of the one before, its
    validation and checkpoint, to its last step), the compiled train
    step's graphs at each epoch's end (``graphs``), the trainer's
    ``handoff_stats`` at the end and at each epoch's end (``handoffs``),
    and the data-parallel steps. ``slot_digests`` gets the ``host_digest``
    of this rank's host minibatch of the first WORLD_DIGEST_GROUPS groups
    of the first training pass."""
    from ptgnn_tpu_torch.core.compiled_step import CompiledStep
    from ptgnn_tpu_torch.parallel import DistributedModelTrainer

    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / "dp-epochs"
    trainer = DistributedModelTrainer(
        model, out_dir / f"{name}.pkl.gz",
        zero1=zero1, gradient_accumulation_steps=accumulate, max_num_epochs=epochs, minibatch_size=DP_EPOCH_MINIBATCH,
        clip_gradient_norm=1.0, optimizer_creator=lambda p: torch.optim.Adam(p, lr=2.5e-4), device=dev, seed=SEED,
        target_validation_metric="Accuracy", target_validation_metric_higher_is_better=True)
    trainer.load_metadata_and_create_network(train, parallelize=False)
    dp = trainer.data_parallel
    if eager_steps:
        eager_dp(dp)
    losses, optimizers, marks, metrics = [], [], {}, []
    for method in ("train_step", "grad_step"):
        def recorded(*args, _call=getattr(dp, method), **kwargs):
            out = _call(*args, **kwargs)
            losses.append(float(out[0]))
            return out

        setattr(dp, method, recorded)
    seconds, graphs, handoffs = [], [], []
    if slot_digests is not None:
        real_groups = trainer.group_minibatches

        def group_minibatches(*args, **kwargs):
            groups = real_groups(*args, **kwargs)
            if trainer.group_minibatches is group_minibatches:  # the first pass: record, then stop wrapping
                trainer.group_minibatches = real_groups
                for g, item in enumerate(groups):
                    if g < WORLD_DIGEST_GROUPS:
                        slot_digests.append(host_digest(item[0]))
                    yield item
            else:
                yield from groups

        trainer.group_minibatches = group_minibatches

    def epoch_end(*_):
        synchronize()
        seconds.append(time.perf_counter() - marks["start"])
        graphs.append(len(dp.train_step_compiled) if isinstance(dp.train_step_compiled, CompiledStep) else 0)
        handoffs.append(trainer.handoff_stats)

    def validation_end(m, mod, ep, valid_metrics):
        metrics.append(valid_metrics)
        marks["start"] = time.perf_counter()

    trainer.register_training_start_hook(lambda model, module, optimizer: (
        optimizers.append(optimizer), marks.__setitem__("start", time.perf_counter())))
    trainer.register_train_epoch_end_hook(epoch_end)
    trainer.register_validation_epoch_end_hook(validation_end)
    # the checkpoint of an improved epoch is written after validation
    trainer.register_epoch_improved_end_hook(lambda *_: marks.__setitem__("start", time.perf_counter()))
    trainer.train(train, valid, initialize_metadata=False, validate_on_start=False, patience=epochs,
                  **{"parallelize": False, **train_kw})
    synchronize()
    return {"losses": losses, "state": {**{f"param {k}": v.detach().clone()
                                           for k, v in trainer.neural_module.named_parameters()},
                                        **adam_state(optimizers[0])},
            "metrics": metrics, "seconds": seconds[0], "epoch_seconds": seconds, "graphs": graphs,
            "handoffs": handoffs, "handoff": trainer.handoff_stats, "dp": dp}


def dp_compiled_checks(dev, card, model, batches, epochs):
    """The data-parallel steps compiled against eager at world 1 (NCCL):
    DataParallel's train step (ZeRO-1, Adam) COMPILED_STEPS steps from the
    same weights and seeds with a weight and a learning-rate factor that
    change every step, bit for bit (losses, every parameter, both Adam
    moments), its ms/step (median of TIMED_RUNS runs of TIMED_STEPS) and
    the device's busy share, capture s and pool MiB; then
    DistributedModelTrainer epochs of about 10 steps, with and without
    ZeRO-1, at gradient accumulation 1 and 2, compiled against eager: the
    step losses, every parameter, both Adam moments and the validation
    metrics bit for bit."""
    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model, default_padding
    from ptgnn_tpu_torch.parallel.dp import DDP_WARMUP_CALLS

    name = "data-parallel"
    t_start = time.perf_counter()
    g2c_mbs = [g2c_minibatch(b) for b in batches]
    runs = {mode: dp_step_runs(model, g2c_mbs, dev, compiled=mode == "compiled") for mode in ("eager", "compiled")}
    verdict = held_to_eager("DataParallel train step", runs["compiled"], runs["eager"])
    e, c = runs["eager"], runs["compiled"]
    captures = "; ".join(f"{cap.seconds:.3f} s, {cap.pool_bytes / 2**20:.1f} MiB" for cap in c["captures"])
    phase(name, f"DataParallel train step (world 1, NCCL, ZeRO-1 Adam, clip 1.0, dropout on): {COMPILED_STEPS} "
          f"steps compiled against eager, the weight and lr_factor changing every step, {verdict}; ms/step "
          f"(median of {TIMED_RUNS} runs of {TIMED_STEPS}) compiled {c['ms']:.3f} {[round(t, 3) for t in c['times']]}, "
          f"eager {e['ms']:.3f} {[round(t, 3) for t in e['times']]} ({e['ms'] / c['ms']:.2f}x); device busy "
          f"{100 * c['busy']:.1f} % compiled, {100 * e['busy']:.1f} % eager (profiled run); capture (its "
          f"{DDP_WARMUP_CALLS} DDP warm-ups included) {captures} on {card}")
    train, valid = epochs
    train = train[:DP_EPOCH_GRAPHS]
    epoch_model = create_graph2class_gnn_model(hidden_state_size=64, padding=default_padding())
    epoch_model.compute_metadata(iter(train), parallelize=False)  # once, for the eight trainers
    lines = []
    for zero1 in (True, False):
        for k in (1, 2):
            got = {mode: dp_epoch(epoch_model, train, valid, dev, zero1=zero1, accumulate=k,
                                  eager_steps=mode == "eager", name=f"dp-{zero1}-{k}-{mode}")
                   for mode in ("compiled", "eager")}
            a, b = got["compiled"], got["eager"]
            apart = [key for key in b["state"] if not bitwise_equal(a["state"][key], b["state"][key])]
            if a["losses"] != b["losses"] or apart or a["metrics"] != b["metrics"] or len(a["losses"]) < 8:
                raise RuntimeError(f"{name}: DistributedModelTrainer (ZeRO-1 {zero1}, accumulation {k}) compiled "
                                   f"!= eager: losses {a['losses']} / {b['losses']}, tensors apart {apart[:6]}")
            for run in got.values():
                run["dp"].clear()
            lines.append(f"ZeRO-1 {zero1}, accumulation {k}: {len(a['losses'])} microbatches, {len(b['state'])} "
                         f"tensors and the validation metrics bitwise equal, epoch {a['seconds']:.3f} s compiled, "
                         f"{b['seconds']:.3f} s eager")
    phase(name, "DistributedModelTrainer epochs (world 1, NCCL) compiled against eager: " + "; ".join(lines)
          + f" on {card}; these checks took {time.perf_counter() - t_start:.1f} s")


EP_SHARDS = 4
EP_STEPS = 3
NP_SHARDS = (2, 4)
NP_STEPS = 3


def world_one(fn):
    """``fn()`` inside a one-rank NCCL process group (a ``file://``
    rendezvous in a temporary directory), destroyed after."""
    import tempfile

    import torch.distributed as dist

    from ptgnn_tpu_torch.parallel import initialize_multi_host

    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_world_")
    initialize_multi_host("nccl", f"file://{rendezvous}/store", world_size=1, rank=0)
    try:
        return fn()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)


def held_steps(single, sharded, single_mbs, sharded_mbs, sharded_step, steps: int, lr: float = 0.05):
    """``steps`` SGD steps of the single-device module (``plain_step``) and
    of the sharded one (``sharded_step(minibatch, optimizer, generator)``),
    each step from equal weights (the single module's, copied into the
    sharded one first), so that routes which round apart cannot drift apart
    over the steps. Returns (single losses, sharded losses, the worst
    distance between the stepped parameters over each one's largest
    magnitude, its name, whether every step was bitwise equal, the ms of a
    sharded and of a single-device step, the sharded steps' launches)."""
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    opt_single = torch.optim.SGD(single.parameters(), lr=lr)
    opt_sharded = torch.optim.SGD(sharded.parameters(), lr=lr)
    device = next(single.parameters()).device
    losses, sharded_losses, worst, where, bitwise, elapsed, elapsed_single = [], [], 0.0, "", True, 0.0, 0.0
    launches = {k: 0 for k in launch_counts()}
    for i in range(steps):
        sharded.load_state_dict(single.state_dict())
        synchronize()
        t0 = time.perf_counter()
        losses.append(float(plain_step(single)(single_mbs[i], opt_single,
                                               torch.Generator(device=device).manual_seed(SEED + i))))
        synchronize()
        elapsed_single += time.perf_counter() - t0
        before = launch_counts()
        t0 = time.perf_counter()
        sharded_losses.append(float(sharded_step(sharded_mbs[i], opt_sharded,
                                                 torch.Generator(device=device).manual_seed(SEED + i))))
        synchronize()
        elapsed += time.perf_counter() - t0
        launches = add_counts(launches, delta(launch_counts(), before))
        err, name, same = params_apart(single, sharded)
        bitwise &= same
        if err > worst:
            worst, where = err, name
    return losses, sharded_losses, worst, where, bitwise, (1e3 * elapsed / steps, 1e3 * elapsed_single / steps), launches


def plain_step(module):
    """One single-device SGD step of ``module`` (ModelTrainer's: the module's
    loss, its backward, ``optimizer_step``)."""
    from ptgnn_tpu_torch.core.trainer import module_loss, optimizer_step

    def step(mb, optimizer, generator):
        loss, _ = module_loss(module, mb, train=True, generator=generator)
        loss.backward()
        optimizer_step(module, optimizer, [g["lr"] for g in optimizer.param_groups])
        return loss.detach()

    return step


SHARDED_TIMED = (3, 10)  # the sharded steps' timed runs: their count and length


def sharded_compiled_against_eager(model, local, dev, make_sharder, timed=SHARDED_TIMED) -> tuple:
    """A sharded train step (``make_sharder(module)``: EdgeParallel or
    NodeParallel) through DataParallel's compiled train step against the
    same step called eagerly: COMPILED_STEPS Adam steps from the model's
    seeded weights on the device-resident shards ``local``, the rate
    changing every step, bit for bit (raises beyond rtol 1e-6); and each
    one's ms/step and busy share (``timed``: the timed runs' count and
    length, None for none). Returns the line to print and the verdict."""
    t_start = time.perf_counter()

    def make(module):
        sharder = make_sharder(module)
        return (lambda mb, optimizer: sharder.train_step(mb, optimizer)), sharder.data_parallel

    runs = {mode: dp_step_runs(model, local, dev, compiled=mode == "compiled", zero1=False, make=make,
                               timed=timed) for mode in ("eager", "compiled")}
    e, c = runs["eager"], runs["compiled"]
    verdict = held_to_eager("sharded train step", c, e)
    if dev.type != "cuda":
        return f"{COMPILED_STEPS} steps compiled (a plain call here) against eager {verdict}", verdict, c
    captures = "; ".join(f"{cap.seconds:.3f} s, {cap.pool_bytes / 2**20:.1f} MiB" for cap in c["captures"])
    if len(c["captures"]) != 1:
        raise RuntimeError(f"the sharded train step took {len(c['captures'])} signatures, not one")
    return (f"{COMPILED_STEPS} steps compiled against eager {verdict}; ms/step (median of {timed[0]} runs "
            f"of {timed[1]}) compiled {c['ms']:.3f} {[round(t, 3) for t in c['times']]}, eager {e['ms']:.3f} "
            f"{[round(t, 3) for t in e['times']]} ({e['ms'] / c['ms']:.2f}x); device busy {100 * c['busy']:.1f} % "
            f"compiled, {100 * e['busy']:.1f} % eager; capture {captures}; {time.perf_counter() - t_start:.1f} s",
            verdict, c)


def one_rank_exchange(model, local, dev, budgets) -> str:
    """What a one-rank node group's boundary exchange does: the
    ``all_to_all_single`` calls one eager NodeParallel step issues, and the
    NCCL kernels a replay of its compiled step runs (by name, from the
    profiler). Returns the line to print."""
    import torch.distributed as dist

    from ptgnn_tpu_torch.parallel import NodeParallel

    module = model.build_neural_module(device=dev, seed=SEED)
    npar = NodeParallel(module, **budgets)
    optimizer = torch.optim.Adam(module.parameters(), lr=2.5e-4)
    calls = [0]
    original = dist.all_to_all_single

    def counted(*args, **kwargs):
        calls[0] += 1
        return original(*args, **kwargs)

    dist.all_to_all_single = counted
    try:
        npar.data_parallel.grad_step_compiled.fn(local[0], True)  # one eager forward and backward
    finally:
        dist.all_to_all_single = original
    npar.data_parallel.zero_grad()
    issued = calls[0]
    npar.train_step(local[0], optimizer)
    npar.train_step(local[0], optimizer)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        npar.train_step(local[0], optimizer)
        torch.cuda.synchronize()
    nccl, copies = {}, {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        if "nccl" in evt.key.lower():
            nccl[evt.key[:60]] = evt.count
        elif "memcpy" in evt.key.lower():
            copies[evt.key[:40]] = evt.count
    module.gnn.node_group = None
    npar.data_parallel.clear()
    return (f"one-rank node group: an eager step issues {issued} all_to_all_single calls (the boundary exchange "
            f"of each layer that reads sender rows, forward and backward); a replay of the compiled step runs "
            f"the NCCL kernels {nccl} and the copies {copies}")


def params_apart(a, b) -> tuple:
    """(the worst distance between two modules' parameters over each one's
    largest magnitude, its name, whether all are bitwise equal)."""
    worst, where, bitwise = 0.0, "", True
    for (pname, x), y in zip(a.named_parameters(), b.parameters()):
        x, y = x.detach(), y.detach()
        bitwise &= bool(torch.equal(x, y))
        err = float((x - y).abs().max() / x.abs().max().clamp_min(1e-30))
        if err > worst:
            worst, where = err, pname
    return worst, where, bitwise


def edge_parallel_phase(dev, card):
    """Edge sharding on the card. (1) ``shard_adjacency`` cuts a benchmark
    batch into EP_SHARDS tile-aligned shards; each shard's K2 (max) and K1
    (sum) over its own row index run on the card, and the partials combine
    on the host as the all-reduce would: the max bitwise the unsharded K2's,
    the sum within 1e-5 of each row's sum of |x| of the unsharded K1's.
    (2) ``EdgeParallel`` at world 1 over NCCL: EP_STEPS SGD steps (dropout 0)
    against the single-device steps of ModelTrainer's step function, every
    parameter within 1e-5 of its largest magnitude (the shard takes the
    per-slot route, not the fused op); then its compiled train step against
    eager (:func:`sharded_compiled_against_eager`). Returns the launch
    counts of (2)."""
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.parallel import EdgeParallel, shard_adjacency

    name = "edge-parallel"
    t_phase = time.perf_counter()
    model, module, minibatches, batches = build_bench(dev)
    host_adj = minibatches[0]["batch"].adjacency
    t0 = time.perf_counter()
    shards = shard_adjacency(host_adj, EP_SHARDS)
    t_shard = time.perf_counter() - t0
    adj = batches[0][0].adjacency
    n = adj.agg_counts.numel()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = torch.randn(adj.mask.shape[0], 64, device=dev, generator=gen)
    masked_max = torch.where(adj.mask[:, None], data, torch.full((), -3.0e38, device=dev)).contiguous()
    masked_sum = torch.where(adj.mask[:, None], data, torch.zeros((), device=dev)).contiguous()
    per = masked_max.shape[0] // EP_SHARDS
    total_max = torch.full((n, 64), -3.0e38, device=dev)
    total_sum = torch.zeros(n, 64, device=dev)
    covered = torch.zeros(n, dtype=torch.int64, device=dev)
    for s, host_shard in enumerate(shards):
        local = tree_to(host_shard, dev)
        part = slice(s * per, (s + 1) * per)
        mx = sk.planned_segment_extremum(masked_max[part].contiguous(), sk.plan_from_adjacency(local), n, True)
        counts = local.agg_counts.reshape(-1)[:n]
        total_max = torch.maximum(total_max, torch.where(counts[:, None] > 0, mx, torch.full((), -3.0e38, device=dev)))
        total_sum += sk.planned_segment_sum(masked_sum[part].contiguous(), sk.sum_plan_from_adjacency(local), n)
        covered += counts.long()
    total_max = torch.where(covered[:, None] > 0, total_max, torch.zeros((), device=dev)) + 0.0
    want_max = sk.planned_segment_extremum(masked_max, sk.plan_from_adjacency(adj), n, True)
    want_sum = sk.planned_segment_sum(masked_sum, sk.sum_plan_from_adjacency(adj), n)
    scale = sk.planned_segment_sum(masked_sum.abs(), sk.sum_plan_from_adjacency(adj), n)
    sum_err = float(((total_sum - want_sum).abs() / scale.clamp_min(1e-30)).max())
    if not bitwise_equal(total_max, want_max) or bool(((total_sum - want_sum).abs() > 1e-5 * scale).any()):
        raise RuntimeError(f"{name}: the shards' combined aggregates differ from the unsharded kernels' "
                           f"(max bitwise: {bitwise_equal(total_max, want_max)}, sum {sum_err:.3e} of sum|x|)")
    if not torch.equal(covered, adj.agg_counts.reshape(-1)[:n].long()):
        raise RuntimeError(f"{name}: the shards' in-degrees do not add up to the batch's")
    torch.cuda.synchronize()
    phase(name, f"shard_adjacency into {EP_SHARDS} shards of {per} slots ({[int(sh.mask.sum()) for sh in shards]} "
          f"real) in {1e3 * t_shard:.1f} ms on the host; each shard's K2 and K1 at width 64 on the card, combined: "
          f"the max bitwise the unsharded K2's, the sum within {sum_err:.3e} of each row's sum of |x| of the "
          f"unsharded K1's (limit 1e-5)")

    single = model.build_neural_module(device=dev, seed=SEED)
    set_dropout(single, 0.0)
    device_mbs = [g2c_minibatch(b) for b in batches[:EP_STEPS]]

    def run():
        sharded = model.build_neural_module(device=dev, seed=SEED)
        set_dropout(sharded, 0.0)
        ep = EdgeParallel(sharded)
        local = [tree_to(ep.shard_batch(mb), dev) for mb in minibatches[:EP_STEPS]]
        # the edge-parallel path: the sharded steps' launches
        out = held_steps(single, sharded, device_mbs, local,
                         lambda mb, opt, g: ep.train_step(mb, opt, generator=g)[0], EP_STEPS)
        sharded.gnn.edge_group = None
        before = launch_counts()
        compiled, _, _ = sharded_compiled_against_eager(model, local, dev, EdgeParallel)
        return out, compiled, delta(launch_counts(), before)

    (single_losses, losses, worst, where, bitwise, ms, counts), compiled, compiled_counts = world_one(run)
    np.testing.assert_allclose(losses, single_losses, rtol=1e-5)
    if worst > 1e-5:
        raise RuntimeError(f"{name}: a step's {where} is {worst:.3e} of its max from the single-device step's")
    if min(counts[k] for k in ("segment_extremum", "broadcast_to_edges", "segment_sum")) <= 0:
        raise RuntimeError(f"{name}: a kernel of the path was never launched: {counts}")
    phase(name, f"EdgeParallel's train step (NCCL, world 1, Adam, dropout on) {compiled} on {card}")
    counts = add_counts(counts, compiled_counts)
    phase(name, f"EdgeParallel (NCCL, world 1, one shard: the per-slot route over the shard's row index) vs "
          f"the single-device step (the fused op): {EP_STEPS} SGD steps (dropout 0), each from equal weights, "
          f"losses {losses} vs {single_losses} (rtol 1e-5), parameters within {worst:.3e} of each max (limit "
          f"1e-5; bitwise {bitwise}); {ms[0]:.2f} ms/step (the single-device step {ms[1]:.2f}; each step waits for "
          f"the card and reads the loss) on {card}; launches {counts}; phase total "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


class InProcessExchange:
    """The boundary exchange of ``shards`` shards that run side by side in
    this process, one thread each (``node_sharded_stack``). A shard's call
    leaves its rows and send lists, waits until every shard has reached the
    same exchange, and gathers its receive buffer from the owners' rows as
    the all_to_all delivers it: rows ``o * b:(o + 1) * b`` from shard ``o``.
    The threads hold ``cond``'s lock while they compute, so one runs at a
    time."""

    def __init__(self, shards: int):
        import threading

        self.cond = threading.Condition()
        self.shards = shards
        self.rounds: list = []
        self.failed = False

    def shard(self, s: int):
        owner = self

        class Shard:
            group, shard_index, num_shards, calls = None, s, owner.shards, 0

            def __call__(self, h, send_idx):
                while len(owner.rounds) <= self.calls:
                    owner.rounds.append({})
                box = owner.rounds[self.calls]
                self.calls += 1
                box[s] = (h, send_idx)
                owner.cond.notify_all()
                if not owner.cond.wait_for(lambda: owner.failed or len(box) == owner.shards, timeout=600):
                    raise RuntimeError(f"shard {s}: the other shards never reached exchange {self.calls}")
                if owner.failed:
                    raise RuntimeError(f"shard {s}: another shard failed")
                return torch.cat([box[o][0].index_select(0, box[o][1][s].long()) for o in range(owner.shards)])

        return Shard()


def node_sharded_stack(gnn, local: list):
    """The node-sharded forward of ``gnn`` (the port's own,
    ``GraphNeuralNetwork._forward_node_sharded``) for each shard's batch in
    ``local``, in this one process: one thread a shard, the boundary rows
    passed between them by an ``InProcessExchange``. One autograd graph: the
    backward crosses the shards through those gathers. Returns the [N_pad,
    D] final states in the sharded (renumbered) order."""
    import threading

    shards = len(local)
    exchange = InProcessExchange(shards)
    outs, errors = [None] * shards, []

    def run(s):
        try:
            with exchange.cond:
                out, _ = gnn._forward_node_sharded(local[s], train=True, generator=None, return_all_states=False,
                                                   exchange=exchange.shard(s))
                outs[s] = out.output_node_representations
        except BaseException as failure:  # noqa: BLE001 - handed to the caller
            errors.append(failure)
            with exchange.cond:
                exchange.failed = True
                exchange.cond.notify_all()

    threads = [threading.Thread(target=run, args=(s,), daemon=True) for s in range(shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"the in-process node-sharded forward failed: {errors or 'a shard hung'}")
    return torch.cat(outs)


def np_layout_checks(layouts: dict, dev, gen, max_abs_err: dict) -> None:
    """K1, K2 and K3 on node-sharded sub-layouts (``layouts``: label ->
    AdjacencyStruct on the card) at the widths the 'mlp' stack gives them:
    K2 and K3 bitwise equal to their plain versions, K1 within 1e-5 of each
    row's sum of |x| of its plain version on the card and bitwise equal to
    the plain version on the CPU. Keeps each kernel's largest error."""
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    cpu = torch.device("cpu")
    for label, adj in layouts.items():
        num_nodes = adj.agg_counts.numel()
        cpu_plan = tree_to(sk.sum_plan_from_adjacency(adj), cpu)
        for kind, widths in (("segment_extremum", (64, 128)), ("broadcast_to_edges", (64, 128)),
                             ("segment_sum", (64, 128, 256))):
            for width in widths:
                k = layout_kernel(kind, adj, width, dev, gen)
                x = k.make()
                got, plain = k.kernel(x), k.plain(x)
                err = float((got - plain).abs().max())
                max_abs_err[kind] = max(max_abs_err.get(kind, 0.0), err)
                if kind != "segment_sum":
                    if not bitwise_equal(got, plain):
                        raise RuntimeError(f"{kind} kernel != plain version on {label} at {width} ({err:.3e})")
                elif (bool(((got - plain).abs() > 1e-5 * k.plain(x.abs())).any())
                      or not bitwise_equal(got.cpu(), sk.segment_sum_plain(x.cpu(), cpu_plan, num_nodes))):
                    raise RuntimeError(f"sum kernel off its plain version on {label} at {width} ({err:.3e})")
    torch.cuda.synchronize()


def node_parallel_phase(dev, card, ppi_model, ppi_minibatches):
    """Node sharding on the card. (1) ``shard_batch_by_nodes`` splits a
    benchmark batch 2 and 4 ways (BFS reorder on); the port's node-sharded
    forward runs every shard in this process (``node_sharded_stack``), and
    the final node states and every gradient of <states, cotangent> are held
    against the unsharded stack's (the fused op) on the same batch, mapped
    back through the permutation: states within 1e-5 of their max, each
    gradient within 1e-4 of its max. K1, K2 and K3 are held to their plain
    versions on every shard's interior, boundary and merged layouts
    (``np_layout_checks``). (2) ``NodeShardedModelTrainer`` at world 1 over
    NCCL: NP_STEPS SGD steps (dropout 0) against the single-device steps,
    every parameter within 1e-5 of its max; its compiled train step against
    eager (:func:`sharded_compiled_against_eager`) and what a one-rank node
    group's exchange runs (:func:`one_rank_exchange`); then the trainer for
    an epoch (ZeRO-1, Adam) compiled and eager, bitwise, and
    ``traindistributed --world-size 1 --node-shards 1``.
    (3) PPI at its reference width node-sharded at world 1, in bf16 AMP (K5's
    gate open) and in float32, against the unsharded steps (``ppi_np_steps``),
    and K5 held on its interior and boundary layouts. Returns the launch
    counts of (2) and (3), the layouts of the kernels line and K5's errors
    on them."""
    import io as stdio
    import os

    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.implementations.typilus import traindistributed
    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model, default_padding
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.parallel import NodeParallel, NodeShardedModelTrainer, shard_batch_by_nodes, suggest_budgets
    from ptgnn_tpu_torch.parallel.node_sharding import local_shard, merged_adjacency
    from ptgnn_tpu_torch.utils.io import write_jsonl_gz
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    name = "node-parallel"
    t_phase = time.perf_counter()
    model, module, minibatches, batches = build_bench(dev)
    set_dropout(module, 0.0)
    host_mb = minibatches[0]
    batch = batches[0][0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out, _ = module.gnn(batch, train=True)
    cot = torch.randn(out.output_node_representations.shape, device=dev, generator=gen)
    module.zero_grad(set_to_none=True)
    (out.output_node_representations * cot).sum().backward()
    want = out.output_node_representations.detach()
    want_grads = {k: p.grad.clone() for k, p in module.gnn.named_parameters() if p.grad is not None}
    layouts, layout_err = {}, {}
    for shards in NP_SHARDS:
        t0 = time.perf_counter()
        budgets = suggest_budgets([host_mb], shards, reorder="bfs")
        sharded, stats = shard_batch_by_nodes(host_mb, shards, reorder="bfs", **budgets)
        t_host = time.perf_counter() - t0
        perm = torch.from_numpy(stats["permutation"]).to(dev)
        local = [tree_to(local_shard(sharded, s), dev)["batch"] for s in range(shards)]
        module.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = node_sharded_stack(module.gnn, local)
        (got * cot[perm]).sum().backward()
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
        err = float((got.detach() - want[perm]).abs().max() / want.abs().max())
        grad_err = max((float((p.grad - want_grads[k]).abs().max() / want_grads[k].abs().max()), k)
                       for k, p in module.gnn.named_parameters() if p.grad is not None)
        if err > 1e-5 or grad_err[0] > 1e-4:
            raise RuntimeError(f"{name}: {shards} shards: states {err:.3e} of their max from the unsharded "
                               f"stack's, gradient {grad_err[1]} {grad_err[0]:.3e}")
        shard_layouts = {}
        for s, b in enumerate(local):
            adj_bnd = b.node_sharding.adjacency_bnd
            shard_layouts[f"{shards}-way shard {s} interior"] = b.adjacency
            shard_layouts[f"{shards}-way shard {s} boundary"] = adj_bnd
            shard_layouts[f"{shards}-way shard {s} merged"] = merged_adjacency(
                b.adjacency, adj_bnd, stats["rows_per_shard"], b.node_mask.shape[0])
        np_layout_checks(shard_layouts, dev, gen, layout_err)
        if shards == NP_SHARDS[0]:
            layouts.update({f"np {shards}-way {side}": shard_layouts[f"{shards}-way shard 0 {side}"]
                            for side in ("interior", "boundary")})
        d = want.shape[1]
        phase(name, f"{shards} shards, BFS reorder: resharded on the host in {1e3 * t_host:.1f} ms ({stats['rows_per_shard']} rows a shard, "
              f"budgets {budgets}); boundary rows {stats['boundary_nodes_total']} of {int(host_mb['batch'].num_nodes)} "
              f"nodes, exchanged per layer {stats['exchanged_rows_real']} rows = "
              f"{4 * d * stats['exchanged_rows_real']} float32 bytes ({4 * d * stats['exchanged_rows_padded']} as "
              f"the padded all_to_all ships them); the port's node-sharded forward of every shard in one process "
              f"(a thread a shard, the boundary rows passed in-process), forward and backward "
              f"{1e3 * t_step:.1f} ms; final states within {err:.3e} of their max of the unsharded stack's "
              f"(limit 1e-5), every gradient within {grad_err[0]:.3e} of its max (limit 1e-4; worst {grad_err[1]}); "
              f"K1, K2, K3 on the {3 * shards} interior, boundary and merged layouts of the shards at widths "
              f"64-256: K2, K3 bitwise equal to their plain versions, K1 within 1e-5 x sum|x| (max abs err "
              f"{ {k: f'{v:.3e}' for k, v in layout_err.items()} })")

    single = model.build_neural_module(device=dev, seed=SEED)
    set_dropout(single, 0.0)
    device_mbs = [g2c_minibatch(b) for b in batches[:NP_STEPS]]
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    budgets = suggest_budgets(minibatches[:NP_STEPS], 1)

    def run():
        sharded = model.build_neural_module(device=dev, seed=SEED)
        set_dropout(sharded, 0.0)
        npar = NodeParallel(sharded, **budgets)
        local = [tree_to(npar.shard_batch(mb), dev) for mb in minibatches[:NP_STEPS]]
        # the node-parallel path: the sharded steps' launches, then the trainer's and the CLI's
        held = held_steps(single, sharded, device_mbs, local,
                          lambda mb, opt, g: npar.train_step(mb, opt, generator=g)[0], NP_STEPS)
        sharded.gnn.node_group = None
        before = launch_counts()
        exchange = one_rank_exchange(model, local, dev, budgets)
        compiled, _, _ = sharded_compiled_against_eager(model, local, dev, lambda m: NodeParallel(m, **budgets))
        compiled_counts = delta(launch_counts(), before)

        trainer = NodeShardedModelTrainer(
            create_graph2class_gnn_model(hidden_state_size=64, padding=default_padding()),
            out_dir / "np-trainer.pkl.gz", node_shards=1, max_num_epochs=1, minibatch_size=300, device=dev,
            seed=SEED, optimizer_creator=lambda p: torch.optim.Adam(p, lr=2.5e-4), clip_gradient_norm=1.0,
            target_validation_metric="Accuracy", target_validation_metric_higher_is_better=True)
        train_graphs = list(graphs(SEED))[:24]
        trainer.load_metadata_and_create_network(train_graphs, parallelize=False)
        before = launch_counts()
        t0 = time.perf_counter()
        trainer.train(train_graphs, list(graphs(SEED + 1))[:6], initialize_metadata=False, patience=0,
                      parallelize=False)
        torch.cuda.synchronize()
        t_trainer = time.perf_counter() - t0
        trainer_counts = delta(launch_counts(), before)
        eager_trainer = NodeShardedModelTrainer(
            create_graph2class_gnn_model(hidden_state_size=64, padding=default_padding()),
            out_dir / "np-trainer-eager.pkl.gz", node_shards=1, max_num_epochs=1, minibatch_size=300, device=dev,
            seed=SEED, optimizer_creator=lambda p: torch.optim.Adam(p, lr=2.5e-4), clip_gradient_norm=1.0,
            target_validation_metric="Accuracy", target_validation_metric_higher_is_better=True)
        eager_trainer.load_metadata_and_create_network(train_graphs, parallelize=False)
        eager_dp(eager_trainer.data_parallel)
        before = launch_counts()
        t0 = time.perf_counter()
        eager_trainer.train(train_graphs, list(graphs(SEED + 1))[:6], initialize_metadata=False, patience=0,
                            parallelize=False)
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0
        trainer_counts = add_counts(trainer_counts, delta(launch_counts(), before))
        apart = params_apart(trainer.neural_module, eager_trainer.neural_module)
        if not apart[2]:
            raise RuntimeError(f"{name}: the compiled NodeShardedModelTrainer epoch != the eager one ({apart[1]} "
                               f"{apart[0]:.3e} of its max)")
        return held, trainer, (t_trainer, t_eager), add_counts(trainer_counts, compiled_counts), compiled, exchange

    held, trainer, t_trainer, trainer_counts, compiled, exchange = world_one(run)
    single_losses, losses, worst, where, bitwise, ms, step_counts = held
    np.testing.assert_allclose(losses, single_losses, rtol=1e-5)
    if worst > 1e-5:
        raise RuntimeError(f"{name}: a step's {where} is {worst:.3e} of its max from the single-device step's")
    phase(name, f"NodeParallel (NCCL, world 1: one shard, its interior layout re-assembled, the interior/"
          f"boundary route) vs the single-device step (the fused op): {NP_STEPS} SGD steps (dropout 0), each "
          f"from equal weights, losses {losses} vs {single_losses} (rtol 1e-5), parameters within {worst:.3e} "
          f"of each max (limit 1e-5; bitwise {bitwise}); {ms[0]:.2f} ms/step (the single-device step "
          f"{ms[1]:.2f}) on {card}; launches {step_counts}")
    if not (out_dir / "np-trainer.pkl.gz").exists() or trainer._budgets is None:
        raise RuntimeError(f"{name}: NodeShardedModelTrainer saved no checkpoint or probed no budgets")
    phase(name, f"NodeParallel's train step (NCCL, world 1, Adam, dropout on) {compiled} on {card}; {exchange}")
    phase(name, f"NodeShardedModelTrainer (NCCL, world 1, node shards 1): 1 epoch with validation in "
          f"{t_trainer[0]:.2f} s compiled, {t_trainer[1]:.2f} s eager, the parameters after them bitwise equal; "
          f"probed budgets {trainer._budgets}; launches of both and of the steps above {trainer_counts}")

    root = out_dir / "np-cli"
    shutil.rmtree(root, ignore_errors=True)
    folds = []
    for i, (fold, count) in enumerate((("train", 12), ("valid", 4), ("test", 4))):
        (root / fold).mkdir(parents=True)
        write_jsonl_gz(root / fold / "part0.jsonl.gz",
                       synthetic_typilus_graphs(count, seed=SEED + 40 + i, mean_nodes=1500, max_nodes=4000))
        folds.append(str(root / fold))
    cwd = os.getcwd()
    os.chdir(root)  # the CLI's log file goes under the working directory
    before = launch_counts()
    t0 = time.perf_counter()
    try:
        printed = stdio.StringIO()
        with contextlib.redirect_stdout(printed):
            accuracy = traindistributed.run(traindistributed.build_arg_parser().parse_args(
                [*folds, str(root / "np.pkl.gz"), "--max-num-epochs", "1", "--max-nodes", "8192",
                 "--world-size", "1", "--node-shards", "1", "--quiet"]))
    finally:
        os.chdir(cwd)
    cli = delta(launch_counts(), before)
    line = [ln for ln in printed.getvalue().splitlines() if ln.startswith("Test accuracy:")]
    if not line or accuracy is None or not 0.0 <= accuracy <= 1.0 or not (root / "np.pkl.gz").exists():
        raise RuntimeError(f"traindistributed --node-shards 1 printed {line}, returned {accuracy}")
    phase(name, f"traindistributed --world-size 1 --node-shards 1 (NCCL, ZeRO-1): 1 epoch over 12 graphs in "
          f"{time.perf_counter() - t0:.2f} s; '{line[0]}'; launches {cli}")

    ppi_counts, ppi_layouts, ppi_err = ppi_np_steps(ppi_model, ppi_minibatches, dev, card)
    layouts.update(ppi_layouts)
    counts = add_counts(add_counts(add_counts(step_counts, trainer_counts), cli), ppi_counts)
    if min(counts[k] for k in ("segment_extremum", "broadcast_to_edges", "segment_sum", "typed_matmul")) <= 0:
        raise RuntimeError(f"{name}: a kernel of the path was never launched: {counts}")
    phase(name, f"launches over the node-parallel path {counts}; the 4-rank and the 2 x 2 paths run under "
          f"--world 4 on four cards and on the CPU over gloo (tests/test_torch_multicard.py); phase total "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts, layouts, {**layout_err, **ppi_err}


def ppi_np_steps(ppi_model, ppi_minibatches, dev, card, shards: int = 1, within=None):
    """PPI at its reference width, node-sharded over ``shards`` ranks
    (``NodeParallel``, dropout 0; inside ``within``, a one-rank NCCL group
    by default), in bf16 AMP (K5's gate open on the
    sub-layouts) and in float32, against the unsharded steps of
    ModelTrainer's step function on the same minibatch: NP_STEPS SGD steps,
    each from the unsharded module's weights. Held: both losses within rtol
    1e-5 (over several shards the bf16 loss no farther from the float32
    loss than 1.5 times the unsharded bf16 loss, or rtol 1e-5 of it); each
    float32 gradient within 1e-4 of its max, and the float32
    step's parameters within 1e-5 of each max; each bf16 gradient, and all
    of them together, no farther from its own route's float32 gradient than
    1.5 times the unsharded route's distance (or 1e-2 of its norm), as
    ppi-parity holds the card's bf16 step (over several shards all of them
    together: a small tensor's bf16 rounding is noise there, and its ratio
    is printed). K5 is then held on the interior and boundary
    layouts (``typed_matmul_checks``, bf16; on the card). Returns the
    launches of the sharded steps, this rank's two layouts and K5's errors
    on them."""
    from ptgnn_tpu_torch.core.trainer import module_loss, optimizer_step
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.parallel import NodeParallel, suggest_budgets

    name, lr = "node-parallel", 0.05
    single = ppi_model.build_neural_module(device=dev, seed=SEED)
    set_dropout(single, 0.0)
    single_mb = tree_to(ppi_minibatches[0], dev)
    budgets = suggest_budgets(ppi_minibatches[:1], shards)
    opt_single = torch.optim.SGD(single.parameters(), lr=lr)

    def grads(m):
        return [(n, torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
                for n, p in m.named_parameters()]

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def run():
        routes = {}
        for amp in (True, False):
            m = ppi_model.build_neural_module(device=dev, seed=SEED)
            set_dropout(m, 0.0)
            npar = NodeParallel(m, enable_amp=amp, node_aligned=ppi_model.node_aligned_minibatch_keys, **budgets)
            routes[amp] = (m, npar, tree_to(npar.shard_batch(ppi_minibatches[0]), dev),
                           torch.optim.SGD(m.parameters(), lr=lr))
        launches = {k: 0 for k in launch_counts()}
        rows, whole, losses, param_err, elapsed = [], [], [], 0.0, 0.0
        for _ in range(NP_STEPS):
            state = {k: v.clone() for k, v in single.state_dict().items()}
            plain = {}
            for amp in (False, True):  # the bf16 step last: it moves the unsharded module
                single.zero_grad(set_to_none=True)
                loss, _ = module_loss(single, single_mb, train=True, amp=amp)
                loss.backward()
                plain[amp] = (float(loss), grads(single))
            optimizer_step(single, opt_single, [lr])
            sharded = {}
            for amp in (True, False):
                m, npar, local, opt = routes[amp]
                m.load_state_dict(state)
                before = launch_counts()
                synchronize()
                t0 = time.perf_counter()
                loss, _, _ = npar.data_parallel.grad_step(local, 1.0, None)
                sharded[amp] = (float(loss), grads(m))
                npar.data_parallel.apply_gradients(opt, [lr])
                synchronize()
                if amp:
                    elapsed += time.perf_counter() - t0
                launches = add_counts(launches, delta(launch_counts(), before))
            losses.append((sharded[True][0], plain[True][0], sharded[False][0], plain[False][0]))
            for (n, g16), (_, g32), (_, p16), (_, p32) in zip(sharded[True][1], sharded[False][1], plain[True][1],
                                                             plain[False][1]):
                rows.append((rel(g16, g32), rel(p16, p32), rel(g16, p16),
                             float((g32 - p32).abs().max() / p32.abs().max().clamp_min(1e-30)), n))
            flat = [torch.cat([g.flatten() for _, g in route]) for route in (
                sharded[True][1], sharded[False][1], plain[True][1], plain[False][1])]
            whole.append((rel(flat[0], flat[1]), rel(flat[2], flat[3])))
            for (pname, p), (_, w) in zip(routes[False][0].named_parameters(), plain[False][1]):
                want = state[pname] - lr * w
                param_err = max(param_err, float((p.detach() - want).abs().max() / want.abs().max().clamp_min(1e-30)))
        for m, _, _, _ in routes.values():
            m.gnn.node_group = None
        local_batch = routes[True][2]["batch"]
        return (rows, whole, losses, param_err, 1e3 * elapsed / NP_STEPS, launches,
                {"ppi np interior": local_batch.adjacency, "ppi np boundary": local_batch.node_sharding.adjacency_bnd})

    rows, whole, losses, param_err, ms, counts, layouts = (within or world_one)(run)
    for np16, p16, np32, p32 in losses:
        np.testing.assert_allclose(np32, p32, rtol=1e-5)
        if shards == 1:
            np.testing.assert_allclose(np16, p16, rtol=1e-5)
        elif abs(np16 - p32) > max(1.5 * abs(p16 - p32), 1e-5 * abs(p32)):
            # over several shards the bf16 sums round in other groups
            raise RuntimeError(f"{name}: PPI bf16 loss over {shards} shards {np16} is farther from the float32 "
                               f"loss {p32} than 1.5x the unsharded bf16 loss {p16}")
    for np_own, plain_own, _, f32_err, n in rows:
        if f32_err > 1e-4:
            raise RuntimeError(f"{name}: PPI float32 gradient {n} is {f32_err:.3e} of its max from the unsharded one")
        if shards == 1 and np_own > max(1.5 * plain_own, 1e-2):
            raise RuntimeError(f"{name}: PPI bf16 gradient {n}: {np_own:.3e} of its norm from its own float32 "
                               f"gradient, against the unsharded route's {plain_own:.3e}")
    for np_own, plain_own in whole:
        if np_own > max(1.5 * plain_own, 1e-2):
            raise RuntimeError(f"{name}: PPI bf16 gradient (all tensors): {np_own:.3e} of its norm from its own "
                               f"float32 gradient, against the unsharded route's {plain_own:.3e}")
    if param_err > 1e-5:
        raise RuntimeError(f"{name}: PPI float32 step's parameters {param_err:.3e} of their max from the unsharded step's")
    if dev.type == "cuda" and counts["typed_matmul"] <= 0:
        raise RuntimeError(f"{name}: PPI bf16 node-sharded steps never launched the typed matmul: {counts}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    k5_err = {}
    for label, adj in layouts.items() if dev.type == "cuda" else ():
        errs = {}
        typed_matmul_checks(adj, dev, gen, errs, dtypes=(torch.bfloat16,), name=f"{name} {label}")
        k5_err.update({f"{key} {label}": v for key, v in errs.items()})
    phase(name, f"PPI node-sharded over {shards} rank{'s' if shards > 1 else ''} "
          f"({'NCCL' if dev.type == 'cuda' else 'gloo'}) vs the unsharded steps, {NP_STEPS} SGD steps "
          f"(dropout 0), each from the unsharded weights: losses (sharded bf16, unsharded bf16, sharded float32, "
          f"unsharded float32) {losses} (rtol 1e-5); float32 gradients within {max(r[3] for r in rows):.3e} of "
          f"each max (limit 1e-4), the stepped parameters within {param_err:.3e} (limit 1e-5); each bf16 "
          f"gradient from its own route's float32 gradient: sharded largest {max(r[0] for r in rows):.3e}, "
          f"unsharded {max(r[1] for r in rows):.3e} (limit 1.5x the unsharded, or 1e-2), largest ratio "
          f"{max(r[0] / max(r[1], 1e-30) for r in rows):.2f}; all tensors together, sharded {max(w[0] for w in whole):.3e}, "
          f"unsharded {max(w[1] for w in whole):.3e}; sharded bf16 vs "
          f"unsharded bf16 largest {max(r[2] for r in rows):.3e} of the norm; {ms:.2f} ms a bf16 step on "
          f"{card}; launches of both routes {counts} (K5 open in bf16)")
    return counts, layouts, k5_err


# ---------------------------------------------------------------------------
# 23-28. the C++ layout assembler, prefetch, device-OOM skips, the padding
# autotuner, async sharded checkpoints, profiling
# ---------------------------------------------------------------------------
EPOCH_GRAPHS = 54  # about 18 benchmark batches of about 3 graphs
ASSEMBLER_REPS = 7


def recorded_layouts(fn, owner) -> list:
    """The (args, kwargs) of every ``assemble_layout_arrays`` call that
    ``fn()`` makes through module ``owner``'s name for it."""
    calls = []
    real = owner.assemble_layout_arrays

    def recording(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    owner.assemble_layout_arrays = recording
    try:
        fn()
    finally:
        owner.assemble_layout_arrays = real
    return calls


@contextlib.contextmanager
def numpy_assembler():
    """Every ``GraphBatcher.finalize`` assembles with the numpy oracle."""
    from ptgnn_tpu_torch.graph import batching

    real = batching.assemble_layout_arrays
    batching.assemble_layout_arrays = functools.partial(real, native_assembler=False)
    try:
        yield
    finally:
        batching.assemble_layout_arrays = real


def first_minibatch(model, samples):
    return next(iter(model.minibatch_iterator(model.tensorize_dataset(iter(samples), parallelize=False),
                                              max_minibatch_size=300, parallelize=False)))[0]


def device_profile():
    """A profiler of the card's activity alone (kernels, copies): the host's
    ops are not recorded, which keeps a profiled run's own cost low."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


def busy_share(prof, wall_s: float) -> float:
    """The device's busy share of a profiled run of ``wall_s`` seconds;
    raises where the profile holds no device time."""
    ms = device_ms(prof)
    if ms <= 0:
        raise RuntimeError("the profile holds no device time")
    return ms / (1e3 * wall_s)


def device_ms(prof) -> float:
    """The kernels' device ms in a profile (named ranges left out)."""
    total = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA \
                and not getattr(evt, "is_user_annotation", False) and not evt.key.startswith(("Optimizer.", "layer ")):
            total += us
    return total / 1e3


def g2c_epoch(model, train, valid, dev, *, prefetch=2, numpy_layout=False, profiled=False, catch_device_ooms=False,
              inject=None, name="epoch", eager_steps=False, use_multiprocessing=True, **trainer_kw):
    """One ModelTrainer epoch of the benchmark Graph2Class model (dropout
    0.1, seeded) over ``train`` with the worker threads on (and the forked
    tensorize, unless ``use_multiprocessing`` is off), then validation on
    ``valid``. ``inject``: (position, host minibatch, raw samples) put
    into the training pass. Returns the epoch's seconds (training start to
    the train epoch's end), the step losses, the parameters, the steps, and
    with ``profiled`` the busy share of the whole train() call.
    ``eager_steps``: the trainer's steps called directly, not compiled;
    ``trainer_kw``: more ModelTrainer arguments."""
    from ptgnn_tpu_torch.core.trainer import ModelTrainer, module_loss

    class Trainer(ModelTrainer):
        def _train_step_for(self, optimizer):
            step = super()._train_step_for(optimizer)
            return eager(step) if eager_steps else step

        def _eval_step(self, minibatch):
            if eager_steps:
                return module_loss(self.neural_module, minibatch, train=False, amp=self._enable_amp)
            return super()._eval_step(minibatch)

        def _device_minibatches(self, items):
            if inject is not None:
                items = itertools.chain(itertools.islice(items, inject[0]), [inject[1:]], items)
            return super()._device_minibatches(items)

        def _train_step(self, *args):
            loss_f, metrics = super()._train_step(*args)
            self.losses.append(loss_f)
            return loss_f, metrics

    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / "epochs"
    trainer = Trainer(model, out_dir / f"{name}.pkl.gz", max_num_epochs=1, minibatch_size=300,
                      clip_gradient_norm=1.0, optimizer_creator=lambda p: torch.optim.Adam(p, lr=2.5e-4),
                      prefetch_to_device=prefetch, catch_device_ooms=catch_device_ooms, device=dev, seed=SEED,
                      **trainer_kw)
    trainer.losses = []
    trainer.load_metadata_and_create_network(train, parallelize=False)
    marks = {}
    trainer.register_training_start_hook(lambda *_: marks.__setitem__("start", time.perf_counter()))
    trainer.register_train_epoch_end_hook(lambda *_: marks.__setitem__("end", time.perf_counter()))
    context = numpy_assembler() if numpy_layout else contextlib.nullcontext()
    busy = None
    with context:
        torch.cuda.synchronize()
        if profiled:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                trainer.train(train, valid, initialize_metadata=False, validate_on_start=False, patience=0,
                              use_multiprocessing=use_multiprocessing)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy = device_ms(prof) / (1e3 * wall)
        else:
            trainer.train(train, valid, initialize_metadata=False, validate_on_start=False, patience=0,
                          use_multiprocessing=use_multiprocessing)
    return {"seconds": marks["end"] - marks["start"], "losses": list(trainer.losses), "busy": busy,
            "params": {k: v.detach().clone() for k, v in trainer.neural_module.named_parameters()},
            "steps": len(trainer.losses)}


def same_epoch(a: dict, b: dict) -> bool:
    return a["losses"] == b["losses"] and all(bitwise_equal(a["params"][k], b["params"][k]) for k in a["params"])


def epoch_data():
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    train = list(synthetic_typilus_graphs(EPOCH_GRAPHS, seed=SEED + 50, mean_nodes=2500, max_nodes=8000))
    valid = list(synthetic_typilus_graphs(6, seed=SEED + 51, mean_nodes=2500, max_nodes=8000))
    return train, valid


def native_assembler_phase(dev, card, model, ppi_model, ppi_samples, epochs):
    """The C++ assembler against the numpy oracle: bitwise on the
    benchmark batch, a PPI batch and a 2-way node-parallel boundary layout,
    host ms of each (median of 7); a Graph2Class epoch with each. Returns
    the launch counts of the two epochs."""
    from ptgnn_tpu_torch import native
    from ptgnn_tpu_torch.graph import batching
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.parallel import node_sharding, shard_batch_by_nodes, suggest_budgets

    name = "native-assembler"
    phase(name, f"library {native.library_path()} (g++ flags {' '.join(native.CXX_FLAGS)})")
    host = {}
    layouts = recorded_layouts(lambda: host.setdefault("g2c", first_minibatch(model, graphs())), batching)
    cases = [("benchmark batch", layouts[0])]
    layouts = recorded_layouts(lambda: first_minibatch(ppi_model, ppi_samples), batching)
    cases.append(("PPI batch", layouts[0]))
    mb = host["g2c"]
    layouts = recorded_layouts(lambda: shard_batch_by_nodes(mb, 2, reorder="bfs", **suggest_budgets(
        [mb], 2, reorder="bfs")), node_sharding)
    boundary = [c for c in layouts if c[1]["sender_domain"] != c[1]["max_nodes"]]
    cases.append(("2-way node-parallel boundary (sender_domain)", boundary[0]))
    for label, (args, kwargs) in cases:
        times = {}
        outs = {}
        for native_layout in (True, False, True, False):
            samples = []
            for _ in range(ASSEMBLER_REPS):
                t0 = time.perf_counter()
                outs[native_layout] = batching.assemble_layout_arrays(*args, **kwargs, native_assembler=native_layout)
                samples.append(1e3 * (time.perf_counter() - t0))
            times.setdefault(native_layout, []).append(float(np.median(samples)))
        equal = all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(outs[True], outs[False]))
        phase(name, f"{label}: {len(args[0])} raw edges into {kwargs['e_pad']} slots (tile {kwargs['tile']}, "
              f"align {kwargs['align']}, sender domain {kwargs.get('sender_domain')}): C++ == numpy bitwise {equal}; "
              f"host ms per layout, median of {ASSEMBLER_REPS}, in turns: C++ {times[True]}, numpy {times[False]}")
        if not equal:
            raise RuntimeError(f"the C++ layout differs from the numpy one on the {label}")

    train, valid = epochs
    sk.reset_launch_counts()  # the native-assembler path starts here
    runs = {"C++": [], "numpy": []}
    for label in ("numpy", "C++", "C++", "numpy"):  # in turns
        runs[label].append(g2c_epoch(model, train, valid, dev, numpy_layout=label == "numpy",
                                     name=f"assembler-{label}"))
    busy = {label: g2c_epoch(model, train, valid, dev, numpy_layout=label == "numpy", profiled=True,
                             name=f"assembler-{label}-profiled")["busy"] for label in ("C++", "numpy")}
    counts = launch_counts()  # the native-assembler path ends here
    for label in ("C++", "numpy"):
        phase(name, f"ModelTrainer epoch with the {label} assembler (worker threads on, prefetch 2): "
              f"{runs[label][0]['steps']} steps over {len(train)} graphs in "
              f"{[round(r['seconds'], 3) for r in runs[label]]} s (run in turns numpy, C++, C++, numpy); device "
              f"busy {100 * busy[label]:.1f} % of a profiled epoch + validation on {card}")
    if not all(same_epoch(runs["C++"][0], r) for r in runs["C++"][1:] + runs["numpy"]):
        raise RuntimeError("the epochs with the C++ and the numpy assembler differ")
    phase(name, f"the four epochs bitwise equal (losses and parameters); launches {counts}")
    return counts, runs["C++"]


def prefetch_phase(dev, card, model, epochs, prefetch_two):
    """Two Graph2Class epochs at prefetch_to_device 1 beside the native
    phase's two at 2: losses and parameters bitwise equal."""
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    name = "prefetch"
    sk.reset_launch_counts()  # the prefetch path starts here
    ones = [g2c_epoch(model, *epochs, dev, prefetch=1, name=f"prefetch-1-{i}") for i in range(2)]
    counts = launch_counts()  # the prefetch path ends here
    phase(name, f"ModelTrainer epoch, {ones[0]['steps']} steps: prefetch_to_device 1 "
          f"{[round(r['seconds'], 3) for r in ones]} s, 2 {[round(r['seconds'], 3) for r in prefetch_two]} s "
          f"(the native-assembler phase's C++ epochs) on {card}; launches {counts}")
    if not all(same_epoch(one, prefetch_two[0]) for one in ones):
        raise RuntimeError("prefetch_to_device 1 and 2 gave different epochs")
    phase(name, f"losses and parameters bitwise equal at prefetch 1 and 2 ({len(ones[0]['losses'])} losses)")
    return counts


MT_ORDER = (True, False, False, True)  # use_multiprocessing, in turns: forked, threads, threads, forked


def first_sample_seconds(model, samples, use_multiprocessing: bool) -> float:
    """Seconds from a ``tensorize_dataset`` call to its first sample: with
    ``use_multiprocessing``, the fork of this process (its CUDA context
    live) and the child's first tensorize; else the thread pool's first.
    The stream is closed at once (the child terminated and joined)."""
    t0 = time.perf_counter()
    stream = model.tensorize_dataset(iter(samples), use_multiprocessing=use_multiprocessing)
    next(stream)
    seconds = time.perf_counter() - t0
    stream.close()
    return seconds


def host_tensorize_costs(model, samples) -> dict:
    """Host seconds over ``samples`` in this thread: tensorize each, pickle
    each result (the child's work beside tensorizing) and unpickle it (the
    parent's), and the pickled bytes."""
    import pickle

    t0 = time.perf_counter()
    tensorized = [model.tensorize(sample) for sample in samples]
    t1 = time.perf_counter()
    blobs = [pickle.dumps(t, protocol=pickle.HIGHEST_PROTOCOL) for t in tensorized]
    t2 = time.perf_counter()
    for blob in blobs:
        pickle.loads(blob)
    t3 = time.perf_counter()
    return {"tensorize_s": t1 - t0, "pickle_s": t2 - t1, "unpickle_s": t3 - t2,
            "mbytes": sum(len(b) for b in blobs) / 1e6}


def planted_tensorize_error(model, samples) -> tuple:
    """A ``tensorize`` that raises on its 5th sample, run in the forked
    child of this process (CUDA context live): the consumer must get
    ``RuntimeError`` carrying the child's traceback after the samples
    before it (those of the first 4 that tensorize), and the parent's copy
    of the call count must stay 0 (the calls ran in the child). Returns (samples received, the error's last
    line)."""
    real = model.tensorize
    calls = [0]

    def failing(datapoint):
        calls[0] += 1
        if calls[0] == 5:
            raise ValueError("planted failure on the 5th sample")
        return real(datapoint)

    model.tensorize = failing
    received, message = 0, None
    try:
        for _ in model.tensorize_dataset(iter(samples), use_multiprocessing=True):
            received += 1
    except RuntimeError as error:
        message = str(error)
    finally:
        del model.tensorize
    expected = sum(real(datapoint) is not None for datapoint in samples[:4])
    if message is None or "Traceback" not in message or "ValueError: planted failure on the 5th sample" not in message \
            or received != expected or calls[0] != 0:
        raise RuntimeError(f"the planted tensorize error did not surface as the child's traceback: received "
                           f"{received}, parent calls {calls[0]}, message {message!r}")
    return received, message.strip().splitlines()[-1]


def multiprocess_tensorize_phase(dev, card, model, epochs):
    """The forked tensorize (``use_multiprocessing``, the default) against
    the thread pool on the benchmark Graph2Class epoch (phase 23's: 54
    graphs, compiled steps, prefetch 2): the seconds to a first sample of
    each, in turns; four epochs in turns (forked, threads, threads,
    forked), bitwise equal in losses and parameters, with their seconds and
    a profiled epoch of each (the device's busy share); a tensorize that
    raises on its 5th sample in the forked child (RuntimeError with the
    child's traceback, then the phase goes on); DistributedModelTrainer at
    world 1 (NCCL) with and without the fork, bitwise; no child left.
    Returns the launch counts of the path."""
    import multiprocessing

    from ptgnn_tpu_torch.ops import segment_kernels as sk

    name = "multiprocess-tensorize"
    t_phase = time.perf_counter()
    train, valid = epochs
    label = {True: "forked", False: "threads"}
    firsts = {True: [], False: []}
    for mp_on in MT_ORDER:
        firsts[mp_on].append(first_sample_seconds(model, train, mp_on))
    costs = host_tensorize_costs(model, train)
    phase(name, f"host seconds over the {len(train)} graphs in one thread: tensorize {costs['tensorize_s']:.3f}, "
          f"pickle {costs['pickle_s']:.3f} (the child's), unpickle {costs['unpickle_s']:.3f} (the parent's), "
          f"{costs['mbytes']:.1f} MB pickled")
    sk.reset_launch_counts()  # the multiprocess-tensorize path starts here
    runs = {True: [], False: []}
    for i, mp_on in enumerate(MT_ORDER):
        runs[mp_on].append(g2c_epoch(model, train, valid, dev, use_multiprocessing=mp_on, name=f"mt-{i}"))
    busy = {mp_on: g2c_epoch(model, train, valid, dev, use_multiprocessing=mp_on, profiled=True,
                             name=f"mt-{label[mp_on]}-profiled")["busy"] for mp_on in (True, False)}
    received, last_line = planted_tensorize_error(model, train)
    phase(name, f"a tensorize raising on its 5th sample in the forked child: {received} samples, then "
          f"RuntimeError with the child's traceback ({last_line!r}); the phase goes on")
    dp = world_one(lambda: {mp_on: dp_epoch(model, train[:DP_EPOCH_GRAPHS], valid, dev, zero1=True, accumulate=1,
                                            eager_steps=False, name=f"mt-dp-{label[mp_on]}", parallelize=True,
                                            use_multiprocessing=mp_on) for mp_on in (True, False)})
    counts = launch_counts()  # the multiprocess-tensorize path ends here
    for mp_on in (True, False):
        phase(name, f"{label[mp_on]} tensorize: first sample {[round(t, 4) for t in firsts[mp_on]]} s after the "
              f"call; ModelTrainer epoch ({runs[mp_on][0]['steps']} steps over {len(train)} graphs, compiled, "
              f"prefetch 2) {[round(r['seconds'], 3) for r in runs[mp_on]]} s (in turns forked, threads, threads, "
              f"forked); device busy {100 * busy[mp_on]:.1f} % of a profiled epoch + validation on {card}")
    first = runs[True][0]
    if not all(same_epoch(first, r) for r in runs[True][1:] + runs[False]):
        raise RuntimeError("the epochs with the forked and the thread-pool tensorize differ")
    a, b = dp[True], dp[False]
    apart = [key for key in b["state"] if not bitwise_equal(a["state"][key], b["state"][key])]
    if a["losses"] != b["losses"] or apart or a["metrics"] != b["metrics"] or not a["losses"]:
        raise RuntimeError(f"{name}: DistributedModelTrainer forked != threads: losses {a['losses']} / "
                           f"{b['losses']}, tensors apart {apart[:6]}")
    for run in dp.values():
        run["dp"].clear()
    left = multiprocessing.active_children()
    if left:
        raise RuntimeError(f"tensorize children still alive after the phase: {left}")
    phase(name, f"the four epochs bitwise equal (losses and parameters); DistributedModelTrainer (world 1, NCCL, "
          f"ZeRO-1) {len(a['losses'])} steps forked and threads bitwise equal (losses, {len(a['state'])} tensors, "
          f"validation metrics), epoch {a['seconds']:.3f} s forked, {b['seconds']:.3f} s threads; no child left; "
          f"launches {counts}; phase total {time.perf_counter() - t_phase:.1f} s on {card}")
    return counts


def linear_residual_phase(dev, card):
    """The benchmark Graph2Class stack at width 64 with its two concat
    residuals replaced by LinearResidualLayers
    (``harness.LinearResidualStackCreator``): one eval forward on the card
    (8 extremum and 8 broadcast launches), its logits against the CPU's
    under the parity phase's limits, and one train step (dropout 0) held
    against the CPU with ``step_against_cpu`` (17 sum, 24 broadcast and 8
    extremum launches: the residuals are dense products). Returns the launch
    counts of the path."""
    from ptgnn_tpu_torch.implementations.typilus.harness import bench_graph_count, build_graph2class
    from ptgnn_tpu_torch.implementations.typilus.train import default_padding
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    name = "linear-residual"
    t0 = time.perf_counter()
    model, module, minibatches = build_graph2class(
        padding=default_padding(), num_metadata_graphs=bench_graph_count(NUM_BATCHES), mean_nodes=2500,
        max_graph_nodes=8000, hidden_state_size=64, seed=SEED, num_minibatches=1, minibatch_size=300, device=dev,
        architecture="linear-residual")
    module.eval()
    batch = (minibatches[0]["batch"].to(dev), torch.from_numpy(minibatches[0]["target_classes"]).to(dev))
    kinds = [type(layer).__name__ for layer in module.gnn.message_passing_layers]
    residuals = [i for i, kind in enumerate(kinds) if kind == "LinearResidualLayer"]
    if residuals != [4, 10]:
        raise RuntimeError(f"{name}: unexpected stack {kinds}")
    phase(name, f"setup {time.perf_counter() - t0:.2f} s; stack {kinds}; residual weights "
          f"{[tuple(module.gnn.message_passing_layers[i].linear.weight.shape) for i in residuals]}")
    sk.reset_launch_counts()  # the linear-residual path starts here
    with torch.inference_mode():
        gpu_logits = module._logits(batch[0], train=False)[0].cpu().numpy()
        loss, _ = module(*batch)
    forward_counts = launch_counts()
    _, _, grads = step_against_cpu(model, g2c_minibatch(batch), minibatches[0], dev, name)
    counts = launch_counts()  # the linear-residual path ends here
    want = add_counts(Launches({k: 2 * v for k, v in PER_FORWARD.items()}), Launches(PER_TRAIN_STEP))
    if forward_counts != {k: 2 * v for k, v in PER_FORWARD.items()} or counts != want:
        raise RuntimeError(f"{name}: launches {forward_counts} over two forwards and {counts} with the step, "
                           f"expected {want}")
    cpu_module = model.build_neural_module(device="cpu", seed=SEED).eval()
    with torch.inference_mode():
        cpu_logits = cpu_module._logits(minibatches[0]["batch"].to("cpu"), train=False)[0].numpy()
    atol = 1e-4 * float(np.abs(cpu_logits).max())
    np.testing.assert_allclose(gpu_logits, cpu_logits, rtol=1e-4, atol=atol)
    residual_grads = {n: float(g.abs().max()) for n, g, _ in grads if ".linear.weight" in n and "passing" in n}
    if len(residual_grads) != 2 or not all(v > 0 for v in residual_grads.values()) or not np.isfinite(float(loss)):
        raise RuntimeError(f"{name}: residual gradients {residual_grads}, eval loss {float(loss)}")
    phase(name, f"eval loss {float(loss):.6f}; logits card vs CPU max abs err "
          f"{float(np.abs(gpu_logits - cpu_logits).max()):.3e} (rtol 1e-4, atol {atol:.3e} = 1e-4 x max|logit|); "
          f"residual weight gradients max|g| {residual_grads}; launches {counts} on {card}")
    return counts


def oom_phase(dev, card, model, epochs):
    """A real device OOM: the allocator is capped between what a compiled
    epoch of benchmark batches holds at its peak (the warm-ups and the
    graphs' pools of its train and eval steps) and that plus half the peak
    of one oversized batch's eager step (a 16,384-node padding, whose
    warm-up runs beside the benchmark step's pool); an epoch with that batch
    in it skips it under catch_device_ooms and raises without."""
    import logging

    from ptgnn_tpu_torch.core.trainer import module_loss, optimizer_step
    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.implementations.typilus.train import default_padding
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.utils.autotune import clone_with_padding
    from ptgnn_tpu_torch.utils.oom import is_oom_error

    name = "oom"
    train, valid = epochs
    train = train[:18]
    normal = first_minibatch(model, train)
    for big_nodes in (16384, 32768):
        big_model = clone_with_padding(model, default_padding(big_nodes))
        big_mb, big_raw = next(iter(big_model.minibatch_iterator(
            big_model.tensorize_dataset(iter(train), parallelize=False, return_input_data=True),
            max_minibatch_size=300, parallelize=False)))
        torch.cuda.synchronize()
        gc.collect()  # earlier phases' compiled steps (a step and its graphs hold each other)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        module = model.build_neural_module(device=dev, seed=SEED)
        optimizer = torch.optim.Adam(module.parameters(), lr=2.5e-4)

        def peak(mb):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loss, _ = module_loss(module, tree_to(mb, dev), train=True, generator=torch.Generator(device=dev))
            loss.backward()
            optimizer_step(module, optimizer, [2.5e-4], clip_gradient_norm=1.0)
            torch.cuda.synchronize()
            return torch.cuda.max_memory_reserved() - base

        normal_peak, big_peak = peak(normal), peak(big_mb)
        del module, optimizer
        torch.cuda.empty_cache()
        if big_peak >= 1.6 * normal_peak:
            break
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g2c_epoch(model, train, valid, dev, name="oom-probe")
    torch.cuda.synchronize()
    epoch_peak = torch.cuda.max_memory_reserved() - base
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = base + epoch_peak + big_peak / 2
    phase(name, f"peaks over the {base / 2**20:.0f} MiB already reserved: eager steps of the benchmark batch "
          f"{normal_peak / 2**20:.0f} MiB and of a {big_nodes}-node batch ({int(big_mb['batch'].num_nodes)} nodes) "
          f"{big_peak / 2**20:.0f} MiB; a compiled epoch of benchmark batches {epoch_peak / 2**20:.0f} MiB; "
          f"allocator capped at {cap / 2**20:.0f} MiB of {total / 2**20:.0f}")
    caught = []

    class Caught(logging.Handler):
        def emit(self, record):
            if "device OOM" in record.getMessage():
                caught.append(record.getMessage())

    handler = Caught()
    logger = logging.getLogger("ptgnn_tpu_torch.core.trainer")
    logger.addHandler(handler)
    sk.reset_launch_counts()  # the oom path starts here
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        t0 = time.perf_counter()
        run = g2c_epoch(model, train, valid, dev, catch_device_ooms=True, inject=(2, big_mb, big_raw), name="oom")
        t_caught = time.perf_counter() - t0
        raised = None
        try:
            g2c_epoch(model, train, valid, dev, inject=(2, big_mb, big_raw), name="oom-uncaught")
        except RuntimeError as error:  # kept as text: the traceback holds the failed step's tensors
            raised = (type(error).__name__, str(error).splitlines()[0][:160],
                      is_oom_error(error) and isinstance(error, torch.cuda.OutOfMemoryError))
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        logger.removeHandler(handler)
        torch.cuda.empty_cache()
    counts = launch_counts()  # the oom path ends here
    phase(name, f"catch_device_ooms on: the epoch ended in {t_caught:.2f} s after {len(run['losses'])} steps, "
          f"{len(caught)} minibatch skipped ({caught[:1]}); off: {raised}; launches {counts}")
    if len(caught) != 1 or raised is None or not raised[2]:
        raise RuntimeError(f"expected one skipped OOM and a raised torch.OutOfMemoryError, got {caught}, {raised}")
    if not all(math.isfinite(loss) for loss in run["losses"]):
        raise RuntimeError("non-finite losses after the skipped OOM")
    return counts


def autotune_phase(dev, card):
    """``typilus train --autotune`` through the CLI's main over the full
    default grid on synthetic folds of the benchmark's graphs: every
    candidate's median ms/step and edges/s and the pick; then K1-K3 against
    their plain versions on the picked padding's layout."""
    import io as stdio
    import os

    from ptgnn_tpu_torch.implementations.typilus import train as typilus_train
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.utils.io import write_jsonl_gz
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    name = "autotune"
    root = Path(__file__).resolve().parent / "build" / "chip_smoke" / "autotune"
    shutil.rmtree(root, ignore_errors=True)
    folds, written = [], []
    for i, (fold, count) in enumerate((("train", 24), ("valid", 6), ("test", 6))):
        (root / fold).mkdir(parents=True)
        written.append(list(synthetic_typilus_graphs(count, seed=SEED + 60 + i, mean_nodes=2500, max_nodes=8000)))
        write_jsonl_gz(root / fold / "part0.jsonl.gz", written[-1])
        folds.append(str(root / fold))
    sweeps = []
    real = typilus_train.autotune_task_model

    def recording(*args, **kwargs):
        t0 = time.perf_counter()
        tuned, results = real(*args, **kwargs)
        sweeps.append((tuned, results, time.perf_counter() - t0))
        return tuned, results

    argv, cwd = sys.argv, os.getcwd()
    typilus_train.autotune_task_model = recording
    sys.argv = ["typilus-train", *folds, str(root / "tuned.pkl.gz"), "--max-num-epochs", "1", "--autotune",
                "--quiet"]
    os.chdir(root)  # the train CLI's log file goes under the working directory
    sk.reset_launch_counts()  # the autotune path starts here
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdio.StringIO()) as out:
            typilus_train.main()
    finally:
        typilus_train.autotune_task_model = real
        sys.argv = argv
        os.chdir(cwd)
    counts = launch_counts()  # the autotune path ends here
    t_cli = time.perf_counter() - t0
    (tuned, results, t_sweep), = sweeps
    for r in sorted(results, key=lambda r: (r.padding.max_nodes, r.padding.max_edge_slots)):
        phase(name, f"max_nodes {r.padding.max_nodes} slots {r.padding.max_edge_slots}: "
              + (f"infeasible ({r.error[:120]})" if r.error else
                 f"{r.ms_per_step:.3f} ms/step (median of 3 x 20), {r.edges_per_sec:.0f} edges/s, "
                 f"{r.real_edges} edges of {r.real_graphs} graphs"))
    pick = results[0].padding
    phase(name, f"pick: max_nodes {pick.max_nodes}, {pick.max_edge_slots} slots; sweep {t_sweep:.1f} s, CLI "
          f"(sweep + 1 epoch + test) {t_cli:.1f} s on {card}; '{out.getvalue().strip().splitlines()[-1]}'; "
          f"launches {counts}")
    if tuned.gnn_model.padding != pick or any(r.error for r in results[:1]):
        raise RuntimeError("the CLI did not train at the sweep's pick")
    host = first_minibatch(tuned, written[0])
    adj = host["batch"].to(dev).adjacency
    gen = torch.Generator(device=dev).manual_seed(SEED)
    held = []
    for kind in ("segment_sum", "segment_extremum", "broadcast_to_edges"):
        k = layout_kernel(kind, adj, 64, dev, gen)
        x = k.make()
        got, plain = k.kernel(x), k.plain(x)
        err = float((got - plain).abs().max())
        if kind == "segment_sum":
            ok = not bool((((got - plain).abs()) > 1e-5 * k.plain(x.abs())).any())
        else:
            ok = bitwise_equal(got, plain)
        held.append(f"{kind} max abs err {err:.3e}")
        if not ok:
            raise RuntimeError(f"{kind} != its plain version on the picked layout")
    phase(name, f"on the picked layout ({adj.mask.shape[0]} slots, {int(adj.mask.sum())} real): K2 and K3 bitwise "
          f"their plain versions, K1 within 1e-5 x sum|x|: {held}")
    return counts


def checkpoint_round_trip(model, mbs, dev, root: Path, rank: int = 0, world: int = 1, eps: float = 1e-8) -> dict:
    """DistributedCheckpointer with ZeRO-1 (Adam, ``eps``) over the process
    group: steps on device-resident minibatches ``mbs`` (step i takes
    ``mbs[(i * world + rank) % len(mbs)]``), an async save after step 3
    while steps 4-5 run, a restore into a fresh module and optimizer, the
    resumed step 4 (through the fresh module's own DataParallel), then
    saves of steps 4 and 5 with max_to_keep 2.

    At world 1 the resumed step 4 is held bitwise against the uninterrupted
    one, which ran through the DataParallel of steps 1-3. Over more ranks
    it need not be: a DDP's first iteration reduces over its initial
    buckets and later ones over its rebuilt buckets, and over three ranks
    or more the all-reduce adds an element's partials in an order that may
    depend on its place in the bucket. There the resumed step is held bitwise against
    a twin run, steps 1-3 replayed from the same seed (its state bitwise
    the saved one) and step 4 through a new DataParallel, and its distance
    from the uninterrupted step is returned (``drift``: the worst max |a -
    b| over max |b| of any parameter). Returns the verdicts (parameters,
    this rank's Adam moments and steps, the resumed step; the steps and
    sidecars kept), the seconds of the save, commit and restore, and the
    saved step's bytes and files."""
    import torch.distributed as dist

    from ptgnn_tpu_torch.core.dcp_checkpoint import DistributedCheckpointer
    from ptgnn_tpu_torch.parallel.dp import DataParallel, zero1_optimizer

    lr = 2.5e-4

    def fresh(seed):
        module = model.build_neural_module(device=dev, seed=seed)
        optimizer = zero1_optimizer(module.parameters(), lambda p: torch.optim.Adam(p, lr=lr, eps=eps))
        return module, optimizer, DataParallel(module)

    def step(trio, i, dp=None):
        module, optimizer, dp = trio[0], trio[1], dp or trio[2]
        generator = torch.Generator(device=dev).manual_seed(SEED + i)
        dp.train_step(mbs[(i * world + rank) % len(mbs)], 1.0, generator, optimizer, [lr], clip_gradient_norm=1.0)

    def state(trio):
        module, optimizer, _ = trio
        names = {id(p): n for n, p in module.named_parameters()}
        return ({n: p.detach().clone() for n, p in module.named_parameters()},
                {names[id(p)]: {k: v.clone() for k, v in st.items()} for p, st in optimizer.optim.state.items()})

    def same_params_as(params, want):
        return all(bitwise_equal(params[k], want[k]) for k in want)

    def same_moments_as(moments, want):
        return moments.keys() == want.keys() and all(
            bitwise_equal(moments[n][k].to(want[n][k].device), want[n][k]) for n in want for k in want[n])

    trio = fresh(SEED)
    for i in range(3):
        step(trio, i)
    params3, moments3 = state(trio)
    ckpt = DistributedCheckpointer(root, max_to_keep=2)
    synchronize()
    t0 = time.perf_counter()
    ckpt.save(3, trio[0], trio[1], model=model)
    t_stage = time.perf_counter() - t0
    step(trio, 3)
    params4, _ = state(trio)
    step(trio, 4)
    synchronize()
    t0 = time.perf_counter()
    ckpt.wait()
    t_commit = time.perf_counter() - t0
    other = fresh(SEED + 1)
    synchronize()
    t0 = time.perf_counter()
    restored_step = ckpt.restore(module=other[0], optimizer=other[1])
    synchronize()
    t_restore = time.perf_counter() - t0
    got_params, got_moments = state(other)
    same_params, same_moments = same_params_as(got_params, params3), same_moments_as(got_moments, moments3)
    step(other, 3)
    resumed, _ = state(other)
    out = {}
    if world == 1:
        same_step = same_params_as(resumed, params4)
    else:
        twin = fresh(SEED)
        for i in range(3):
            step(twin, i)
        twin_params, twin_moments = state(twin)
        twin_ok = same_params_as(twin_params, params3) and same_moments_as(twin_moments, moments3)
        step(twin, 3, DataParallel(twin[0]))
        twin4, _ = state(twin)
        same_step = twin_ok and same_params_as(resumed, twin4)
        out = {"twin_replayed": twin_ok, "drift": worst_apart(resumed, params4),
               "fresh_is_uninterrupted": same_params_as(twin4, params4)}
    ckpt.save(4, trio[0], trio[1], model=model)
    ckpt.save(5, trio[0], trio[1], model=model, wait=True)
    if dist.is_initialized():
        dist.barrier()  # rank 0 applies the retention
    kept = ckpt.all_steps()
    sidecars = sorted(p.name for p in root.glob("*.model.pkl.gz"))
    loaded = type(ckpt.restore_model()).__name__
    ckpt.close()
    files = list((root / "5").iterdir())
    return {"same_params": same_params, "same_moments": same_moments, "same_step": same_step,
            "restored_step": restored_step, "kept": kept, "sidecars": sidecars, "loaded": loaded,
            "moment_tensors": sum(len(v) for v in moments3.values()), "stage_s": t_stage, "commit_s": t_commit,
            "restore_s": t_restore, "bytes": sum(p.stat().st_size for p in files), "files": len(files), **out,
            "ok": bool(same_params and same_moments and same_step and restored_step == 3 and kept == [4, 5]
                       and sidecars == ["4.model.pkl.gz", "5.model.pkl.gz"])}


def checkpoint_phase(dev, card, model, batches):
    """DistributedCheckpointer at world 1 over NCCL with ZeRO-1
    (``checkpoint_round_trip``): an async save after step 3 while steps 4-5
    run; a restore into a fresh module and optimizer (parameters and both
    Adam moments bitwise); the resumed step 4 bitwise the uninterrupted
    one; retention."""
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    name = "checkpoint"
    root = Path(__file__).resolve().parent / "build" / "chip_smoke" / "dcp"
    shutil.rmtree(root, ignore_errors=True)
    sk.reset_launch_counts()  # the checkpoint path starts here
    r = world_one(lambda: checkpoint_round_trip(model, [g2c_minibatch(b) for b in batches], dev, root))
    counts = launch_counts()  # the checkpoint path ends here
    phase(name, f"ZeRO-1 at world 1 over NCCL: save after step 3 returned in {r['stage_s']:.3f} s (the state staged "
          f"on the host), steps 4-5 ran, commit waited {r['commit_s']:.3f} s more; restore {r['restore_s']:.3f} s "
          f"(step {r['restored_step']}); a step is {r['bytes']} bytes in {r['files']} files on {card}")
    phase(name, f"restored parameters bitwise {r['same_params']}, Adam moments and steps bitwise "
          f"{r['same_moments']} ({r['moment_tensors']} tensors); resumed step 4 bitwise the uninterrupted "
          f"step 4: {r['same_step']}; after saving steps 4 and 5 with max_to_keep 2 the steps are {r['kept']}, the "
          f"sidecars {r['sidecars']}, restore_model gives a {r['loaded']}")
    if not r["ok"]:
        raise RuntimeError("the checkpoint round trip or retention failed")
    phase(name, f"launches {counts}")
    return counts


def profiling_phase(dev, card, model, batches):
    """profile_trace around 3 Graph2Class train steps: a Chrome trace with
    the hand kernels under their symbols, and mp_layer_roofline's bound of
    one MLP-MP layer beside that layer's traced device time."""
    from ptgnn_tpu_torch.core.trainer import module_loss, optimizer_step
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.utils.profile_serving import device_us_by_layer, label_layer_ranges, layer_label
    from ptgnn_tpu_torch.utils.profiling import H100_SXM_FLOAT32_FLOPS, mp_layer_roofline, profile_trace

    name = "profiling"
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / "profile"
    module = model.build_neural_module(device=dev, seed=SEED)
    optimizer = torch.optim.Adam(module.parameters(), lr=2.5e-4)
    layers = module.gnn.message_passing_layers
    handles = label_layer_ranges(layers)
    generator = torch.Generator(device=dev)
    steps = 3

    def step(i):
        generator.manual_seed(SEED + i)
        loss, _ = module_loss(module, g2c_minibatch(batches[i % len(batches)]), train=True, generator=generator)
        loss.backward()
        optimizer_step(module, optimizer, [2.5e-4], clip_gradient_norm=1.0)

    step(0)
    torch.cuda.synchronize()
    sk.reset_launch_counts()  # the profiling path starts here
    with profile_trace(out_dir) as prof:
        for i in range(steps):
            step(1 + i)
    counts = launch_counts()  # the profiling path ends here
    for h in handles:
        h.remove()
    trace = (out_dir / "trace.json").read_text()
    symbols = {k: k in trace for k in ("segment_sum_kernel", "segment_extremum_kernel", "broadcast_rows_kernel")}
    by_layer = device_us_by_layer(prof.events())
    position = next(i for i, layer in enumerate(layers) if type(layer).__name__ == "MlpMessagePassingLayer")
    label = layer_label(position, layers[position])
    traced_ms = sum(by_layer.get(label, ())) / 1e3 / steps
    adj = batches[0][0].adjacency
    roof = mp_layer_roofline(adj.mask.shape[0], 64, 64, adj.agg_counts.numel(), bytes_per_el=4)
    bounds = roof.time_bounds_ms(peak_flops=H100_SXM_FLOAT32_FLOPS)
    phase(name, f"trace {out_dir / 'trace.json'} ({len(trace)} bytes) over {steps} train steps; kernel symbols "
          f"in it {symbols}; launches {counts}")
    phase(name, f"'{label}' (float32, {adj.mask.shape[0]} slots, width 64): traced {traced_ms:.4f} device ms a step "
          f"(forward + backward) against mp_layer_roofline's bound {max(bounds.values()):.4f} ms "
          f"({roof.flops} flops, {roof.hbm_bytes} bytes; compute {bounds['compute_ms']:.4f}, memory "
          f"{bounds['memory_ms']:.4f} at the H100 SXM datasheet's 67 TFLOP/s and 3.35 TB/s) on {card}")
    if not all(symbols.values()) or traced_ms <= 0:
        raise RuntimeError(f"the trace lacks a hand kernel ({symbols}) or the layer's time ({traced_ms} ms)")
    return counts


COMPILED_STEPS = 10  # eager against compiled, bit for bit
TIMED_RUNS, TIMED_STEPS = 3, 20  # ms/step: the median of 3 runs of 20 steps
PROFILED_STEPS = 10  # the busy share: one profiled run


def eager(step):
    """``step`` (a TrainStep) with its compiled steps replaced by the
    functions they compile: the same step, called directly."""
    from ptgnn_tpu_torch.core.compiled_step import CompiledStep

    for name in ("train_step", "grad_step", "apply_step"):
        compiled = getattr(step, name)
        if isinstance(compiled, CompiledStep):
            setattr(step, name, compiled.fn)
    return step


def step_runs(model, mbs, dev, *, amp, compiled, lr=2.5e-4, timed=True):
    """A TrainStep (clip 1.0, Adam) from the model's seeded weights, run
    compiled or eagerly: COMPILED_STEPS steps whose losses and state are
    kept, then (``timed``) TIMED_RUNS runs of TIMED_STEPS timed steps and
    a run of PROFILED_STEPS, profiled. Returns the results and the steps it
    ran on the card."""
    from ptgnn_tpu_torch.core.compiled_step import WARMUP_CALLS
    from ptgnn_tpu_torch.core.trainer import TrainStep

    module = model.build_neural_module(device=dev, seed=SEED)
    step = TrainStep(module, torch.optim.Adam(module.parameters(), lr=lr), clip_gradient_norm=1.0, amp=amp)
    if not compiled:
        eager(step)
    calls = [0]

    def run(i):
        calls[0] += 1
        step.generator.manual_seed(SEED * 1_000_003 + i)
        return step.step(mbs[i % len(mbs)])[0]

    losses = torch.stack([run(i).clone() for i in range(COMPILED_STEPS)])
    state = {f"param {k}": v.detach().clone() for k, v in module.named_parameters()}
    for k, p in module.named_parameters():
        state.update({f"adam {k} {s}": v.clone() for s, v in step.optimizer.state[p].items()})
    times, busy = timed_runs(lambda i: run(COMPILED_STEPS + i)) if timed else ([], None)
    captures = step.train_step.stats() if compiled else []
    if compiled:
        step.clear()
    return {"losses": losses, "state": state, "ms": statistics.median(times) if times else None, "times": times,
            "busy": busy,
            "captures": captures, "executions": calls[0] + WARMUP_CALLS * len(captures)}


def timed_runs(run, runs: int = TIMED_RUNS, steps: int = TIMED_STEPS, profiles: list | None = None):
    """``runs`` timed runs of ``steps`` calls ``run(0..steps-1)``, each
    between synchronisations, then one run of PROFILED_STEPS calls under
    the profiler (kept in ``profiles`` where given, with its wall seconds).
    Returns (ms per call of each timed run, the device's busy share of the
    profiled run)."""
    times, busy = [], None
    for r in range(runs + 1):
        profiled = r == runs
        with device_profile() if profiled else contextlib.nullcontext() as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(PROFILED_STEPS if profiled else steps):
                run(i)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        if profiled:
            busy = busy_share(prof, elapsed)
            if profiles is not None:
                profiles.append((prof, elapsed))
        else:
            times.append(1e3 * elapsed / steps)
    return times, busy


def eager_dp(dp):
    """``dp`` (a DataParallel) with its compiled steps replaced by the
    functions they compile: the same steps, called directly, each after the
    warm-up that its capture runs (``warmed_up``)."""
    from ptgnn_tpu_torch.core.compiled_step import CompiledStep

    for name in ("train_step_compiled", "grad_step_compiled", "apply_step_compiled", "eval_step_compiled"):
        compiled = getattr(dp, name)
        if isinstance(compiled, CompiledStep):
            setattr(dp, name, warmed_up(compiled))
    return dp


def warmed_up(compiled):
    """``compiled.fn``, called directly, after the warm-up calls that
    ``compiled`` runs before a capture (once per call signature, on the
    card; the state and generators put back after them). DDP rebuilds its
    gradient buckets in the warm-up, and over more than two ranks the
    all-reduce adds an element's partials in an order that depends on its
    place in the bucket: so the eager steps reduce over the buckets that
    the captured ones reduce over."""
    from ptgnn_tpu_torch.core.compiled_step import signature

    seen = set()

    def call(*args, **kwargs):
        if compiled.device.type == "cuda":
            key, _ = signature(args, kwargs)
            if key not in seen:
                seen.add(key)
                compiled._warm_up(torch.cuda.Stream(compiled.device), args, kwargs)
        return compiled.fn(*args, **kwargs)

    return call


def adam_state(optimizer) -> dict:
    """Both Adam moments and the step of every parameter this rank updates
    (ZeRO-1's local optimizer's)."""
    inner = getattr(optimizer, "optim", optimizer)
    return {f"adam {i} {k}": v.clone() for i, st in enumerate(inner.state.values()) for k, v in st.items()}


def dp_step_runs(model, mbs, dev, *, compiled, zero1=True, lr=2.5e-4, timed=(TIMED_RUNS, TIMED_STEPS), make=None,
                 profiles=None):
    """DataParallel's train step (ZeRO-1 or full Adam, clip 1.0) at world 1
    from the model's seeded weights, compiled or eagerly, as
    :func:`step_runs` runs a TrainStep: COMPILED_STEPS steps whose losses
    and state are kept, each with its batch's graph count as the weight and
    a learning-rate factor that changes every step, then (``timed``) the
    timed and profiled runs (``timed``: their count and length, or None).
    ``make(module) -> (train_step, data_parallel)``
    builds another step on DataParallel (EdgeParallel's, NodeParallel's);
    ``profiles`` keeps the profiled run (``timed_runs``)."""
    from ptgnn_tpu_torch.parallel import DataParallel, zero1_optimizer

    module = model.build_neural_module(device=dev, seed=SEED)

    def adam(params):
        return torch.optim.Adam(params, lr=lr)

    optimizer = zero1_optimizer(module.parameters(), adam) if zero1 else adam(module.parameters())
    if make is None:
        dp = DataParallel(module)

        def step(mb, weight, factor):
            return dp.train_step(mb, weight, None, optimizer, [lr], clip_gradient_norm=1.0, lr_factor=factor)
    else:
        train_step, dp = make(module)

        def step(mb, weight, factor):
            optimizer.param_groups[0]["initial_lr"] = lr * factor
            return train_step(mb, optimizer)
    if not compiled:
        eager_dp(dp)
    weights = [float(mb["batch"].num_graphs) for mb in mbs]  # host reads, before the timed steps

    def run(i):
        dp.generator.manual_seed(SEED * 1_000_003 + i)
        return step(mbs[i % len(mbs)], weights[i % len(mbs)], 1.0 - 0.02 * (i % 10))[0]

    losses = torch.stack([run(i).clone() for i in range(COMPILED_STEPS)])
    state = {f"param {k}": v.detach().clone() for k, v in module.named_parameters()}
    state.update(adam_state(optimizer))
    times, busy = timed_runs(lambda i: run(COMPILED_STEPS + i), *timed, profiles=profiles) if timed else ([], None)
    captures = dp.train_step_compiled.stats() if compiled and dev.type == "cuda" else []
    for attr in ("edge_group", "node_group"):
        setattr(module.gnn, attr, None)
    if compiled:
        dp.clear()
    return {"losses": losses, "state": state, "ms": statistics.median(times) if times else None, "times": times,
            "busy": busy, "captures": captures}


def held_to_eager(name, got, want):
    """Compiled against eager: bitwise, or else within rtol 1e-6 with the
    tensors that differ named; raises beyond."""
    keys = ["losses"] + list(want["state"])
    pairs = [(got["losses"], want["losses"])] + [(got["state"][k], want["state"][k]) for k in want["state"]]
    apart = [k for k, (a, b) in zip(keys, pairs) if not bitwise_equal(a, b)]
    if not apart:
        return f"bitwise equal ({len(keys)} tensors: the losses, every parameter, both Adam moments and the step)"
    rel = max(float(((a.double() - b.double()).abs() / b.double().abs().clamp_min(1e-30)).max())
              for k, (a, b) in zip(keys, pairs) if k in apart)
    message = f"NOT bitwise: {len(apart)} of {len(keys)} tensors apart ({apart[:6]}), max rel err {rel:.3e}"
    if rel > 1e-6:
        raise RuntimeError(f"{name}: compiled steps against eager {message}, beyond rtol 1e-6")
    return message + " (within rtol 1e-6)"


def compiled_phase(dev, card, model, batches, ppi_model, ppi_batches, vm_model, vm_batches, g2s_model, g2s_batches,
                   epochs):
    """The compiled steps (``core/compiled_step.py``) against the same steps
    called eagerly: COMPILED_STEPS train steps from the same weights and
    seeds bit for bit (Graph2Class at the benchmark configuration in
    float32 and bf16 AMP, dropout on; PPI bf16 with K5 in the graph;
    VarMisuse 'mlp'; Graph2Seq), ms/step and the device's busy share of
    each, the capture seconds and pool bytes; Graph2Class's predict_probs
    bitwise; ModelTrainer epochs of 17 benchmark steps with the host
    pipeline, compiled against eager, and with gradient accumulation k = 2,
    bit for bit. Returns the launch counts of the path."""
    from ptgnn_tpu_torch.core.compiled_step import WARMUP_CALLS, CompiledStep
    from ptgnn_tpu_torch.ops import segment_kernels as sk

    name = "compiled"
    t_phase = time.perf_counter()
    sk.reset_launch_counts()  # the compiled path starts here
    expected = {k: 0 for k in launch_counts()}
    g2c_mbs = [g2c_minibatch(b) for b in batches]
    cases = [("Graph2Class float32", model, g2c_mbs, False, PER_TRAIN_STEP, 2.5e-4),
             ("Graph2Class bf16 AMP", model, g2c_mbs, True, PER_TRAIN_STEP, 2.5e-4),
             ("PPI bf16 AMP", ppi_model, ppi_batches, True, PPI_PER_TRAIN_STEP["bf16"], 1e-3),
             ("VarMisuse mlp float32", vm_model, vm_batches, False, VM_PER_TRAIN_STEP["mlp"], 1e-4),
             ("Graph2Seq float32", g2s_model, g2s_batches, False, G2S_PER_TRAIN_STEP, 1e-3)]
    for label, case_model, mbs, amp, per_step, lr in cases:
        note = ""
        if label.startswith("VarMisuse"):
            # The char CNN's convolutions go through cuDNN, whose default
            # backward algorithms need not repeat their bits: eager against
            # eager first, then both under cuDNN's deterministic algorithms.
            again = [step_runs(case_model, mbs, dev, amp=amp, compiled=False, lr=lr, timed=False) for _ in range(2)]
            for run in again:
                expected = add_counts(expected, {k: v * run["executions"] for k, v in per_step.items()})
            same = all(bitwise_equal(again[0]["state"][k], again[1]["state"][k]) for k in again[0]["state"])
            note = (f" (eager against eager in cuDNN's default mode: {'bitwise' if same else 'NOT bitwise'}; the "
                    f"runs below use torch.backends.cudnn.deterministic)")
            torch.backends.cudnn.deterministic = True
        try:
            runs = {mode: step_runs(case_model, mbs, dev, amp=amp, compiled=mode == "compiled", lr=lr)
                    for mode in ("eager", "compiled")}
        finally:
            torch.backends.cudnn.deterministic = False
        verdict = held_to_eager(label, runs["compiled"], runs["eager"]) + note
        for run in runs.values():
            expected = add_counts(expected, {k: v * run["executions"] for k, v in per_step.items()})
        e, c = runs["eager"], runs["compiled"]
        captures = "; ".join(f"{cap.seconds:.3f} s, {cap.pool_bytes / 2**20:.1f} MiB" for cap in c["captures"])
        phase(name, f"{label}: {COMPILED_STEPS} steps compiled against eager {verdict}; ms/step (median of "
              f"{TIMED_RUNS} runs of {TIMED_STEPS}) compiled {c['ms']:.3f} {[round(t, 3) for t in c['times']]}, "
              f"eager {e['ms']:.3f} {[round(t, 3) for t in e['times']]} ({e['ms'] / c['ms']:.2f}x); device busy "
              f"{100 * c['busy']:.1f} % compiled, {100 * e['busy']:.1f} % eager (profiled run); "
              f"{len(c['captures'])} signature(s): capture (warm-up included) {captures} on {card}")
        got = launch_counts()
        if got != expected:
            raise RuntimeError(f"{label}: launches {got} != {expected} expected from the steps run")

    # Serving: predict_probs compiled against eager, bitwise.
    module = model.build_neural_module(device=dev, seed=SEED).eval()
    predict = CompiledStep(module.predict_probs, dev)
    ms = {}
    with torch.inference_mode():
        for batch, _ in batches:
            want = [t.clone() for t in module.predict_probs(batch)]
            got = predict(batch)
            if not all(bitwise_equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError("compiled predict_probs != eager predict_probs")
        executions = 2 * len(batches) + WARMUP_CALLS * len(predict)
        for mode, fn in (("compiled", predict), ("eager", module.predict_probs), ("compiled again", predict)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TIMED_STEPS):
                for batch, _ in batches:
                    fn(batch)
            torch.cuda.synchronize()
            ms[mode] = 1e3 * (time.perf_counter() - t0) / (TIMED_STEPS * len(batches))
            executions += TIMED_STEPS * len(batches)
    expected = add_counts(expected, {k: v * executions for k, v in PER_FORWARD.items()})
    if launch_counts() != expected:
        raise RuntimeError(f"predict_probs: launches {launch_counts()} != {expected}")
    cap = predict.stats()[0]
    phase(name, f"Graph2Class predict_probs over {len(batches)} batches: compiled bitwise equal to eager; ms/batch "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; capture {cap.seconds:.3f} s, {cap.pool_bytes / 2**20:.1f} MiB on {card}")

    # ModelTrainer epochs with the host pipeline, compiled against eager.
    t_steps = time.perf_counter() - t_phase
    train, valid = epochs
    runs = {}
    for k, modes in ((1, ("compiled", "eager", "compiled again")), (2, ("compiled", "eager"))):
        for mode in modes:
            runs[(k, mode)] = g2c_epoch(model, train, valid, dev, eager_steps=mode == "eager",
                                        gradient_accumulation_steps=k, name=f"compiled-{k}-{mode.replace(' ', '-')}")
        if not same_epoch(runs[(k, "compiled")], runs[(k, "eager")]):
            raise RuntimeError(f"the compiled ModelTrainer epoch (accumulation {k}) != the eager one")
    phase(name, "ModelTrainer epochs with the host pipeline, in turns (" + "; ".join(
        f"accumulation {k}: {runs[(k, 'eager')]['steps']} microbatches, compiled "
        + " / ".join(f"{runs[(k, m)]['seconds']:.3f}" for m in ("compiled", "compiled again") if (k, m) in runs)
        + f" s, eager {runs[(k, 'eager')]['seconds']:.3f} s" for k in (1, 2)) + "): compiled bitwise equal to "
        f"eager (losses and parameters) at both, on {card}; the steps and predict_probs took {t_steps:.1f} s "
        f"of the phase")
    counts = launch_counts()  # the compiled path ends here
    phase(name, f"launches over the compiled path {counts}; phase total {time.perf_counter() - t_phase:.1f} s")
    return counts


# Graph2Class's K3 widths (D, M and the backward's widened table, float32
# and bf16 AMP) and PPI's 256; on a 2-way node shard's layouts, D and M.
AB_WIDTHS = ((64, "float32"), (128, "float32"), (192, "float32"), (256, "float32"), (384, "float32"),
             (64, "bfloat16"), (128, "bfloat16"), (192, "bfloat16"), (384, "bfloat16"))
AB_NP_WIDTHS = ((64, "float32"), (128, "float32"))


def broadcast_ab(sources: list) -> None:
    """``chip_smoke.py --broadcast-ab SOURCE...``: the checkout's K3 against
    other sources of the same C entry (``ptgnn_broadcast_rows``; e.g. an
    earlier commit's ``csrc/broadcast_rows.cu``), each built with the same
    nvcc flags into build/broadcast-ab/, timed in turns (the checkout, the
    others, then back in reverse order) on the benchmark batch's layout at
    the Graph2Class path's widths (``AB_WIDTHS``) and on a 2-way node
    shard's interior and boundary layouts (``AB_NP_WIDTHS``), each also over
    its first tile alone (the floor): ms per launch in ``layout_times``'
    harness, each build bitwise against the plain version first; beside
    them a write-only yardstick (``torch.zeros`` of the output). One JSON
    line a (layout, width)."""
    import ctypes

    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.ops import cuda_build
    from ptgnn_tpu_torch.parallel import shard_batch_by_nodes, suggest_budgets
    from ptgnn_tpu_torch.parallel.node_sharding import local_shard

    dev = torch.device("cuda")
    cuda_build.build_all()
    cuda_build.kernel_function("broadcast")
    libs = {"checkout": cuda_build._LIBS["broadcast"]}
    out_dir = Path(__file__).resolve().parent / "build" / "broadcast-ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    _, fname, argtypes = cuda_build._SIGNATURES["broadcast"]
    for i, source in enumerate(sources):
        lib_path = out_dir / f"variant{i}.so"
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib_path), source], check=True,
                       capture_output=True, timeout=600)
        lib = ctypes.CDLL(str(lib_path))
        getattr(lib, fname).argtypes, getattr(lib, fname).restype = argtypes, ctypes.c_int
        lib.ptgnn_error_string.argtypes, lib.ptgnn_error_string.restype = [ctypes.c_int], ctypes.c_char_p
        libs[source] = lib
    order = list(libs) + list(libs)[::-1]
    _, _, minibatches, batches = build_bench(dev)
    budgets = suggest_budgets(minibatches[:1], 2, reorder="bfs")
    sharded, _ = shard_batch_by_nodes(minibatches[0], 2, reorder="bfs", **budgets)
    shard = tree_to(local_shard(sharded, 0), dev)["batch"]
    cases = [("Graph2Class batch", batches[0][0].adjacency, AB_WIDTHS),
             ("np 2-way interior", shard.adjacency, AB_NP_WIDTHS),
             ("np 2-way boundary", shard.node_sharding.adjacency_bnd, AB_NP_WIDTHS)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    card = card_line()
    try:
        for layout, adj, widths in cases:
            for width, dtype_name in widths:
                dtype = getattr(torch, dtype_name)
                ks = {"ms": layout_kernel("broadcast_to_edges", adj, width, dev, gen, dtype),
                      "floor_ms": layout_kernel("broadcast_to_edges", adj, width, dev, gen, dtype,
                                                plan=one_tile_plan(adj))}
                times = {part: {name: [] for name in libs} for part in ks}
                slots = adj.mask.shape[0]
                # A yardstick: one library kernel that only writes the output rows.
                fill_ms = graph_time_ms([lambda: torch.zeros(slots, width, dtype=dtype, device=dev)] * 16)
                for name in order:
                    cuda_build._LIBS["broadcast"] = libs[name]
                    for part, k in ks.items():
                        table = k.make()
                        if not bitwise_equal(k.kernel(table), k.plain(table)):
                            raise RuntimeError(f"{name}: broadcast != plain version on the {layout} at {width} "
                                               f"{dtype_name} ({part})")
                        inputs = rotating(k.make, k.input_bytes)
                        times[part][name].append(graph_time_ms(
                            [lambda x=inputs[i % len(inputs)], f=k.kernel: f(x) for i in range(16)]))
                        del inputs
                print(json.dumps({"layout": layout, "width": width, "dtype": dtype_name, **times, "fill_ms": fill_ms,
                                  **bound(ks["ms"].nbytes, 0), "card": card}), flush=True)
    finally:
        cuda_build._LIBS["broadcast"] = libs["checkout"]


# ---------------------------------------------------------------------------
# 32. the multi-card path: python3 chip_smoke.py --world 4
# ---------------------------------------------------------------------------
WORLD_CARDS = 4
WORLD_JOIN_S = 480  # the ranks' time limit; what is left is killed
# The legs of --world N, in their order: leg 1 (kernels) and leg 7 (cli) run
# in the parent, the rest in the ranks; --legs picks some of them.
WORLD_LEGS = ("kernels", "nccl", "dp", "edge", "node", "hybrid", "checkpoint", "epoch", "cli")
WORLD_DP_STEPS = 3  # leg 2: optimizer steps, each over one minibatch a rank
WORLD_LR = 2.5e-4
# Leg 2's Adam eps: with the default 1e-8 a step is about lr x sign(g), blind
# to the gradient's size; at 1e-3 an update's slope in g is at most lr / eps.
WORLD_ADAM_EPS = 1e-3
# Leg 2's limit after its 3 steps, in the reference's own spread: the same
# steps with the minibatches' gradients summed in other orders. A step is
# held to 1e-5 of each parameter's max, but 3 steps are not: max
# aggregation routes a gradient to one of near-tied maxima, so rounding
# flips routes and the states drift apart. On four H100s at the benchmark
# size the float32 state after 3 steps lay 1.004e-1 of a max from the
# reference, which the order of its sum alone moved 5.872e-2 (1.14e-5 and
# 2.9e-5 on the CPU at the test's size); a mean off by 5/4 moves it 0.22
# on the CPU.
WORLD_DP_SPREAD = 4
# Leg 2's clip by precision: none in float32, so that the size of the
# all-reduced mean enters the step (a clip that binds divides it out); 1.0 in
# bf16 AMP, where it binds, so that the clip is held too.
WORLD_DP_CLIP = {False: None, True: 1.0}
WORLD_SGD_LR = 0.05


class WorldSizes(NamedTuple):
    """What the multi-card legs run at: on the card the benchmark
    configuration (8192-node batches, hidden 64, the 'mlp' stack) and PPI at
    hidden 256; on the CPU (tests/test_torch_multicard.py) the small
    Graph2Class of tests/test_torch_node_sharded_trainer.py (256-node
    batches, hidden 32) and a small PPI."""

    hidden: int
    minibatch_size: int  # the trainers' samples a minibatch
    graph_kw: dict  # synthetic_typilus_graphs' sizes
    padding: Callable  # the Graph2Class trainers' BatchPadding
    timed: tuple | None  # the timed runs of the compiled steps (count, length), None on the CPU


def world_sizes(dev) -> WorldSizes:
    from ptgnn_tpu_torch.implementations.typilus.harness import small_padding
    from ptgnn_tpu_torch.implementations.typilus.train import default_padding

    if dev.type == "cuda":
        return WorldSizes(64, 300, dict(mean_nodes=2500, max_nodes=8000), default_padding, SHARDED_TIMED)
    return WorldSizes(32, 4, dict(mean_nodes=30, max_nodes=80),
                      lambda: small_padding(max_nodes=256, max_graphs=8), None)


def world_graphs(sizes: WorldSizes, count: int, seed: int) -> list:
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    return list(synthetic_typilus_graphs(count, seed=seed, **sizes.graph_kw))


def g2c_world_model(sizes: WorldSizes, dropout_rate: float = 0.0):
    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model

    return create_graph2class_gnn_model(hidden_state_size=sizes.hidden, dropout_rate=dropout_rate,
                                        padding=sizes.padding())


def full_batches(sizes: WorldSizes, count: int, seed: int) -> list:
    """Graphs that make exactly ``count`` full minibatches in order (the
    trainers drop the partial one that the last graph opens)."""
    probe = g2c_world_model(sizes)
    every = world_graphs(sizes, 4 * count + 16, seed)
    probe.compute_metadata(iter(every), parallelize=False)
    batched = [raw for _, raw in probe.minibatch_iterator(
        probe.tensorize_dataset(iter(every), parallelize=False, return_input_data=True),
        max_minibatch_size=sizes.minibatch_size, parallelize=False)]
    if len(batched) <= count:
        raise RuntimeError(f"{len(every)} graphs make {len(batched)} minibatches, fewer than {count + 1}")
    return [g for raw in batched[:count] for g in raw] + batched[count][:1]


def host_minibatches(model, graphs_, sizes: WorldSizes) -> list:
    """(host minibatch, its real samples) of ``graphs_`` in order, full
    minibatches only: the groups the distributed trainers form."""
    return [(mb, len(raw)) for mb, raw in model.minibatch_iterator(
        model.tensorize_dataset(iter(graphs_), parallelize=False), max_minibatch_size=sizes.minibatch_size,
        yield_partial_minibatches=False, shuffle_input=False, parallelize=False)]


# Node sharding splits a graph too large for one card: PPI's graph 4 times
# over (its widths and edge density), so that each of 4 shards' boundary
# layout holds the 32 MB gathered stack that opens K5's gate.
WORLD_PPI_SCALE = 4


def world_ppi(dev):
    """PPI at its reference width (hidden 256, 50 features, 121 labels, 14.4
    edges a node) on graphs of WORLD_PPI_SCALE times its published node
    count in batches of WORLD_PPI_SCALE x 4,096 nodes on the card; small on
    the CPU. Returns (model, host minibatches)."""
    from ptgnn_tpu_torch.graph.structs import BatchPadding
    from ptgnn_tpu_torch.implementations.ppi.harness import PPI_GRAPH_SIZES, build_ppi, synthetic_ppi_samples
    from ptgnn_tpu_torch.implementations.ppi.train import create_ppi_gnn_model, ppi_padding

    if dev.type == "cuda":
        sizes = {**PPI_GRAPH_SIZES, "mean_nodes": WORLD_PPI_SCALE * PPI_GRAPH_SIZES["mean_nodes"]}
        samples = synthetic_ppi_samples(1, SEED, **sizes)
        model = create_ppi_gnn_model(hidden_state_size=256, padding=ppi_padding(max_nodes=WORLD_PPI_SCALE * 4096))
        # the model's 6,000-node cap on a graph is one card's; sharded, the batch's budget holds
        model.gnn_model.max_nodes_per_graph = model.gnn_model.padding.max_nodes
        model.compute_metadata(iter(samples), parallelize=False)
        minibatches = [mb for mb, _ in model.minibatch_iterator(
            model.tensorize_dataset(iter(samples), parallelize=False), max_minibatch_size=50, parallelize=False)]
        if len(minibatches) != 1:
            raise RuntimeError(f"the scaled PPI graph made {len(minibatches)} minibatches, not one")
        return model, minibatches
    pad = BatchPadding(max_nodes=512, max_edge_slots=128 * 96, max_graphs=4, edge_tile=128, agg_rows=128)
    model, _, minibatches = build_ppi(padding=pad, samples=synthetic_ppi_samples(
        2, 3, mean_nodes=200, edges_per_node=6, num_features=12, num_labels=5), hidden_state_size=32,
        minibatch_size=2, seed=SEED, device=dev)
    return model, minibatches


WORLD_EPOCH_GRAPHS = 288  # about 88 benchmark batches: 22 steps a rank at world 4
WORLD_EPOCHS = 2  # the first captures the steps; the second is timed as the steady state
WORLD_DIGEST_GROUPS = 3  # the epoch leg holds each rank's slots of the first groups against an in-process oracle


def host_digest(tree) -> str:
    """A sha256 of a host minibatch: each leaf's place, type, dtype, shape
    and bytes, in the tree's order (NamedTuples, dicts, lists, tuples)."""
    import hashlib

    h = hashlib.sha256()

    def walk(obj, path):
        if isinstance(obj, torch.Tensor):
            obj = obj.numpy()
        if isinstance(obj, (np.ndarray, np.generic)):
            arr = np.ascontiguousarray(obj)
            h.update(f"{path}:{arr.dtype.str}:{arr.shape};".encode())
            h.update(arr.view(np.uint8).tobytes())
        elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
            h.update(f"{path}:{type(obj).__name__};".encode())
            for name, x in zip(obj._fields, obj):
                walk(x, f"{path}.{name}")
        elif isinstance(obj, dict):
            for k in sorted(obj):
                walk(obj[k], f"{path}[{k!r}]")
        elif isinstance(obj, (list, tuple)):
            for i, x in enumerate(obj):
                walk(x, f"{path}[{i}]")
        else:
            h.update(f"{path}={obj!r};".encode())

    walk(tree, "")
    return h.hexdigest()


class HostWork:
    """Counts and times, in this process, the host work that a node's
    assembler does, by wrapping the methods of ``model``'s class (and of the
    port's modules) while the context is open: ``tensorize_dataset`` calls,
    forked tensorize children (``BufferedIterator``) and their CPU seconds
    once joined (``RUSAGE_CHILDREN``), in-process ``tensorize`` calls and
    seconds, the assembling (``initialize_minibatch``, ``can_add_to_minibatch``,
    ``extend_minibatch_with``) and finalizing seconds, and the reshards
    (``shard_batch_by_nodes``). Safe across the assembling threads."""

    def __init__(self, model):
        import threading

        self.cls = type(model)
        self.calls = {k: 0 for k in ("tensorize_dataset", "children", "tensorize", "finalize", "reshard")}
        self.seconds = {k: 0.0 for k in ("tensorize", "assemble", "finalize", "reshard", "children_cpu")}
        self._lock = threading.Lock()
        self._undo: list = []

    def _add(self, calls: str | None, seconds: str | None, dt: float) -> None:
        with self._lock:
            if calls:
                self.calls[calls] += 1
            if seconds:
                self.seconds[seconds] += dt

    def _wrap(self, owner, name: str, calls: str | None, seconds: str | None) -> None:
        real = getattr(owner, name)
        had = name in vars(owner)

        @functools.wraps(real)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self._add(calls, seconds, time.perf_counter() - t0)

        setattr(owner, name, timed)
        self._undo.append(lambda: setattr(owner, name, real) if had else delattr(owner, name))

    def __enter__(self) -> "HostWork":
        import resource

        from ptgnn_tpu_torch.core import model as model_module
        from ptgnn_tpu_torch.parallel import node_sharding

        work = self
        real_buffered = model_module.BufferedIterator

        class CountedBufferedIterator(real_buffered):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                if self.process is not None:
                    work._add("children", None, 0.0)

        model_module.BufferedIterator = CountedBufferedIterator
        self._undo.append(lambda: setattr(model_module, "BufferedIterator", real_buffered))
        self._wrap(self.cls, "tensorize_dataset", "tensorize_dataset", None)
        self._wrap(self.cls, "tensorize", "tensorize", "tensorize")
        for name in ("initialize_minibatch", "can_add_to_minibatch", "extend_minibatch_with"):
            self._wrap(self.cls, name, None, "assemble")
        self._wrap(self.cls, "finalize_minibatch", "finalize", "finalize")
        self._wrap(node_sharding, "shard_batch_by_nodes", "reshard", "reshard")
        usage = resource.getrusage(resource.RUSAGE_CHILDREN)
        self._children_cpu = usage.ru_utime + usage.ru_stime
        return self

    def __exit__(self, *exc) -> None:
        import resource

        usage = resource.getrusage(resource.RUSAGE_CHILDREN)
        self.seconds["children_cpu"] = usage.ru_utime + usage.ru_stime - self._children_cpu
        while self._undo:
            self._undo.pop()()

    def reading(self) -> dict:
        return {"calls": dict(self.calls), "seconds": dict(self.seconds)}


def world_epoch(dev, name: str) -> dict:
    """WORLD_EPOCHS DistributedModelTrainer epochs (``dp_epoch``: ZeRO-1,
    compiled, dropout 0.1, the forked tensorize on the card) over
    WORLD_EPOCH_GRAPHS benchmark graphs (24 small ones on the CPU) at the
    process group's world size as one node, each followed by validation.
    The first epoch holds the DDP warm-ups and the captures, the second
    replays the same graphs (``graphs``: the compiled train step's graphs
    at each epoch's end). Phase 30's epoch, longer, at any world size.

    Also this rank's host work in the trainer (``HostWork``: zero on every
    rank but the node's assembler) and its handoff (the slots it sent or
    received, their bytes and seconds); and, after the epochs, the oracle:
    the graphs tensorized in this thread (``tensorize_s``) and
    ``model.minibatch_iterator`` over them in this process with the first
    epoch's shuffle, whose minibatches ``g * world + rank`` (the empty
    minibatch past their end) are this rank's slots of the first groups:
    ``digests`` and ``oracle`` hold the ``host_digest`` of each."""
    import random

    import torch.distributed as dist

    from ptgnn_tpu_torch.core.trainer import shuffle_seed

    sizes = world_sizes(dev)
    train = world_graphs(sizes, WORLD_EPOCH_GRAPHS if dev.type == "cuda" else 24, SEED + 50)
    valid = world_graphs(sizes, 4, SEED + 51)
    model = g2c_world_model(sizes, dropout_rate=0.1)
    model.compute_metadata(iter(train), parallelize=False)
    digests: list = []
    with HostWork(model) as work:
        run = dp_epoch(model, train, valid, dev, zero1=True, accumulate=1, eager_steps=False, name=name,
                       epochs=WORLD_EPOCHS, slot_digests=digests, parallelize=True,
                       use_multiprocessing=dev.type == "cuda")
    run["dp"].clear()

    rank, world = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    tensorized = list(model.tensorize_dataset(iter(train), parallelize=False))
    tensorize_s = time.perf_counter() - t0
    minibatches = model.minibatch_iterator(
        iter(tensorized), max_minibatch_size=DP_EPOCH_MINIBATCH, yield_partial_minibatches=False,
        shuffle_input=True, parallelize=False, shuffle_rng=random.Random(shuffle_seed(SEED, 0, 0)))
    mine = [mb for i, (mb, _) in enumerate(itertools.islice(minibatches, len(digests) * world)) if i % world == rank]
    empty = model.finalize_minibatch(model.initialize_minibatch())
    oracle = [host_digest(mine[g] if g < len(mine) else empty) for g in range(len(digests))]
    return {"seconds": run["epoch_seconds"], "steps": len(run["losses"]) // WORLD_EPOCHS, "losses": run["losses"],
            "graphs": len(train), "captured": run["graphs"], "tensorize_s": tensorize_s, "host": work.reading(),
            "handoff": run["handoff"], "handoffs": run["handoffs"], "digests": digests, "oracle": oracle}


def nccl_share(prof) -> dict:
    """Device ms of a profile by kernel class: NCCL's kernels against the
    rest, and NCCL's share."""
    nccl = other = 0.0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = getattr(evt, "self_cuda_time_total", 0.0) if us is None else us
        if "nccl" in evt.key.lower():
            nccl += us
        else:
            other += us
    return {"nccl_ms": nccl / 1e3, "other_ms": other / 1e3, "nccl_share": nccl / max(nccl + other, 1e-9)}


def params_of(module) -> dict:
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def worst_apart(got: dict, want: dict) -> tuple:
    """(the worst max |got - want| over max |want| of any tensor, its name)."""
    return max(((float((got[k].double() - w.double()).abs().max() / w.double().abs().max().clamp_min(1e-30)), k)
                for k, w in want.items()), default=(0.0, ""))


def same_tensors(a: dict, b: dict) -> list:
    """The keys whose tensors are not bitwise equal."""
    return [k for k in b if not bitwise_equal(a[k], b[k])]


class WorldRank:
    """The legs of ``python3 chip_smoke.py --world 4`` as one rank runs
    them, inside a process group of ``world`` ranks (NCCL, one card a rank;
    gloo on the CPU in tests/test_torch_multicard.py, at ``world_sizes``'
    small size). Every rank runs every leg and every collective in the same
    order. A gate that fails is recorded (``failures``) and the legs go on,
    so one run reports every gate; ``readings`` keeps the numbers."""

    def __init__(self, rank: int, world: int, dev: torch.device, tmp: Path, log):
        self.rank, self.world, self.dev, self.tmp, self.log = rank, world, dev, tmp, log
        self.sizes = world_sizes(dev)
        self.card = card_line() if dev.type == "cuda" else "cpu"
        self.failures: list = []
        self.held: list = []
        self.readings: dict = {"launches": {}}
        self.out_dir = tmp / "out"

    # -- reporting -------------------------------------------------------------
    def say(self, name: str, msg: str) -> None:
        line = f"[{name} r{self.rank}] {msg}"
        self.log.write(line + "\n")
        self.log.flush()
        if self.rank == 0:
            print(line, flush=True)

    def hold(self, name: str, ok: bool, msg: str) -> None:
        if ok:
            self.held.append(f"{name}: {msg}")
            self.say(name, "held: " + msg)
        else:
            self.failures.append(f"{name}: {msg}")
            self.say(name, "FAILED: " + msg)
            if self.rank:
                print(f"[{name} r{self.rank}] FAILED: {msg}", flush=True)

    def checked(self, name: str, fn):
        """``fn()``, a reused check that raises on its gate after its
        collectives: the raise is recorded as a failed gate."""
        try:
            return fn()
        except (RuntimeError, AssertionError) as failure:
            self.hold(name, False, str(failure))
            return None

    def barrier(self) -> None:
        import torch.distributed as dist

        synchronize()
        dist.barrier()

    # -- data --------------------------------------------------------------------
    def setup(self) -> None:
        from ptgnn_tpu_torch.graph.structs import tree_to
        from ptgnn_tpu_torch.implementations.typilus.harness import bench_graph_count, build_graph2class

        t0 = time.perf_counter()
        s = self.sizes
        kw = (dict(num_metadata_graphs=32, mean_nodes=30, max_graph_nodes=80, minibatch_size=4)
              if self.dev.type != "cuda" else
              dict(num_metadata_graphs=bench_graph_count(max(2 * self.world, NUM_BATCHES)), mean_nodes=2500,
                   max_graph_nodes=8000,
                   minibatch_size=300))
        self.model, _, self.minibatches = build_graph2class(
            padding=s.padding(), hidden_state_size=s.hidden, seed=SEED, num_minibatches=max(2 * self.world, NUM_BATCHES),
            device=self.dev, **kw)
        self.device_mbs = [tree_to(mb, self.dev) for mb in self.minibatches]
        self.dp_train = full_batches(s, self.world * WORLD_DP_STEPS, SEED + 60)
        self.valid = world_graphs(s, 4, SEED + 61)
        self.ppi_model, self.ppi_minibatches = world_ppi(self.dev)
        self.say("world-setup", f"{len(self.minibatches)} Graph2Class minibatches (graphs, nodes) "
                 f"{[(int(mb['batch'].num_graphs), int(mb['batch'].num_nodes)) for mb in self.minibatches]}, "
                 f"hidden {s.hidden}; {len(self.dp_train)} graphs for the trainers' {WORLD_DP_STEPS} steps; "
                 f"{time.perf_counter() - t0:.1f} s on {self.dev}")

    def counts_of_path(self, fn):
        """(``fn()``, the launches it made)."""
        before = launch_counts()
        out = fn()
        return out, delta(launch_counts(), before)

    def compiled_against_eager(self, name: str, key: str, what: str, local: list, make_sharder) -> None:
        """A sharded train step compiled against eager at this world
        (``sharded_compiled_against_eager``: Adam, dropout on), bitwise, and
        its ms/step (``readings[key + " ms/step"]``)."""
        out = self.checked(name, lambda: sharded_compiled_against_eager(self.model, local, self.dev, make_sharder,
                                                                         timed=self.sizes.timed))
        if out is not None:
            line, verdict, c = out
            self.hold(name, verdict.startswith("bitwise"), f"{what} (Adam, dropout on) {line}")
            if self.sizes.timed:
                self.readings[f"{key} ms/step"] = c["ms"]

    # -- NCCL's all-reduce in a graph ------------------------------------------------
    def leg_nccl(self) -> None:
        """The all-reduce of this rank's seeded floats at the sizes of the
        data-parallel step's two gradient buckets, an edge-sharded
        aggregation and the small reductions: called eagerly twice, and on
        the card replayed twice from a CUDA graph, bitwise the same sums
        (what compiled against eager rests on)."""
        import torch.distributed as dist

        name = "world-nccl"
        sizes = (262144, 1050000, 8192 * 64, 3) if self.dev.type == "cuda" else (4096, 3)
        gen = torch.Generator().manual_seed(SEED + self.rank)
        apart = []
        for n in sizes:
            x = torch.randn(n, generator=gen).to(self.dev)
            sums = []
            for _ in range(2):
                y = x.clone()
                dist.all_reduce(y)
                sums.append(y)
            if self.dev.type == "cuda":
                buf = torch.empty_like(x)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    buf.copy_(x)
                    dist.all_reduce(buf)
                for _ in range(2):
                    graph.replay()
                    sums.append(buf.clone())
                synchronize()
                graph.reset()  # before the group goes: NCCL waits for the graphs that captured it
            apart += [f"{n} floats, call {i}" for i, y in enumerate(sums[1:], 1) if not bitwise_equal(y, sums[0])]
        replayed = " and replayed twice from a CUDA graph" if self.dev.type == "cuda" else ""
        self.hold(name, not apart, f"all_reduce of {list(sizes)} floats, eager twice{replayed}: bitwise the first "
                                   f"eager sum: {not apart} {apart[:6]}")

    # -- leg 2: DistributedModelTrainer with ZeRO-1 --------------------------------
    def dp_trainer(self, amp: bool, eager_steps: bool) -> dict:
        """DistributedModelTrainer (ZeRO-1, Adam, WORLD_DP_CLIP, dropout 0) for one
        epoch of WORLD_DP_STEPS groups of one minibatch a rank, in order;
        each step's loss and parameters, Adam's state, the all-reduces, and
        the launches against the forwards and steps that ran."""
        from ptgnn_tpu_torch.parallel import DistributedModelTrainer, moment_elements

        mode = "eager" if eager_steps else "compiled"
        trainer = DistributedModelTrainer(
            g2c_world_model(self.sizes), self.out_dir / f"dp-{amp}-{mode}.pkl.gz", zero1=True, max_num_epochs=1,
            minibatch_size=self.sizes.minibatch_size, clip_gradient_norm=WORLD_DP_CLIP[amp], enable_amp=amp,
            device=self.dev, seed=SEED, optimizer_creator=lambda p: torch.optim.Adam(p, lr=WORLD_LR, eps=WORLD_ADAM_EPS),
            target_validation_metric="Accuracy", target_validation_metric_higher_is_better=True)
        trainer.load_metadata_and_create_network(self.dp_train, parallelize=False)
        module = trainer.neural_module
        initial = params_of(module)
        dp = trainer.data_parallel
        if eager_steps:
            eager_dp(dp)
        steps, optimizers = [], []
        real = dp.train_step

        def recorded(mb, weight, *args, **kwargs):
            out = real(mb, weight, *args, **kwargs)
            steps.append({"loss": float(out[0]), "weight": weight, "params": params_of(module)})
            return out

        dp.train_step = recorded
        trainer.register_training_start_hook(lambda model, module, optimizer: optimizers.append(optimizer))
        forwards, backwards = Tally(), Tally()
        hooks = [module.gnn.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1)),
                 module.node_to_class.weight.register_hook(lambda g: backwards.__setitem__(0, backwards[0] + 1))]
        t0 = time.perf_counter()
        (_, counts) = self.counts_of_path(lambda: trainer.train(
            self.dp_train, self.valid, initialize_metadata=False, validate_on_start=False, patience=0,
            parallelize=False, shuffle_training_data=False))
        synchronize()
        seconds = time.perf_counter() - t0
        for hook in hooks:
            hook.remove()
        total = 2 * sum(p.numel() for p in module.parameters())
        run = {"steps": steps, "initial": initial, "model": trainer._model, "adam": adam_state(optimizers[0]),
               "moments": moment_elements(optimizers[0]), "total_moments": total, "counts": counts,
               "forwards": forwards[0], "backwards": backwards[0], "seconds": seconds,
               "allreduce": (dp.allreduce_calls, dp.allreduce_bytes)}
        if not eager_steps:
            dp.clear()
        return run

    def weighted_mean_steps(self, model, initial: dict, amp: bool, turn: int = 0) -> list:
        """One card's steps on the weighted mean gradient sum_r w_r g_r /
        sum_r w_r of each group's minibatches (every rank computes it: the
        same work on the same data), clipped as WORLD_DP_CLIP says, the
        trainer's capturable Adam: the parameters after each step and the
        global norms before the clip. The mean is formed as DataParallel
        forms it, sum_r grad(loss_r x w_r world / sum w) / world, so that
        what differs is the order of the all-reduce's sum (in bf16 AMP the
        scale enters the bf16 backward); ``turn`` starts the sum at the
        group's minibatch ``turn``."""
        from ptgnn_tpu_torch.core.trainer import clip_by_global_norm_, make_capturable, module_loss
        from ptgnn_tpu_torch.graph.structs import tree_to

        module = model.build_neural_module(device=self.dev, seed=SEED)
        module.load_state_dict(initial, strict=False)
        optimizer = torch.optim.Adam(module.parameters(), lr=WORLD_LR, eps=WORLD_ADAM_EPS)
        make_capturable(optimizer, self.dev)
        mbs = host_minibatches(model, self.dp_train, self.sizes)
        out, norms = [], []
        for s in range(WORLD_DP_STEPS):
            group = mbs[s * self.world:(s + 1) * self.world]
            group = group[turn:] + group[:turn]
            total = torch.full((), float(sum(w for _, w in group)), device=self.dev)
            acc = {n: torch.zeros_like(p) for n, p in module.named_parameters()}
            for mb, w in group:
                module.zero_grad(set_to_none=True)
                loss, _ = module_loss(module, tree_to(mb, self.dev), train=True, amp=amp)
                (loss * (torch.full((), float(w), device=self.dev) * self.world / total)).backward()
                for n, p in module.named_parameters():
                    acc[n] += p.grad / self.world
            for n, p in module.named_parameters():
                p.grad = acc[n]
            clip = WORLD_DP_CLIP[amp]
            norms.append(float(clip_by_global_norm_([p.grad for p in module.parameters()], math.inf if clip is None
                                                    else clip)))
            optimizer.step()
            out.append(params_of(module))
        return out, norms

    def leg_dp(self) -> None:
        from ptgnn_tpu_torch.parallel.dp import DDP_WARMUP_CALLS

        name = "world-dp"
        t_leg = time.perf_counter()
        for amp in (False, True):
            label = "bf16 AMP" if amp else "float32"
            runs = {mode: self.dp_trainer(amp, mode == "eager") for mode in ("compiled", "eager")}
            c, e = runs["compiled"], runs["eager"]
            ok = len(c["steps"]) == len(e["steps"]) == WORLD_DP_STEPS
            self.hold(name, ok, f"{label}: {len(c['steps'])} optimizer steps compiled and {len(e['steps'])} eager "
                                f"(expected {WORLD_DP_STEPS}), weights {[s['weight'] for s in c['steps']]}")
            if not ok:
                continue
            want, norms = self.weighted_mean_steps(c["model"], c["initial"], amp)
            # the same steps with the minibatches' gradients summed in other orders
            turned = [self.weighted_mean_steps(c["model"], c["initial"], amp, turn=t)[0] for t in range(1, self.world)]
            for i in (0, WORLD_DP_STEPS - 1):
                worst = worst_apart(c["steps"][i]["params"], want[i])
                spread = max(worst_apart(t[i], want[i])[0] for t in turned)
                limit = 1e-5 if i == 0 else max(1e-5, WORLD_DP_SPREAD * spread)
                self.hold(name, worst[0] <= limit,
                          f"{label}: ZeRO-1 (Adam eps {WORLD_ADAM_EPS}, clip {WORLD_DP_CLIP[amp]}; the mean's global "
                          f"norms {[round(n, 4) for n in norms]}) after step {i + 1} against one card's steps on the "
                          f"weighted mean gradient of the {self.world} minibatches a step: every parameter within "
                          f"{worst[0]:.3e} of its max (limit {limit:.3e}; worst {worst[1]}); the same steps summed "
                          f"in {len(turned)} other orders up to {spread:.3e}")
            apart = [f"step {i} {k}" for i, (a, b) in enumerate(zip(c["steps"], e["steps"]))
                     for k in same_tensors(a["params"], b["params"])]
            apart += same_tensors(c["adam"], e["adam"])
            losses = [s["loss"] for s in c["steps"]], [s["loss"] for s in e["steps"]]
            self.hold(name, not apart and losses[0] == losses[1],
                      f"{label}: the trainer's compiled steps against eager at world {self.world}: losses "
                      f"{losses[0]} / {losses[1]}, parameters after every step and both Adam moments "
                      f"({len(c['adam'])} tensors) bitwise equal: {not apart} {apart[:4]}")
            share = c["moments"] / c["total_moments"]
            self.hold(name, 0.5 / self.world < share < 2.0 / self.world,
                      f"{label}: ZeRO-1 holds {c['moments']} of the {c['total_moments']} moment elements on this "
                      f"rank ({100 * share:.1f} %)")
            executions = WORLD_DP_STEPS + (DDP_WARMUP_CALLS if self.dev.type == "cuda" else 0)
            calls, nbytes = c["allreduce"]
            self.readings[f"dp {label} all-reduce per execution"] = (calls / executions, nbytes / executions)
            self.say(name, f"{label}: all-reduces per execution of the train step (of {executions}: "
                           f"{WORLD_DP_STEPS} steps and the DDP warm-ups) {calls / executions:.2f} calls, "
                           f"{nbytes / executions:.0f} bytes; epoch (3 steps + validation) {c['seconds']:.2f} s "
                           f"compiled, {e['seconds']:.2f} s eager")
            if self.dev.type == "cuda":
                for mode, run in runs.items():
                    expected = {k: PER_FORWARD[k] * run["forwards"]
                                + (PER_TRAIN_STEP[k] - PER_FORWARD[k]) * run["backwards"] for k in run["counts"]}
                    self.hold(name, run["counts"] == expected,
                              f"{label} {mode}: this rank's launches {dict(run['counts'])} from {run['forwards']} "
                              f"forwards and {run['backwards']} steps, the world-1 constants per minibatch")
                    self.readings["launches"][f"dp {label} {mode}"] = dict(run["counts"])
        # DataParallel's train step alone: compiled against eager, timed, NCCL's share
        mbs = self.device_mbs[self.rank::self.world]
        profiles = []
        runs = {mode: dp_step_runs(self.model, mbs, self.dev, compiled=mode == "compiled",
                                   timed=(TIMED_RUNS, TIMED_STEPS) if self.sizes.timed else None,
                                   profiles=profiles if mode == "compiled" else None)
                for mode in ("eager", "compiled")}
        # the eager step again: whether the all-reduces repeat from run to run
        again = dp_step_runs(self.model, mbs, self.dev, compiled=False, timed=None)
        verdict = self.checked(name, lambda: held_to_eager("world DataParallel eager train step", again,
                                                           runs["eager"])) or "beyond rtol 1e-6"
        self.hold(name, verdict.startswith("bitwise"),
                  f"DataParallel's eager train step run twice at world {self.world}, {COMPILED_STEPS} steps: {verdict}")
        verdict = self.checked(name, lambda: held_to_eager("world DataParallel train step", runs["compiled"],
                                                           runs["eager"])) or "beyond rtol 1e-6"
        self.hold(name, verdict.startswith("bitwise"),
                  f"DataParallel's train step (ZeRO-1 Adam, clip 1.0, dropout on, the weight and rate changing "
                  f"every step) {COMPILED_STEPS} steps compiled against eager at world {self.world}: {verdict}")
        if self.sizes.timed:
            c = runs["compiled"]
            share = nccl_share(profiles[0][0])
            self.readings["dp ms/step"] = c["ms"]
            self.readings["dp nccl"] = share
            self.say(name, f"DataParallel train step ms/step (median of {TIMED_RUNS} runs of {TIMED_STEPS}) "
                           f"compiled {c['ms']:.3f} {[round(t, 3) for t in c['times']]}, eager "
                           f"{runs['eager']['ms']:.3f}; device busy {100 * c['busy']:.1f} %; a profiled run of "
                           f"{PROFILED_STEPS} compiled steps: NCCL kernels {share['nccl_ms']:.3f} device ms, the rest "
                           f"{share['other_ms']:.3f} ({100 * share['nccl_share']:.1f} % NCCL) on {self.card}")
        self.say(name, f"leg total {time.perf_counter() - t_leg:.1f} s")

    # -- leg 3: EdgeParallel -----------------------------------------------------------
    def leg_edge(self) -> None:
        from ptgnn_tpu_torch.graph.structs import tree_to
        from ptgnn_tpu_torch.parallel import EdgeParallel

        name = "world-edge"
        t_leg = time.perf_counter()
        single = self.model.build_neural_module(device=self.dev, seed=SEED)
        set_dropout(single, 0.0)
        sharded = self.model.build_neural_module(device=self.dev, seed=SEED)
        set_dropout(sharded, 0.0)
        ep = EdgeParallel(sharded)
        host = self.minibatches[:EP_STEPS]
        local = [tree_to(ep.shard_batch(mb), self.dev) for mb in host]
        real = [int(mb["batch"].adjacency.mask.sum()) for mb in local]
        held = held_steps(single, sharded, self.device_mbs[:EP_STEPS], local,
                          lambda mb, opt, g: ep.train_step(mb, opt, generator=g)[0], EP_STEPS, lr=WORLD_SGD_LR)
        sharded.gnn.edge_group = None
        single_losses, losses, worst, where, bitwise, ms, counts = held
        close = bool(np.allclose(losses, single_losses, rtol=1e-5, atol=0))
        self.hold(name, worst <= 1e-5 and close,
                  f"EdgeParallel, one batch's edges in {self.world} tile-aligned shards (this rank's {real} real "
                  f"slots), {EP_STEPS} SGD steps (dropout 0) each from the single-device step's weights: losses "
                  f"{losses} vs {single_losses} (rtol 1e-5), parameters within {worst:.3e} of each max (limit 1e-5; "
                  f"worst {where}; bitwise {bitwise})")
        self.readings["launches"]["edge steps"] = dict(counts)
        self.compiled_against_eager(name, "edge", "EdgeParallel's train step", local, EdgeParallel)
        self.say(name, f"leg total {time.perf_counter() - t_leg:.1f} s")

    # -- leg 4: NodeParallel ---------------------------------------------------------------
    def leg_node(self) -> None:
        import torch.distributed as dist

        from ptgnn_tpu_torch.core.trainer import module_loss
        from ptgnn_tpu_torch.graph.structs import tree_to
        from ptgnn_tpu_torch.parallel import NodeParallel, shard_batch_by_nodes, suggest_budgets
        from ptgnn_tpu_torch.parallel.node_sharding import local_shard

        name = "world-node"
        t_leg = time.perf_counter()
        module = self.model.build_neural_module(device=self.dev, seed=SEED)
        set_dropout(module, 0.0)
        host_mb = self.minibatches[0]
        budgets = suggest_budgets([host_mb], self.world, reorder="bfs")
        sharded, stats = shard_batch_by_nodes(host_mb, self.world, reorder="bfs", **budgets)
        local_all = [tree_to(local_shard(sharded, s), self.dev)["batch"] for s in range(self.world)]
        with torch.no_grad():
            in_process = node_sharded_stack(module.gnn, local_all).detach().chunk(self.world)[self.rank]
            module.gnn.node_group = dist.group.WORLD
            out, _ = module.gnn._forward_node_sharded(local_all[self.rank], train=True, generator=None,
                                                      return_all_states=False)
            module.gnn.node_group = None
        got = out.output_node_representations
        d = got.shape[1]
        self.hold(name, bitwise_equal(got, in_process),
                  f"{self.world} shards (BFS reorder): this rank's final node states through the cross-card "
                  f"exchange ({'NCCL' if self.dev.type == 'cuda' else 'gloo'} all_to_all) bitwise equal to the "
                  f"in-process {self.world}-shard stack's on the same shards: {bitwise_equal(got, in_process)} "
                  f"(max abs err {float((got - in_process).abs().max()):.3e})")
        self.readings["node exchange"] = {
            "boundary_rows": int(stats["boundary_nodes_total"]), "nodes": int(host_mb["batch"].num_nodes),
            "rows_per_layer": int(stats["exchanged_rows_real"]), "bytes_per_layer": 4 * d * int(stats["exchanged_rows_real"]),
            "padded_bytes_per_layer": 4 * d * int(stats["exchanged_rows_padded"])}
        self.say(name, f"boundary rows {stats['boundary_nodes_total']} of {int(host_mb['batch'].num_nodes)} nodes; "
                       f"a layer exchanges {stats['exchanged_rows_real']} rows = "
                       f"{4 * d * stats['exchanged_rows_real']} float32 bytes "
                       f"({4 * d * stats['exchanged_rows_padded']} as the padded all_to_all ships them)")

        # gradients and steps against the unsharded ones
        budgets = suggest_budgets(self.minibatches[:NP_STEPS], self.world)
        single = self.model.build_neural_module(device=self.dev, seed=SEED)
        set_dropout(single, 0.0)
        shard_module = self.model.build_neural_module(device=self.dev, seed=SEED)
        set_dropout(shard_module, 0.0)
        npar = NodeParallel(shard_module, **budgets)
        local = [tree_to(npar.shard_batch(mb), self.dev) for mb in self.minibatches[:NP_STEPS]]
        npar.data_parallel.grad_step(local[0], 1.0, None)
        synchronize()
        single.zero_grad(set_to_none=True)
        loss, _ = module_loss(single, self.device_mbs[0], train=True)
        loss.backward()
        grad_err = max((float((p.grad - q.grad).abs().max() / q.grad.abs().max().clamp_min(1e-30)), k)
                       for (k, p), q in zip(shard_module.named_parameters(), single.parameters()))
        npar.data_parallel.zero_grad()
        single.zero_grad(set_to_none=True)
        self.hold(name, grad_err[0] <= 1e-4,
                  f"NodeParallel's gradients of one minibatch against the unsharded step's: within "
                  f"{grad_err[0]:.3e} of each gradient's max (limit 1e-4; worst {grad_err[1]})")
        held = held_steps(single, shard_module, self.device_mbs[:NP_STEPS], local,
                          lambda mb, opt, g: npar.train_step(mb, opt, generator=g)[0], NP_STEPS, lr=WORLD_SGD_LR)
        shard_module.gnn.node_group = None
        single_losses, losses, worst, where, bitwise, ms, counts = held
        close = bool(np.allclose(losses, single_losses, rtol=1e-5, atol=0))
        self.hold(name, worst <= 1e-5 and close,
                  f"NodeParallel ({self.world} shards), {NP_STEPS} SGD steps (dropout 0) each from the "
                  f"single-device step's weights: losses {losses} vs {single_losses} (rtol 1e-5), parameters "
                  f"within {worst:.3e} of each max (limit 1e-5; worst {where}; bitwise {bitwise})")
        self.readings["launches"]["node steps"] = dict(counts)
        self.compiled_against_eager(name, "node", "NodeParallel's train step", local,
                                    lambda m: NodeParallel(m, **budgets))
        # PPI node-sharded in bf16 AMP (K5 inside the cross-card graph) and float32
        ppi = self.checked(name, lambda: ppi_np_steps(self.ppi_model, self.ppi_minibatches, self.dev, self.card,
                                                      shards=self.world, within=lambda fn: fn()))
        if ppi is not None:
            self.hold(name, True, f"PPI node-sharded over {self.world} ranks against the unsharded steps (bf16 "
                                  f"AMP and float32; ppi_np_steps' limits); launches {dict(ppi[0])}")
            self.readings["launches"]["ppi node steps"] = dict(ppi[0])
        self.say(name, f"leg total {time.perf_counter() - t_leg:.1f} s")

    # -- leg 5: the hybrid, 2 data x 2 node ------------------------------------------------
    def leg_hybrid(self) -> None:
        from ptgnn_tpu_torch.core.trainer import module_loss
        from ptgnn_tpu_torch.graph.structs import tree_to
        from ptgnn_tpu_torch.parallel import NodeParallel, NodeShardedModelTrainer, moment_elements, suggest_budgets
        from ptgnn_tpu_torch.parallel.dp import zero1_optimizer
        from ptgnn_tpu_torch.parallel.node_sharded_trainer import node_data_groups

        name = "world-hybrid"
        t_leg = time.perf_counter()
        node_shards = 2
        if self.world % node_shards:
            self.say(name, f"needs an even world: none at world {self.world}")
            return
        data_size = self.world // node_shards
        node_group, data_group = node_data_groups(node_shards)  # every rank makes every group, in one order
        d = self.rank // node_shards
        host = self.minibatches[:data_size]
        weights = [float(mb["batch"].num_graphs) for mb in host]
        budgets = suggest_budgets(host, node_shards)
        state = self.model.build_neural_module(device=self.dev, seed=SEED).state_dict()

        def fresh():
            module = self.model.build_neural_module(device=self.dev, seed=SEED)
            set_dropout(module, 0.0)
            npar = NodeParallel(module, node_group=node_group, data_group=data_group, **budgets)
            return module, npar, tree_to(npar.shard_batch(host[d]), self.dev)

        module, npar, local = fresh()
        optimizer = torch.optim.SGD(module.parameters(), lr=WORLD_SGD_LR)
        loss, _ = npar.train_step(local, optimizer, weight=weights[d], generator=None)
        got = params_of(module)
        module.gnn.node_group = None
        single = self.model.build_neural_module(device=self.dev, seed=SEED)
        set_dropout(single, 0.0)
        acc = {n: torch.zeros_like(p) for n, p in single.named_parameters()}
        want_loss = 0.0
        for w, mb in zip(weights, self.device_mbs[:data_size]):
            single.zero_grad(set_to_none=True)
            l, _ = module_loss(single, mb, train=True)
            l.backward()
            want_loss += w * float(l) / sum(weights)
            for n, p in single.named_parameters():
                acc[n] += w * p.grad
        err = max((float((got[n] - state[n] + WORLD_SGD_LR * acc[n] / sum(weights)).abs().max()
                         / (WORLD_SGD_LR * acc[n] / sum(weights)).abs().max().clamp_min(1e-30)), n) for n in acc)
        self.hold(name, err[0] <= 1e-4 and abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss),
                  f"{data_size} data x {node_shards} node groups: one SGD step against one card's unsharded step on "
                  f"the weighted mean gradient of the {data_size} data groups' minibatches (weights {weights}): "
                  f"each update within {err[0]:.3e} of its max (limit 1e-4; worst {err[1]}); loss {float(loss):.7f} "
                  f"vs {want_loss:.7f} (rtol 1e-5)")

        module, npar, local = fresh()
        optimizer = zero1_optimizer(module.parameters(), lambda p: torch.optim.Adam(p, lr=WORLD_LR), group=data_group)
        npar.train_step(local, optimizer, generator=None)
        module.gnn.node_group = None
        total = 2 * sum(p.numel() for p in module.parameters())
        share = moment_elements(optimizer) / total
        self.hold(name, 0.5 / data_size < share < 1.5 / data_size,
                  f"ZeRO-1 over the data group: this rank holds {moment_elements(optimizer)} of {total} moment "
                  f"elements ({100 * share:.1f} %)")
        self.compiled_against_eager(name, "hybrid", "the hybrid train step", [local],
                                    lambda m: NodeParallel(m, node_group=node_group, data_group=data_group, **budgets))

        # NodeShardedModelTrainer for an epoch, compiled and eager, over the
        # data-parallel trainers' graphs (a group of data_size minibatches a step)
        train = self.dp_train
        runs = {}
        for mode in ("compiled", "eager"):
            trainer = NodeShardedModelTrainer(
                g2c_world_model(self.sizes, dropout_rate=0.1), self.out_dir / f"hybrid-{mode}.pkl.gz",
                node_shards=node_shards, max_num_epochs=1, minibatch_size=self.sizes.minibatch_size,
                device=self.dev, seed=SEED, optimizer_creator=lambda p: torch.optim.Adam(p, lr=WORLD_LR),
                clip_gradient_norm=1.0, target_validation_metric="Accuracy",
                target_validation_metric_higher_is_better=True)
            trainer.load_metadata_and_create_network(train, parallelize=False)
            if mode == "eager":
                eager_dp(trainer.data_parallel)
            losses = []
            real = trainer.data_parallel.train_step

            def recorded(*args, _real=real, _losses=losses, **kwargs):
                out = _real(*args, **kwargs)
                _losses.append(float(out[0]))
                return out

            trainer.data_parallel.train_step = recorded
            t0 = time.perf_counter()
            with HostWork(trainer._model) as work:
                (_, counts) = self.counts_of_path(lambda: trainer.train(
                    train, self.valid, initialize_metadata=False, patience=0, parallelize=False))
            synchronize()
            runs[mode] = {"losses": losses, "params": params_of(trainer.neural_module),
                          "seconds": time.perf_counter() - t0, "budgets": trainer._budgets, "counts": counts,
                          "host": work.reading(), "handoff": trainer.handoff_stats}
            trainer.neural_module.gnn.node_group = None
        c, e = runs["compiled"], runs["eager"]
        apart = same_tensors(c["params"], e["params"])
        self.hold(name, not apart and c["losses"] == e["losses"] and len(c["losses"]) >= 2
                  and all(math.isfinite(x) and x > 0 for x in c["losses"]),
                  f"NodeShardedModelTrainer ({data_size} x {node_shards}, ZeRO-1 over the data group, dropout on) "
                  f"for an epoch over {len(train)} graphs with validation, compiled against eager: losses "
                  f"{c['losses']} / {e['losses']}, parameters bitwise equal: {not apart} {apart[:4]}; "
                  f"{c['seconds']:.2f} s compiled, {e['seconds']:.2f} s eager; budgets {c['budgets']}")
        calls, secs, h = c["host"]["calls"], c["host"]["seconds"], c["handoff"]
        if self.rank == 0:  # the node's assembler: it reshards every slot, once
            ok = calls["tensorize_dataset"] > 0 and calls["reshard"] > 0 and h["slots"] > 0
        else:
            ok = not any(calls.values()) and h["slots"] > 0
        self.hold(name, ok,
                  f"the compiled epoch's host work on {'the node assembler' if self.rank == 0 else 'a peer'}: calls "
                  f"{calls}; reshard {secs['reshard']:.3f} s, finalize {secs['finalize']:.3f} s; handoff "
                  f"{h['slots']} shards {'sent' if self.rank == 0 else 'received'}, "
                  f"{h['bytes'] / max(h['slots'], 1) / 1e6:.3f} MB a shard, {h['seconds']:.3f} s in the calls "
                  f"({h['pack_seconds']:.3f} s packing or unpacking)")
        self.readings["hybrid host"] = {"host": c["host"], "handoff": h}
        self.readings["launches"]["hybrid trainer"] = dict(c["counts"])
        self.say(name, f"leg total {time.perf_counter() - t_leg:.1f} s")

    # -- leg 6: DistributedCheckpointer with ZeRO-1 --------------------------------------------
    def leg_checkpoint(self) -> None:
        name = "world-checkpoint"
        t_leg = time.perf_counter()
        r = checkpoint_round_trip(self.model, self.device_mbs, self.dev, self.tmp / "dcp", self.rank, self.world,
                                  eps=WORLD_ADAM_EPS)
        reference = ("the uninterrupted one" if self.world == 1 else
                     f"a twin run's step 4 through a new DataParallel (the twin's steps 1-3 bitwise the saved state "
                     f"{r['twin_replayed']})")
        self.hold(name, r["ok"],
                  f"ZeRO-1 at world {self.world} (Adam eps {WORLD_ADAM_EPS}): async save after step 3 while steps "
                  f"4-5 ran; restored parameters bitwise {r['same_params']}, this rank's Adam moments and steps "
                  f"bitwise {r['same_moments']} ({r['moment_tensors']} tensors), the resumed step 4 bitwise "
                  f"{reference}: {r['same_step']}; steps kept {r['kept']}, sidecars {r['sidecars']}")
        if self.world > 1:
            drift, worst = r["drift"]
            self.hold(name, drift <= 1e-5,
                      f"the resumed step 4 against the uninterrupted one (its DataParallel's rebuilt buckets): "
                      f"every parameter within {drift:.3e} of its max (limit 1e-5; worst {worst}); bitwise "
                      f"{r['fresh_is_uninterrupted']}")
        self.readings["checkpoint s"] = {k: r[k] for k in ("stage_s", "commit_s", "restore_s")}
        self.say(name, f"save returned in {r['stage_s']:.3f} s, commit waited {r['commit_s']:.3f} s more, restore "
                       f"{r['restore_s']:.3f} s; a step is {r['bytes']} bytes in {r['files']} files; leg total "
                       f"{time.perf_counter() - t_leg:.1f} s")

    # -- leg 8: the epoch at world 4 -----------------------------------------------------------------
    def leg_epoch(self) -> None:
        name = "world-epoch"
        e = world_epoch(self.dev, f"world-epoch-r{self.rank}")
        self.readings["epoch"] = e
        least = 20 if self.dev.type == "cuda" else 1
        self.hold(name, e["steps"] >= least and all(math.isfinite(x) for x in e["losses"])
                  and len(set(e["captured"])) == 1,
                  f"DistributedModelTrainer, {WORLD_EPOCHS} epochs (ZeRO-1, compiled, the tensorize forked on the "
                  f"card) over {e['graphs']} graphs: {e['steps']} steps an epoch (at least {least}) in "
                  f"{[round(t, 3) for t in e['seconds']]} s, the first with the DDP warm-ups and captures, the "
                  f"second replaying them (train-step graphs at each epoch's end {e['captured']}); the oracle's "
                  f"host tensorize of the {e['graphs']} graphs in one thread {e['tensorize_s']:.3f} s")
        self.hold(name, bool(e["digests"]) and e["digests"] == e["oracle"],
                  f"this rank's host minibatch of the first {len(e['digests'])} groups bitwise the in-process "
                  f"minibatch_iterator's minibatch g x {self.world} + {self.rank} over the same graphs and shuffle "
                  f"seed (sha256 {[d[:12] for d in e['digests']]} / {[d[:12] for d in e['oracle']]})")
        calls, handoff = e["host"]["calls"], e["handoff"]
        passes = 2 * WORLD_EPOCHS  # a training and a validation pass an epoch
        if self.rank == 0:  # the node's assembler
            ok = (calls["tensorize_dataset"] == passes and calls["finalize"] >= e["steps"] * self.world
                  and calls["children"] == (passes if self.dev.type == "cuda" else 0)
                  and handoff["slots"] >= (self.world - 1) * e["steps"])
        else:
            ok = (not any(calls.values()) and handoff["slots"] >= e["steps"])
        self.hold(name, ok,
                  f"{'the assembler' if self.rank == 0 else 'a peer of the assembler'}: tensorize_dataset calls "
                  f"{calls['tensorize_dataset']}, forked children {calls['children']}, in-process tensorize calls "
                  f"{calls['tensorize']}, finalize calls {calls['finalize']}, reshards {calls['reshard']} over "
                  f"{passes} passes; handoff {handoff['slots']} slots {'sent' if self.rank == 0 else 'received'}")

    def run(self, legs=WORLD_LEGS) -> dict:
        """The legs of ``legs`` that the ranks run, in WORLD_LEGS' order."""
        self.setup()
        for leg in WORLD_LEGS:
            if leg in legs and hasattr(self, f"leg_{leg}"):
                self.barrier()
                getattr(self, f"leg_{leg}")()
        self.barrier()
        return {"rank": self.rank, "device": str(self.dev), "failures": self.failures, "held": self.held,
                "readings": self.readings}


def world_rank(rank: int, world: int, tmp: str, device: str = "cuda", extra: str | None = None,
               leg_names=WORLD_LEGS) -> None:
    """One rank of the multi-card path (a spawned process): joins the group
    through ``initialize_multi_host`` (NCCL on its card; gloo where
    ``device`` is "cpu"), runs the legs of ``leg_names`` (``WorldRank``) and ``extra``
    ("module:function", called as ``function(payload, rank, world, tmp)`` on
    ``tmp/extra.pt``: a test's own case in the same world), and writes its
    results to ``tmp/rank{rank}.pt``, its traceback to ``tmp/error{rank}.txt``."""
    import importlib
    import traceback

    import torch.distributed as dist

    from ptgnn_tpu_torch.parallel import initialize_multi_host

    global PHASE_SINK
    tmp = Path(tmp)
    try:
        with open(tmp / f"rank{rank}.log", "w") as log:
            if device == "cpu":
                torch.set_num_threads(1)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            initialize_multi_host("nccl" if device == "cuda" else "gloo", f"file://{tmp}/store", world, rank)
            try:
                dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
                if device == "cuda" and dev.index != rank:
                    raise RuntimeError(f"rank {rank} was bound to {dev}")
                legs = WorldRank(rank, world, dev, tmp, log)
                PHASE_SINK = legs.say
                out = legs.run(leg_names)
                if extra is not None:
                    module_name, fn = extra.split(":")
                    payload = torch.load(tmp / "extra.pt", weights_only=False)
                    out["extra"] = getattr(importlib.import_module(module_name), fn)(payload, rank, world, tmp)
                    dist.barrier()
            finally:
                PHASE_SINK = None
                legs = None
                legs_left = free_compiled_steps()
                log.write(f"the legs ended; {legs_left} compiled steps still held graphs, freed\n")
                log.flush()
                dist.destroy_process_group()
                log.write("the process group is destroyed\n")
        torch.save(out, tmp / f"rank{rank}.pt")
    except BaseException:
        (tmp / f"error{rank}.txt").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def free_compiled_steps() -> int:
    """Free the graphs of every compiled step still alive in this process,
    after a collection; returns how many held any. NCCL's group
    destruction waits for every CUDA graph that captured one of its
    collectives."""
    from ptgnn_tpu_torch.core.compiled_step import CompiledStep

    gc.collect()
    # type(), not isinstance(), which warns on deprecated module objects
    held = [obj for obj in gc.get_objects() if type(obj) is CompiledStep and len(obj)]
    for step in held:
        step.clear()
    synchronize()
    return len(held)


def launch_world(world: int, tmp: Path, device: str = "cuda", extra: str | None = None, legs=WORLD_LEGS) -> list:
    """``world`` ranks of ``world_rank`` running ``legs`` (spawned, a ``file://`` rendezvous
    in ``tmp``), joined with a timeout; what is left is killed. Returns each
    rank's results; raises with the ranks' tracebacks where one failed."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=world_rank, args=(r, world, str(tmp), device, extra, tuple(legs)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + WORLD_JOIN_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = [(tmp / f"error{r}.txt").read_text() for r in range(world) if (tmp / f"error{r}.txt").exists()]
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise RuntimeError(f"ranks {hung} still running after {WORLD_JOIN_S} s were killed; exit codes {codes}\n"
                           + "\n".join(errors))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def kernels_on_every_card(host_adj, cards: int) -> list:
    """Leg 1: K1-K5 on every card, each called from a thread whose current
    device is card 0 (the wrappers enter their tensors' card): K1-K4 at 64
    columns on the benchmark batch's layout and K5 at PPI's bf16 shape
    (122,880 slots in tiles of 128 of 3 types, 256 x 256), each bitwise
    against its plain version (K1's on the CPU; K5's on integer data, whose
    products and sums float32 holds exactly) and against card 0's result.
    Returns a line a kernel and card; raises on a failed check."""
    import threading

    from ptgnn_tpu_torch.graph.structs import tree_to
    from ptgnn_tpu_torch.ops import segment_kernels as sk
    from ptgnn_tpu_torch.ops import typed_linear as ttl

    results, errors = [], []
    cpu = torch.device("cpu")

    def check(kind, card, got, want, first):
        same = all(bitwise_equal(a, b) for a, b in zip(got, want))
        across = first is None or all(bitwise_equal(a.cpu(), b) for a, b in zip(got, first))
        if not (same and across and torch.cuda.current_device() == 0):
            raise RuntimeError(f"{kind} on cuda:{card}: plain {same}, card 0 {across}, current device "
                               f"{torch.cuda.current_device()}")

    def run():
        try:
            torch.cuda.set_device(0)
            first = {}
            for card in range(cards):
                dev = torch.device("cuda", card)
                adj = tree_to(host_adj, dev)
                gen = torch.Generator(device=dev).manual_seed(SEED)  # the same inputs on every card
                before = launch_counts()
                for kind in ("segment_sum", "segment_extremum", "segment_extremum_argmax", "broadcast_to_edges"):
                    k = layout_kernel(kind, adj, 64, dev, gen)
                    x = k.make()
                    got = k.kernel(x)
                    got = got if isinstance(got, tuple) else (got,)
                    if kind == "segment_sum":  # the CPU's plain version adds in the kernel's order
                        plain = sk.segment_sum_plain(x.cpu(), tree_to(sk.sum_plan_from_adjacency(adj), cpu),
                                                     adj.agg_counts.numel())
                        got, want = tuple(t.cpu() for t in got), (plain,)
                    else:
                        want = k.plain(x)
                        want = want if isinstance(want, tuple) else (want,)
                        if kind == "segment_extremum_argmax":  # values apart from the sign of zero
                            got, want = (got[0] + 0.0, got[1]), (want[0] + 0.0, want[1])
                    check(kind, card, got, want, first.get(kind))
                    first.setdefault(kind, tuple(t.cpu() for t in got))
                tiles = 960
                tt = torch.randint(0, 3, (tiles,), device=dev, generator=gen, dtype=torch.int32)
                x = torch.randint(-2, 3, (tiles * 128, 256), device=dev, generator=gen).to(torch.bfloat16)
                w = torch.randint(-2, 3, (3, 256, 256), device=dev, generator=gen).to(torch.bfloat16)
                got = (ttl.typed_matmul_kernel(x, w, tt, 128),)
                check("typed_matmul", card, got, (ttl.typed_matmul_plain(x, w, tt, 128),), first.get("typed_matmul"))
                first.setdefault("typed_matmul", tuple(t.cpu() for t in got))
                torch.cuda.synchronize(dev)
                launched = delta(launch_counts(), before)
                if min(launched.values()) < 1:
                    raise RuntimeError(f"cuda:{card}: a kernel did not launch: {launched}")
                results.append(f"cuda:{card} {dict(launched)}")
        except BaseException as failure:  # noqa: BLE001 - raised in the caller
            errors.append(failure)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(600)
    if errors or thread.is_alive():
        raise RuntimeError(f"kernels on every card: {errors or 'the thread hung'}")
    return results


def world_cli(world: int, card: str) -> list:
    """Leg 7: ``traindistributed --world-size N`` and ``--world-size N
    --node-shards 2`` for one epoch each on synthetic folds (phase 20's
    sizes), each a process of its own with a time limit: exit 0, a test
    accuracy and a finite train loss in its log. Returns the lines."""
    import os
    import re

    from ptgnn_tpu_torch.utils.io import write_jsonl_gz
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    lines = []
    for label, extra in (("dp", []), ("np", ["--node-shards", "2"])):
        root = Path(__file__).resolve().parent / "build" / "chip_smoke" / f"world-cli-{label}"
        shutil.rmtree(root, ignore_errors=True)
        folds = []
        for i, (fold, count) in enumerate((("train", 12), ("valid", 4), ("test", 4))):
            (root / fold).mkdir(parents=True)
            write_jsonl_gz(root / fold / "part0.jsonl.gz",
                           synthetic_typilus_graphs(count, seed=SEED + 30 + i, mean_nodes=1500, max_nodes=4000))
            folds.append(str(root / fold))
        t0 = time.perf_counter()
        env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
        done = subprocess.run(
            [sys.executable, "-m", "ptgnn_tpu_torch.implementations.typilus.traindistributed", *folds,
             str(root / "m.pkl.gz"), "--max-num-epochs", "1", "--max-nodes", "8192", "--world-size", str(world),
             *extra], cwd=root, env=env, capture_output=True, text=True, timeout=180)
        log = (root / "logs" / "full.log").read_text() if (root / "logs" / "full.log").exists() else ""
        losses = [float(m) for m in re.findall(r"Train Loss ([-+0-9.eE]+|nan|inf)", log)]
        accuracy = [ln for ln in done.stdout.splitlines() if ln.startswith("Test accuracy:")]
        if done.returncode != 0 or not accuracy or not losses or not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"traindistributed --world-size {world} {' '.join(extra)}: exit {done.returncode}, "
                               f"{accuracy}, train losses {losses}\n{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
        lines.append(f"traindistributed --world-size {world} {' '.join(extra)}: exit 0 in "
                     f"{time.perf_counter() - t0:.1f} s, train loss {losses}, '{accuracy[0]}' on {card}")
    return lines


def world_main(world: int, legs=WORLD_LEGS) -> None:
    """``python3 chip_smoke.py --world 4 [--legs dp,epoch,...]``: the
    multi-card path on ``world`` cards of one host, every leg of WORLD_LEGS
    or those of ``legs``. Leg 1 (K1-K5 on every card from a thread on card
    0) and the world-1 references (phase 29's compiled step, phase 30's
    DistributedModelTrainer epoch) in this process; legs 2-6 and the epoch
    in ``world`` spawned ranks over NCCL (``WorldRank``); leg 7 (the
    distributed CLI at world ``world``, data-parallel and 2 node shards);
    then the readings. Raises with fewer cards; never falls back."""
    import tempfile

    from ptgnn_tpu_torch import native
    from ptgnn_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    if torch.cuda.device_count() < world:
        raise RuntimeError(f"--world {world} needs {world} cards; this machine has {torch.cuda.device_count()}")
    if set(legs) - set(WORLD_LEGS):
        raise ValueError(f"--legs {sorted(set(legs) - set(WORLD_LEGS))}: the legs are {WORLD_LEGS}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", f"{torch.cuda.device_count()} x {kind}; nvidia-smi: {card_lines()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; legs {[leg for leg in WORLD_LEGS if leg in legs]}")
    build_s = cuda_build.build_all()
    native_s = native.build()
    phase("build", f"{build_s:.2f} s for {sorted(cuda_build.BUILD_LOG) or 'nothing (cached)'}; native assembler "
          f"{native_s:.2f} s; into {cuda_build.BUILD_DIR.parent}")

    # ---- leg 1: the kernels on every card ----------------------------------
    model, _, minibatches, batches = build_bench(dev)
    if "kernels" in legs:
        for line in kernels_on_every_card(minibatches[0]["batch"].adjacency, world):
            phase("world-kernels", f"K1-K5 from a thread whose current device is cuda:0, bitwise against their "
                  f"plain versions and card 0's results: {line}")

    # ---- world-1 references ---------------------------------------------------
    step_ms = one = None
    if set(legs) & {"dp", "edge", "node", "hybrid"}:
        step_ms = step_runs(model, [g2c_minibatch(b) for b in batches], dev, amp=False, compiled=True)["ms"]
        phase("world-1", f"phase 29's compiled Graph2Class train step at world 1: {step_ms:.3f} ms/step on {card}")
    if "epoch" in legs:
        one = world_one(lambda: world_epoch(dev, "world-1-epoch"))
        phase("world-1", f"phase 30's DistributedModelTrainer epoch at world 1 (ZeRO-1, compiled, forked "
              f"tensorize), {WORLD_EPOCHS} epochs over {one['graphs']} graphs: {one['steps']} steps an epoch in "
              f"{[round(t, 3) for t in one['seconds']]} s (the first with the captures; train-step graphs at each "
              f"epoch's end {one['captured']}); host tensorize {one['tensorize_s']:.3f} s in one thread")
    del model, minibatches, batches
    gc.collect()
    torch.cuda.empty_cache()

    # ---- legs 2-6 and the epoch on `world` ranks ----------------------------------
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_world_"))
    logs = Path(__file__).resolve().parent / "build" / "chip_smoke" / "world"
    t0 = time.perf_counter()
    try:
        ranks = launch_world(world, tmp, legs=legs)
    finally:
        shutil.rmtree(logs, ignore_errors=True)
        logs.mkdir(parents=True, exist_ok=True)
        for log in tmp.glob("*.log"):
            shutil.copy(log, logs / log.name)
        for err in tmp.glob("error*.txt"):
            shutil.copy(err, logs / err.name)
        shutil.rmtree(tmp, ignore_errors=True)
    phase("world", f"{world} ranks ran {[leg for leg in WORLD_LEGS[1:-1] if leg in legs]} in "
          f"{time.perf_counter() - t0:.1f} s (rank logs under {logs})")
    failures = [f"rank {r['rank']}: {f}" for r in ranks for f in r["failures"]]

    # ---- leg 7: the distributed CLI -------------------------------------------------
    try:
        for line in world_cli(world, card) if "cli" in legs else ():
            phase("world-cli", line)
    except (RuntimeError, subprocess.TimeoutExpired) as failure:
        failures.append(f"leg 7: {failure}")

    # ---- leg 8: readings ---------------------------------------------------------------
    r0 = ranks[0]["readings"]
    readings = {"card": card, "cards": world, "world1_step_ms": step_ms, "world1_epoch": one,
                "ranks": [r["readings"] for r in ranks]}
    if step_ms is not None:
        ms = {leg: r0.get(f"{leg} ms/step") for leg in ("dp", "edge", "node", "hybrid")}
        phase("world-readings", f"ms per step at world {world} (rank 0, compiled, median of the timed runs): {ms} "
              f"against the world-1 compiled step's {step_ms:.3f}")
    if one is not None:
        epochs = [r["readings"]["epoch"] for r in ranks]
        for i, label in enumerate(("first (DDP warm-ups and captures)", "second (steady state)")[:WORLD_EPOCHS]):
            phase("world-readings", f"DistributedModelTrainer {label} epoch over {one['graphs']} graphs: world "
                  f"{world} {[round(e['seconds'][i], 3) for e in epochs]} s a rank ({epochs[0]['steps']} steps a "
                  f"rank) against world 1 {one['seconds'][i]:.3f} s ({one['steps']} steps); ratio "
                  f"{max(e['seconds'][i] for e in epochs) / one['seconds'][i]:.3f}")
        phase("world-readings", f"the oracle's host tensorize of the {one['graphs']} graphs in one thread, each "
              f"rank {[round(e['tensorize_s'], 3) for e in epochs]} s (world 1: {one['tensorize_s']:.3f} s)")
        for label, e in [("world 1", one)] + [(f"world {world} rank {r['rank']}", r["readings"]["epoch"])
                                              for r in ranks]:
            calls, secs, h = e["host"]["calls"], e["host"]["seconds"], e["handoff"]
            phase("world-readings", f"{label}, the trainer's host work over {WORLD_EPOCHS} epochs and their "
                  f"validation: seconds tensorize (this process) {secs['tensorize']:.3f}, forked children's CPU "
                  f"{secs['children_cpu']:.3f}, assemble {secs['assemble']:.3f}, finalize {secs['finalize']:.3f}, "
                  f"reshard {secs['reshard']:.3f}, handoff {h['seconds']:.3f} in the calls, waits included "
                  f"({h['pack_seconds']:.3f} packing or unpacking); handoff {h['slots']} slots, "
                  f"{h['bytes'] / max(h['slots'], 1) / 1e6:.3f} MB a slot; calls {calls}; handoff at each epoch's "
                  f"end {e['handoffs']} on {card}")
    if "dp nccl" in r0:
        phase("world-readings", f"NCCL's share of a profiled run of compiled DataParallel steps on rank 0: {r0['dp nccl']}")
    for r in ranks:
        phase("world-readings", f"rank {r['rank']} launches of K1-K5 by path {r['readings']['launches']}")
    if failures:
        for f in failures:
            print(f"FAILED {f}", flush=True)
        raise RuntimeError(f"{len(failures)} gates failed at world {world}")
    phase("world", f"every gate of the legs {[leg for leg in WORLD_LEGS if leg in legs]} held on every rank "
          f"({sum(len(r['held']) for r in ranks)} gate lines); total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"world": readings}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:] == ["--typed-dw"]:
        typed_dw_main()
        return
    if sys.argv[1:] == ["--keyed-dropout"]:
        keyed_dropout_main()
        return
    if sys.argv[1:] == ["--sanitizer-target"]:
        sanitizer_target()
        return
    if sys.argv[1:2] == ["--layers-gate"]:
        layers_gate_repeats(int(sys.argv[2]))
        return
    if sys.argv[1:2] == ["--broadcast-ab"]:
        broadcast_ab(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--world"]:
        legs = sys.argv[4].split(",") if sys.argv[3:4] == ["--legs"] else WORLD_LEGS
        world_main(int(sys.argv[2]), legs)
        return
    from ptgnn_tpu_torch import native
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
    native_s = native.build()
    phase("build", f"native layout assembler: {native.library_path()} in {native_s:.2f} s (g++)")
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

    forwards = Tally()  # GNN forwards of the main path, one per batch
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
    serving_counts = launch_counts()  # the serving path ends here
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
    vm_counts, vm_models = {}, {}
    for architecture in ("mlp", "ggnn"):
        vm_counts[architecture], _, vm_batches, vm_models[architecture] = varmisuse_phase(
            dev, card, architecture, vm_pad, vm_samples, vm_valid)
        vm_models[architecture] = (vm_models[architecture], vm_batches)

    # ---- 14. Graph2Seq at full width -----------------------------------------
    g2s_counts, g2s_batches, g2s_model = graph2seq_phase(dev, card, *graph2seq_samples())

    # ---- 17. the other message-passing families at full width ---------------
    layers_counts, layers_batches, layers_seen = layers_phase(dev, card)

    # ---- 18-20. edge features, the BPE embedder, data parallelism -----------
    edge_counts, edge_adj = edge_features_phase(dev, card)
    bpe_counts = bpe_phase(dev, card)
    epochs = epoch_data()
    dp_counts = data_parallel_phase(dev, card, model, batches, epochs)

    # ---- 21-22. edge and node sharding -----------------------------------------
    ep_counts = edge_parallel_phase(dev, card)
    np_counts, np_layouts, np_err = node_parallel_phase(dev, card, ppi_model, ppi_minibatches)

    # ---- 23-28. the assembler, prefetch, OOM skips, autotune, checkpoints, profiling
    t_new = time.perf_counter()
    na_counts, prefetch_two = native_assembler_phase(dev, card, model, ppi_model, ppi_samples, epochs)
    pf_counts = prefetch_phase(dev, card, model, epochs, prefetch_two)
    oom_counts = oom_phase(dev, card, model, epochs)
    at_counts = autotune_phase(dev, card)
    ck_counts = checkpoint_phase(dev, card, model, batches)
    pr_counts = profiling_phase(dev, card, model, batches)
    cs_counts = compiled_phase(dev, card, model, batches, ppi_model, ppi_batches, *vm_models["mlp"], g2s_model,
                               g2s_batches, epochs)
    mt_counts = multiprocess_tensorize_phase(dev, card, model, epochs)
    lr_counts = linear_residual_phase(dev, card)
    phase("total", f"phases 23-31 in {time.perf_counter() - t_new:.1f} s")
    paths = {"serving": serving_counts, "train": train_counts,
             "ppi-serving": ppi_serving_counts, "ppi-train": ppi_train_counts,
             "argmax-train": argmax_counts, "ggnn": ggnn_counts, "cli": cli_counts,
             "varmisuse-mlp": vm_counts["mlp"], "varmisuse-ggnn": vm_counts["ggnn"],
             "graph2seq": g2s_counts, "layers": layers_counts, "edge-features": edge_counts,
             "bpe": bpe_counts, "data-parallel": dp_counts, "edge-parallel": ep_counts,
             "node-parallel": np_counts, "native-assembler": na_counts, "prefetch": pf_counts, "oom": oom_counts,
             "autotune": at_counts, "checkpoint": ck_counts, "profiling": pr_counts,
             "compiled": cs_counts, "multiprocess-tensorize": mt_counts, "linear-residual": lr_counts}
    main_counts = {k: sum(counts[k] for counts in paths.values()) for k in serving_counts}
    main_counts["typed_dw"] = sum(counts.typed_dw for counts in paths.values())
    if min(main_counts.values()) <= 0:
        raise RuntimeError(f"a kernel of the path was never launched: {main_counts}")
    dw_by_path = {path: counts.by_shape for path, counts in paths.items() if counts.by_shape}
    phase("kernels", f"K6 launches by (tiles, tile, Din, M, types) and path: {dw_by_path}")
    keyed_by_path = {path: counts.keyed for path, counts in paths.items() if counts.keyed}
    phase("kernels", f"K7 launches by (E, C, column offset, tile, dtype) and path: {keyed_by_path}")

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

    def entry(name, width, times, k, dtype="float32"):
        return {
            "name": name, "route": "cuda", "source": KERNEL_FILES[name][0], "replaces": KERNEL_FILES[name][1],
            "launches": main_counts[name],
            "launches_by_path": {path: counts[name] for path, counts in paths.items()},
            "launches_per_forward": PER_FORWARD[name], "launches_per_train_step": PER_TRAIN_STEP[name],
            "max_abs_err": max_abs_err[name],
            "ms": times["ms"], "plain_ms": times["plain_ms"], **bound(k.nbytes, k.ops),
            "library_ms": times["library_ms"], "width": width, "dtype": dtype,
        }

    # K3 at every (row bytes, dtype) a path launched it at, on that path's
    # layout: Graph2Class's (serving and train: D and M, the backward's
    # widened g | ties | node_states table, in float32 and bf16 AMP), PPI's,
    # Graph2Seq's, the layers stack's, and a 2-way node shard's interior and
    # boundary at the float32 widths both Graph2Class and node-parallel ran.
    widths_by_path = {path: counts.by_width for path, counts in paths.items()}
    phase("kernels", f"K3 launches by (row bytes, dtype) and path: {widths_by_path}")
    g2c_keys = set(paths["serving"].by_width) | set(paths["train"].by_width)
    kernels += broadcast_width_entries(adj, "Graph2Class batch", g2c_keys, widths_by_path, dev, gen, entry)
    # The path's float32 widths: the sum's tie counts 64 and 128 and combined
    # node cotangent 128 and 256; D = M = 64 before the residuals, 128 after.
    for name, widths in (("segment_sum", (64, 128, 256)), ("segment_extremum", (64, 128))):
        for width in widths:
            k = layout_kernel(name, adj, width, dev, gen)
            e = entry(name, width, layout_times(k), k)
            if width == 64:
                kernels.append(e)
            phase("kernels", json.dumps(e))
    # The PPI layout's sum widths (the forward 256, the backward's combined
    # cotangents 512).
    ppi_adj = ppi_batches[0]["batch"].adjacency
    for width in (256, 512):
        k = layout_kernel("segment_sum", ppi_adj, width, dev, gen)
        e = entry("segment_sum", width, layout_times(k), k)
        e["max_abs_err"] = ppi_max_abs_err[f"segment_sum {width} float32"]
        phase("kernels", "PPI layout " + json.dumps(e))
    ppi_keys = set(paths["ppi-serving"].by_width) | set(paths["ppi-train"].by_width)
    kernels += broadcast_width_entries(ppi_adj, "PPI batch", ppi_keys, widths_by_path, dev, gen, entry)
    kernels += ppi_kernel_entries(ppi_adj, dev, gen, ppi_max_abs_err, main_counts, paths)
    # The edge-feature path's typed matmul shapes (bf16; forward and dx of
    # both stacks) on its layout.
    edge_max_abs_err = {}
    typed_matmul_checks(edge_adj, dev, gen, edge_max_abs_err, shapes=EDGE_TYPED_SHAPES, dtypes=(torch.bfloat16,),
                        name="kernels")
    kernels += ppi_kernel_entries(edge_adj, dev, gen, edge_max_abs_err, main_counts, paths, shapes=EDGE_TYPED_SHAPES,
                                  dtypes=((torch.bfloat16, BF16_OPS_PER_S),), layout="edge-features",
                                  per_step=EDGE_PER_TRAIN_STEP["mlp"])
    # The node-parallel layouts: K1, K2, K3 on a 2-way shard's interior and
    # boundary layouts, K5 (bf16) on PPI's node-sharded ones.
    np_keys = {key for key in paths["node-parallel"].by_width if key in g2c_keys and key[1] == "float32"}
    for label in ("np 2-way interior", "np 2-way boundary"):
        for name in ("segment_sum", "segment_extremum"):
            k = layout_kernel(name, np_layouts[label], 64, dev, gen)
            e = {**entry(name, 64, layout_times(k), k), "layout": label, "max_abs_err": np_err[name]}
            kernels.append(e)
            phase("kernels", json.dumps(e))
        kernels += broadcast_width_entries(np_layouts[label], label, np_keys, widths_by_path, dev, gen, entry)
    for label in ("ppi np interior", "ppi np boundary"):
        errs = {k[:-len(label) - 1]: v for k, v in np_err.items() if k.endswith(" " + label)}
        kernels += ppi_kernel_entries(np_layouts[label], dev, gen, errs, main_counts, paths,
                                      dtypes=((torch.bfloat16, BF16_OPS_PER_S),), layout=label, per_step=None)
    skewed_layout_checks(minibatches[0]["batch"].adjacency, dev, gen)
    varmisuse_kernel_checks(vm_batches[0]["batch"].adjacency, dev, gen)
    g2s_adj = g2s_batches[0]["batch"].adjacency
    kernels += graph2seq_kernel_entries(g2s_adj, dev, gen, entry)
    kernels += broadcast_width_entries(g2s_adj, "Graph2Seq batch", paths["graph2seq"].by_width, widths_by_path,
                                       dev, gen, entry)
    layers_adj = layers_batches[0][0].adjacency
    kernels += layers_kernel_entries(layers_adj, layers_seen, dev, gen, entry)
    kernels += broadcast_width_entries(layers_adj, "Graph2Class batch, layers stack", paths["layers"].by_width,
                                       widths_by_path, dev, gen, entry)
    # K6 at every (tiles, tile, Din, M, types) a path launched it at: checked
    # and timed there, faster than the route it replaced.
    kernels += typed_dw_phase(dev, sorted({k for by_shape in dw_by_path.values() for k in by_shape}), dw_by_path)
    # K7 at every (E, C, column offset, tile, dtype) a path launched it at,
    # and at the Graph2Seq benchmark's [131072, 128] block in both
    # orientations and dtypes: checked bitwise and timed there.
    keyed_shapes = {k for by_shape in keyed_by_path.values() for k in by_shape} | set(KEYED_DROPOUT_SHAPES)
    kernels += keyed_dropout_phase(dev, sorted(keyed_shapes), keyed_by_path)
    argmax_err = argmax_kernel_checks(adj, dev, gen)
    kernels.append(argmax_kernel_entry(adj, dev, gen, argmax_err, main_counts["segment_extremum_argmax"],
                                       {k: v["segment_extremum_argmax"] for k, v in paths.items()}))
    torch.cuda.synchronize()
    sanitizer_phase()

    phase("world", "this run drives one card; the multi-card path (DistributedModelTrainer with ZeRO-1, the "
          "edge-, node- and 2 x 2 hybrid-sharded steps and trainer, checkpoints and the distributed CLI at world 4 "
          "over NCCL, compiled against eager) runs under `python3 chip_smoke.py --world 4` on four cards of one "
          "host")
    phase("total", f"{time.perf_counter() - t_start:.1f} s from the start, the kernel builds included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
