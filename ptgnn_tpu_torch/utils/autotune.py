"""Padding autotuner: pick the ``BatchPadding`` with the highest measured
train-step throughput for a model and its data. The counterpart of the JAX
package's ``utils/autotune.py``.

Every kernel of a step walks the padded layout, real edges or not, and the
host's share of a step depends on the batch size, so the budgets
(``max_nodes``, the edge slots) are worth a measured sweep per deployment.

Usage::

    from ptgnn_tpu_torch.utils.autotune import autotune_task_model

    model, results = autotune_task_model(
        model, training_data, minibatch_size=300,
        reference_budgets_fn=typilus_reference_budgets,
    )
    best = results[0]  # sorted by measured edges/s, best first

Timing: each repeat runs ``steps`` compiled train steps (one CUDA graph
replay each, as the JAX package times its jitted steps) between two CUDA
events, host dispatch included;
a candidate's time is the median of ``REPEATS`` (3) repeats, since wall times
of one configuration spread up to twofold between runs. On the CPU the
host clock stands in for the events.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
import logging
import math
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ptgnn_tpu_torch.core.trainer import TrainStep
from ptgnn_tpu_torch.device import DeviceLike
from ptgnn_tpu_torch.graph.structs import BatchPadding, tree_to
from ptgnn_tpu_torch.utils.oom import is_oom_error, release_cached_memory

LOGGER = logging.getLogger(__name__)

# Repeats of a candidate's timed steps; its time is their median.
REPEATS = 3

# padding -> (the module on its device, host minibatches of that padding)
BuildFn = Callable[[BatchPadding], Tuple[torch.nn.Module, List[Dict[str, Any]]]]


@dataclasses.dataclass
class TuneResult:
    padding: BatchPadding
    edges_per_sec: float
    ms_per_step: float
    real_edges: int
    real_graphs: int
    error: Optional[str] = None


def default_candidates(
    *,
    max_nodes_options: Sequence[int] = (4096, 8192, 16384),
    slots_per_node_options: Sequence[float] = (5.0, 6.0, 8.0),
    edge_tile: int = 128,
    agg_rows: int = 256,
    agg_sum_tile: int = 512,
    reference_budgets_fn: Optional[Callable[[int], tuple]] = None,
) -> List[BatchPadding]:
    """The JAX package's candidate grid: every ``max_nodes`` option at every
    slots-per-node ratio."""
    cands = []
    for mn in max_nodes_options:
        for spn in slots_per_node_options:
            budgets = reference_budgets_fn(mn) if reference_budgets_fn is not None else ()
            cands.append(
                BatchPadding(
                    max_nodes=mn,
                    max_edge_slots=int(mn * spn) // edge_tile * edge_tile,
                    max_graphs=max(8, mn // 1024),
                    edge_tile=edge_tile,
                    agg_rows=agg_rows,
                    agg_sum_tile=agg_sum_tile,
                    reference_budgets=budgets,
                )
            )
    return cands


def _infeasible(padding: BatchPadding, error: str) -> TuneResult:
    return TuneResult(padding, 0.0, float("inf"), 0, 0, error=error)


def _time_steps(module: torch.nn.Module, minibatch: Dict[str, Any], *, steps: int, amp: bool, optimizer_creator,
                seed: int) -> Tuple[float, float]:
    """(the warm-up step's loss, the median ms of ``steps`` train steps over
    ``REPEATS`` repeats): the trainer's compiled step (:class:`TrainStep`:
    module_loss, backward, clip 1.0 and the optimizer) on one
    device-resident minibatch. The step's graphs are freed before it
    returns, so candidates do not pile up memory pools."""
    device = next(module.parameters()).device
    step = TrainStep(module, optimizer_creator(module.parameters()), clip_gradient_norm=1.0, amp=amp)

    def run(i: int) -> torch.Tensor:
        step.generator.manual_seed(seed + i)
        return step.step(minibatch)[0]

    try:
        first = float(run(0))  # compiles and waits for the warm-up step
        times = []
        for r in range(REPEATS):
            if device.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for i in range(steps):
                    run(1 + r * steps + i)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                for i in range(steps):
                    loss = run(1 + r * steps + i)
                float(loss)
                times.append(1e3 * (time.perf_counter() - t0))
    finally:
        step.clear()
    return first, statistics.median(times) / steps


def measure_padding(
    build: BuildFn,
    padding: BatchPadding,
    *,
    steps: int = 30,
    amp: bool = True,
    optimizer_creator=None,
    seed: int = 0,
) -> TuneResult:
    """Build the model at this padding and measure its train-step
    throughput on the first minibatch. A build failure, no graph fitting,
    a non-finite warm-up loss or a device OOM makes the candidate
    infeasible (``error`` set) instead of raising."""
    optimizer_creator = optimizer_creator or (lambda params: torch.optim.Adam(params, lr=1e-3))
    try:
        module, minibatches = build(padding)
    except Exception as e:  # noqa: BLE001 - a budget too small, an OOM, ...: the candidate is infeasible
        LOGGER.debug("autotune: building %s failed", _tag(padding), exc_info=True)
        release_cached_memory()
        return _infeasible(padding, repr(e))
    if not minibatches:
        # every sampled graph exceeds this candidate's budgets
        return _infeasible(padding, "no graphs fit")
    host = minibatches[0]
    edges, graphs = int(host["batch"].num_edges), int(host["batch"].num_graphs)
    error = None
    try:
        first, ms = _time_steps(module, tree_to(host, next(module.parameters()).device), steps=steps, amp=amp,
                                optimizer_creator=optimizer_creator, seed=seed)
        if not math.isfinite(first):
            error = "non-finite loss"
    except RuntimeError as e:
        if not is_oom_error(e):
            raise
        error = repr(e)
    if error is not None:
        del module, minibatches
        release_cached_memory()
        return _infeasible(padding, error)
    return TuneResult(padding, edges / (ms / 1e3), ms, edges, graphs)


def sweep_paddings(
    build: BuildFn,
    candidates: Sequence[BatchPadding],
    *,
    steps: int = 30,
    amp: bool = True,
    optimizer_creator=None,
) -> List[TuneResult]:
    """Measure every candidate; return the results best first (by edges/s).
    Infeasible candidates come last with ``error`` set instead of aborting
    the sweep."""
    results = []
    for padding in candidates:
        r = measure_padding(build, padding, steps=steps, amp=amp, optimizer_creator=optimizer_creator)
        if r.error:
            LOGGER.info("autotune: candidate %s infeasible: %s", _tag(padding), r.error)
        else:
            LOGGER.info(
                "autotune: %s -> %.0fk edges/s (%.3f ms/step, %d real edges)",
                _tag(padding), r.edges_per_sec / 1e3, r.ms_per_step, r.real_edges,
            )
        results.append(r)
    return sorted(results, key=lambda r: -r.edges_per_sec)


def _tag(p: BatchPadding) -> str:
    return f"nodes={p.max_nodes} slots={p.max_edge_slots} tile={p.edge_tile} rows={p.agg_rows}"


def clone_with_padding(model, padding: BatchPadding):
    """Deep-copy a (metadata-initialized) task model with every embedded
    ``GraphNeuralNetworkModel`` re-budgeted to ``padding``. Metadata
    (vocabularies, edge-type registries) does not depend on the padding, so
    the clone tensorizes and batches at the new shapes without a second
    pass over the data."""
    from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetworkModel

    clone = copy.deepcopy(model)
    seen = set()

    def walk(obj):
        if id(obj) in seen or not hasattr(obj, "__dict__"):
            return
        seen.add(id(obj))
        if isinstance(obj, GraphNeuralNetworkModel):
            obj.padding = padding
            obj.max_nodes_per_graph = min(obj.max_nodes_per_graph, padding.max_nodes)
            obj.stop_extending_minibatch_after_num_nodes = min(
                obj.stop_extending_minibatch_after_num_nodes, padding.max_nodes
            )
        for v in obj.__dict__.values():
            walk(v)

    walk(clone)
    return clone


def autotune_task_model(
    model,
    training_data,
    *,
    minibatch_size: int,
    candidates: Optional[Sequence[BatchPadding]] = None,
    reference_budgets_fn: Optional[Callable[[int], tuple]] = None,
    sample_limit: int = 64,
    steps: int = 20,
    amp: bool = True,
    parallelize: bool = True,
    device: DeviceLike = None,
):
    """Measure candidate paddings on the task's own data and return
    (the re-budgeted model clone, the sorted ``TuneResult`` list).

    Computes the metadata once (if needed), tensorizes up to
    ``sample_limit`` training samples, then for each candidate re-budgets a
    clone, builds its module on ``device`` (CUDA unless the caller names
    another) and one real minibatch, and measures the train step. The train
    CLIs run it under ``--autotune``."""
    if not model.metadata_initialized:
        model.compute_metadata(iter(training_data), parallelize=parallelize)
    tensorized = [
        t for t, _ in model.tensorize_dataset(itertools.islice(iter(training_data), sample_limit),
                                              parallelize=parallelize)
    ]
    if not tensorized:
        raise RuntimeError("autotune: no training sample survived tensorization")
    if candidates is None:
        candidates = default_candidates(reference_budgets_fn=reference_budgets_fn)

    def build(padding: BatchPadding):
        m = clone_with_padding(model, padding)
        module = m.build_neural_module(device=device, seed=0)
        mbs = []
        for mb, _ in m.minibatch_iterator(((t, None) for t in tensorized), max_minibatch_size=minibatch_size,
                                          parallelize=False):
            mbs.append(mb)
            break
        return module, mbs

    results = sweep_paddings(build, candidates, steps=steps, amp=amp)
    best = results[0]
    if best.error is not None:
        raise RuntimeError(f"autotune: every candidate failed: {results}")
    LOGGER.info("autotune: selected %s (%.0fk edges/s)", _tag(best.padding), best.edges_per_sec / 1e3)
    return clone_with_padding(model, best.padding), results
