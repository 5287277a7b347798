"""What the training drivers share: one rank's set-up (model, weights,
pool of minibatches), the three checked steps, the measured window and the
reference's readings.

The window is a closed loop: each step is dispatched as soon as the host
can, with no wait for the device; a CUDA event recorded on the step's
stream before each step marks its start, so the intervals between starts
are the device's pace, and a host that falls behind shows in them. The
window ends when the last step's result is on the device (a sync).
"""
from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..harness import correctness, pool, spec, trace, weights

CHECKED_STEPS = 3  # the steps the reference follows
TRACE_SECONDS = 3.0  # the traced run's window, at most
# Before the window, the step loop runs for SETTLE_SECONDS, then the card
# idles for SETTLE_PAUSE. An H100 runs a loop of these steps at one of two
# paces about 5 % apart (at the same reported clocks) and may switch to the
# faster one seconds into the loop, never back. On one H100 a spell of 30 s
# still left a third of the windows on the slower pace (one of 4 s: about
# half), so the spell stays short.
SETTLE_SECONDS = 4.0
SETTLE_PAUSE = 2.0


@dataclass
class Window:
    steps: int
    edges: int
    seconds: float
    intervals_ms: List[float]
    first_index: int
    last_loss: float
    trace: Optional[trace.Trace] = None
    counters: Dict[str, Any] = field(default_factory=dict)


class RankSetup:
    """One rank's model, weights and pool, made from the run's seed."""

    def __init__(self, cell: spec.Cell, seed: int, device, rank: int = 0):
        import torch

        from ptgnn_tpu_torch.graph.structs import tree_to

        self.cell, self.seed, self.device, self.rank = cell, seed, device, rank
        self.config, self.traffic = cell.config, cell.traffic
        self.task = spec.task(self.config["task"])
        self.meta = pool.metadata_graphs(self.traffic, seed)
        self.types = self.task.edge_types(self.meta)
        self.model, self.module = self.task.build(self.config, self.meta, device)
        self.weights0 = weights.make(self.module, seed, device)
        weights.load(self.module, self.weights0)
        self.groups = pool.pool(self.config, self.traffic, self.task, seed, rank, self.types,
                                int(self.traffic["pool_batches"]))
        self.batches = [tree_to(self.task.minibatch(self.model, g.graphs), device) for g in self.groups]
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def batch(self, i: int):
        return self.batches[i % len(self.batches)]

    def group(self, i: int) -> pool.Group:
        return self.groups[i % len(self.groups)]

    def stats(self, first: int, count: int) -> List[pool.Group]:
        """The graph-free record of the minibatch of each step in
        ``[first, first + count)``."""
        return [pool.Group([], g.nodes, g.edges, g.references) for g in
                (self.group(i) for i in range(first, first + count))]

    def free(self) -> None:
        self.batches, self.model, self.module = [], None, None
        gc.collect()


def checked_steps(setup: RankSetup, call: Callable[[int], Any], optimizer,
                  gather: Optional[Callable[[Dict[str, float]], Dict[str, float]]] = None) -> Dict[str, Any]:
    """The program's first three steps, through the window's own call, with
    its readings: the losses, the first gradient's norms (from this rank's
    optimizer state; ``gather`` joins the ranks' shards) and, on one rank,
    the gradient itself, the change over the three steps."""
    beta1 = setup.config["optimizer"]["betas"][0]
    losses, grads, tensors = [], None, None
    for i in range(CHECKED_STEPS):
        losses.append(float(call(i)))
        if i == 0:
            grads = correctness.program_first_gradients(optimizer, setup.module, beta1)
            if gather is not None:
                grads = gather(grads)
            else:
                tensors = correctness.program_first_gradient_tensors(optimizer, setup.module, beta1)
    out = {"losses": losses, "grad_norms": grads,
           "change_norms": correctness.program_changes(setup.module, setup.weights0)}
    if tensors is not None:
        out["grads"] = tensors
    return out


def window(setup: RankSetup, call: Callable[[int], Any], start: int, *, seconds: float = 0.0,
           steps: int = 0, traced: bool = False) -> Window:
    """Steps from index ``start`` for ``seconds`` of host time, or exactly
    ``steps`` of them; traced by the profiler where ``traced``."""
    import torch

    dev = setup.device
    cuda = dev.type == "cuda"

    def mark():
        if not cuda:  # the CPU tests' runs: host marks
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    from ptgnn_tpu_torch.ops.segment_kernels import launch_counts

    if cuda:
        torch.cuda.synchronize(dev)
    launched = launch_counts()
    prof = trace.start() if traced else None
    marks = []
    edges, i, loss = 0, start, None
    with (trace.annotate() if traced else contextlib.nullcontext()):
        t0 = time.perf_counter()
        while (steps and i - start < steps) or (not steps and time.perf_counter() - t0 < seconds):
            marks.append(mark())
            loss = call(i)
            edges += setup.group(i).edges
            i += 1
        marks.append(mark())
        if cuda:
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
    tr = trace.stop(prof) if traced else None
    launched = {k: v - launched[k] for k, v in launch_counts().items()}
    pairs = zip(marks[:-1], marks[1:])
    intervals = [a.elapsed_time(b) if cuda else 1e3 * (b - a) for a, b in pairs]
    return Window(i - start, edges, elapsed, intervals, start, float(loss) if loss is not None else float("nan"), tr,
                  {"launches": launched})


def settle(setup: RankSetup, call: Callable[[int], Any], start: int, *, seconds: float = 0.0,
           steps: int = 0) -> int:
    """The loaded spell and the pause before the window (set-up): steps
    from ``start`` for ``seconds`` of host time or exactly ``steps`` of
    them. Returns the next step's index."""
    import torch

    i = start
    t0 = time.perf_counter()
    while (steps and i - start < steps) or (not steps and time.perf_counter() - t0 < seconds):
        call(i)
        i += 1
    if setup.device.type == "cuda":
        torch.cuda.synchronize(setup.device)
    time.sleep(SETTLE_PAUSE)
    return i


def reference_readings(cell: spec.Cell, seed: int, weights0, device, ranks: int = 1, fmt: str = "fp32",
                       fault: str = "") -> Dict[str, Any]:
    """The plain reference over the three checked steps of every rank."""
    config, traffic = cell.config, cell.traffic
    task = spec.task(config["task"])
    meta = pool.metadata_graphs(traffic, seed)
    types = task.edge_types(meta)
    per_rank = [pool.pool(config, traffic, task, seed, r, types, CHECKED_STEPS) for r in range(ranks)]
    steps = [[(per_rank[r][k].graphs, pool.dropout_seed(seed, k, r), per_rank[r][k].weight) for r in range(ranks)]
             for k in range(CHECKED_STEPS)]
    return correctness.reference_readings(config, meta, steps, weights0, device, fmt=fmt, fault=fault)
