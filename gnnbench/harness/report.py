"""From a driver's run to the result line: the end-to-end metrics, the
per-layer readers, ``correct`` and the device record."""
from __future__ import annotations

import json
import math
import statistics
import sys
from dataclasses import dataclass
from typing import Any, Dict, List

from . import correctness, spec, trace


@dataclass
class LayerRun:
    """What a per-layer reader reads: one rank's traced window."""

    config: Dict[str, Any]
    trace: trace.Trace
    steps: int
    groups: list  # the pool.Group of each step in the window
    counters: Dict[str, Any]
    captures_s: float
    rank: int
    shapes: Dict[str, tuple]  # the parameters' shapes, by name


def p95(values: List[float]) -> float:
    if len(values) < 2:
        return values[0] if values else float("nan")
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def combine(values: List[float], how: str) -> float:
    if how == "max":
        return max(values)
    if how == "mean":
        return sum(values) / len(values)
    return values[0]  # "rank0"


def end_to_end(cell: spec.Cell, out: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    wins = out["windows"]
    values = {
        "train_edges_per_s": sum(w.edges for w in wins) / max(w.seconds for w in wins),
        "train_step_p95_ms": p95([x for w in wins for x in w.intervals_ms]),
        "setup_s": out["setup_s"],
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def per_layer(cell: spec.Cell, out: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    runs = [LayerRun(cell.config, w.trace, w.steps, groups, counters, cap, r, out["shapes"])
            for r, (w, groups, counters, cap) in enumerate(zip(out["windows"], out["groups"], out["counters"],
                                                                out["captures_s"]))]
    found = {}
    for m in cell.per_layer:
        reader = spec.metric_reader(m["name"])
        values = [v for v in (reader.read(run) for run in runs) if v is not None]
        if values:
            found[m["name"]] = {"value": combine(values, getattr(reader, "COMBINE", "rank0")), "unit": m["unit"]}
    return found


def result(cell: spec.Cell, args, out: Dict[str, Any], device_kind: str) -> Dict[str, Any]:
    """The result line's object, its checks last."""
    wins = out["windows"]
    found = correctness.gaps(out["program"], out["reference"])
    try:
        limits = correctness.limits(cell.name)
    except FileNotFoundError:
        limits = {k: 0.0 for k in correctness.NUMBERS}
    ok, checks = correctness.judge(found, limits)
    failed = sum(1 for w in wins if not math.isfinite(w.last_loss))
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips, "memory_peak_bytes": out["peak_bytes"]}
    line: Dict[str, Any] = {"correct": bool(ok and failed == 0), "attempted": sum(w.steps for w in wins),
                            "failed": failed}
    if args.trace:
        line["metrics"] = per_layer(cell, out)
        device["busy_s"] = sum(w.trace.busy_s for w in wins) / len(wins)
        device["window_s"] = sum(w.trace.window_s for w in wins) / len(wins)
        line["breakdown"] = wins[0].trace.breakdown()
    else:
        line["metrics"] = end_to_end(cell, out)
    line["device"] = device
    line["checks"] = checks
    return line


def emit(line: Dict[str, Any]) -> None:
    sys.stdout.flush()
    print(json.dumps(line), flush=True)


def describe(cell: spec.Cell, out: Dict[str, Any], traced: int) -> None:
    """Earlier lines of the standard output: the sample count, the memory
    peak, each rank's step intervals and its slowest pool batches, and in
    a traced run the kernels the trace holds against those launched."""
    print(f"{cell.name}: {sum(len(w.intervals_ms) for w in out['windows'])} step intervals in the window; "
          f"memory peak {out['peak_bytes']} bytes; reference {out['reference_s']:.3f} s", flush=True)
    for rank, w in enumerate(out["windows"]):
        q = statistics.quantiles(w.intervals_ms, n=100, method="inclusive") if len(w.intervals_ms) > 1 else [0.0] * 99
        by_batch: Dict[int, List[float]] = {}
        for k, x in enumerate(w.intervals_ms[:-1]):
            by_batch.setdefault((w.first_index + k) % cell.traffic["pool_batches"], []).append(x)
        slow = sorted(((statistics.median(v), b) for b, v in by_batch.items()), reverse=True)[:4]
        print(f"rank {rank} step intervals (ms): p5 {q[4]:.4f} p50 {q[49]:.4f} p90 {q[89]:.4f} p95 {q[94]:.4f} "
              f"p99 {q[98]:.4f} max {max(w.intervals_ms):.4f}; slowest pool batches (median ms, index) {slow}",
              flush=True)
        if traced:
            names = ("segment_sum_kernel", "segment_extremum_kernel", "broadcast_rows_kernel", "typed_matmul", "nccl")
            held = {n: w.trace.kernel_seconds(n)[1] for n in names}
            print(f"rank {rank} trace: {len(w.trace.device_ops)} device operations over {w.steps} steps; kernels "
                  f"held {held}; launched {w.counters.get('launches')}", flush=True)
