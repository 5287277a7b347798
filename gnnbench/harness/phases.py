"""The train step's phases on the device clock, from the phase marks that
the program's train step launches inside its CUDA graph
(``ptgnn_tpu_torch/csrc/trace_mark.cu``, ``utils/tracing.py``): mark 0
before the forward, 1 before the backward, 2 before the clip and the
optimizer, 3 after the gradients are zeroed. A mark is a device operation
named ``trace_mark_kernel<id>``; a program without marks leaves the trace
without them, and the readers read nothing.

A step runs from its mark 0 to the next step's mark 0, so the window's last
step, which has no next, is not read. Its four phases are the intervals
between consecutive marks (forward 0-1, backward 1-2, optimizer 2-3,
staging 3 to the next 0: the device's time outside the graph), and add up
to the step. A step whose marks are not exactly 0, 1, 2, 3 followed by a 0
lost an event in the trace and is left out; where more than
``trace.LOST_EVENTS`` of the window's steps are left out, nothing is read.
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

from . import trace

MARK = re.compile(r"trace_mark_kernel<(\d+)>")
PHASES = ("forward", "backward", "optimizer", "staging")


def marks(tr: trace.Trace) -> List[Tuple[int, int]]:
    """(start ns, id) of every phase mark in the window, in order."""
    found = []
    for name, a, _ in tr.device_ops:
        m = MARK.search(name)
        if m:
            found.append((a, int(m.group(1))))
    return sorted(found)


def complete_steps(found: List[Tuple[int, int]]) -> List[Tuple[int, ...]]:
    """The start of each mark 0, 1, 2, 3 and of the next 0, of every step
    whose marks are all there, in order."""
    out = []
    for k in range(len(found) - 4):
        window = found[k:k + 5]
        if [i for _, i in window] == [0, 1, 2, 3, 0]:
            out.append(tuple(t for t, _ in window))
    return out


def mean_ms(run) -> Optional[Tuple[float, float, float, float]]:
    """The mean forward, backward, optimizer and staging milliseconds over
    the window's complete steps, or None (no marks, or too many lost)."""
    steps = complete_steps(marks(run.trace))
    readable = max(run.steps - 1, 0)
    if not steps or readable - len(steps) > trace.LOST_EVENTS * run.steps:
        return None
    n = len(steps)
    return tuple(1e-6 * sum(s[k + 1] - s[k] for s in steps) / n for k in range(4))


def phase_ms(run, phase: str) -> Optional[float]:
    found = mean_ms(run)
    return None if found is None else found[PHASES.index(phase)]


def by_phase(tr: trace.Trace) -> List[Dict[str, int]]:
    """Per phase (``PHASES``' order), the device nanoseconds of each
    operation name that started after a mark of that phase and before the
    next mark; the marks themselves and what ran before the first are left
    out."""
    found = marks(tr)
    starts = [t for t, _ in found]
    out: List[Dict[str, int]] = [{} for _ in PHASES]
    for name, a, b in tr.device_ops:
        k = bisect.bisect_right(starts, a) - 1
        if k < 0 or MARK.search(name):
            continue
        ops = out[found[k][1]]
        ops[name] = ops.get(name, 0) + (b - a)
    return out
