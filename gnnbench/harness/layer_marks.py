"""Graph2Seq's layer marks inside the train step's phases, on the device
clock (``ptgnn_tpu_torch/utils/tracing.py``): beside the phase marks 0-3
(``harness/phases.py``), mark 4 (``ENCODED``) where the encoder's forward
hands its node states to the summariser and the decoder, mark 5
(``DECODER_GRAD``) where their gradient is complete and the decoder's
backward hands over to the encoder's, and marks 6 and 7 (``KEYED_BEGIN``,
``KEYED_END``) around each keyed message-dropout mask that the fused op
makes and applies. A program without them leaves the trace without them,
and the readers read nothing.

A step runs from its mark 0 to the next step's mark 0. It is read where
its marks, the pairs left out, are 0, 4, 1, 5, 2, 3 in that order, and its
6s and 7s alternate from a 6; otherwise the trace lost an event and the
step is left out. Where more than ``trace.LOST_EVENTS`` of the window's
steps are left out, nothing is read.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from . import phases, trace

ORDER = [0, 4, 1, 5, 2, 3]
KEYED_BEGIN, KEYED_END = 6, 7


@dataclass
class Step:
    """One step's mark starts (ns) by id, and the device ns between each
    keyed pair (the end of its 6 to the start of its 7)."""

    at: dict
    keyed_ns: int
    keyed_pairs: int


def _marks(tr: trace.Trace):
    """(start, end, id) of every mark of the window, in order."""
    found = []
    for name, a, b in tr.device_ops:
        m = phases.MARK.search(name)
        if m:
            found.append((a, b, int(m.group(1))))
    return sorted(found)


def _step(marks) -> Optional[Step]:
    plain = [(a, i) for a, _, i in marks if i not in (KEYED_BEGIN, KEYED_END)]
    if [i for _, i in plain] != ORDER:
        return None
    keyed = [(a, b, i) for a, b, i in marks if i in (KEYED_BEGIN, KEYED_END)]
    if [i for _, _, i in keyed] != [KEYED_BEGIN, KEYED_END] * (len(keyed) // 2) or len(keyed) % 2:
        return None
    ns = sum(keyed[k + 1][0] - keyed[k][1] for k in range(0, len(keyed), 2))
    return Step({i: a for a, i in plain}, ns, len(keyed) // 2)


def steps(run) -> Optional[List[Step]]:
    """The window's readable steps, or None (no layer marks, or too many
    steps lost)."""
    found = _marks(run.trace)
    if not any(i == ORDER[1] for _, _, i in found):
        return None
    starts = [k for k, (_, _, i) in enumerate(found) if i == 0]
    read = [s for s in (_step(found[a:b]) for a, b in zip(starts[:-1], starts[1:])) if s is not None]
    readable = max(run.steps - 1, 0)
    if not read or readable - len(read) > trace.LOST_EVENTS * run.steps:
        return None
    return read


def mean_ms(values: List[int]) -> float:
    return 1e-6 * sum(values) / len(values)
