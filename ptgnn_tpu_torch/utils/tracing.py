"""Where the port's time goes: host spans, the train step's phase marks and
the counter table.

* :class:`span` (``with span(name):``) times a block on the host. It always
  adds to in-memory totals kept by name (:func:`totals`: count, seconds and
  self seconds, the span's seconds less those of the spans opened inside it
  on the same thread). While a ``torch.profiler`` records, it also opens a
  ``record_function`` range of the same name, so the block sits in the
  profiler's trace on the clock of the device's operations, and an idle gap
  of the device can be set against it. With no profiler it costs a flag
  check and two clock reads. A span whose name is already open on its
  thread (a sub-model's ``tensorize`` inside its parent's) is part of the
  open one: it opens no range and adds nothing. A span given no ``args``
  takes those of the span it is opened in, so the spans of one train step
  carry that step's ordinal.
* :func:`mark` launches a phase mark: an empty one-thread kernel
  (``csrc/trace_mark.cu``) whose name carries its id, ``trace_mark_kernel<id>``,
  on the device's current stream. It launches while :func:`marking` holds,
  or while that stream is being captured, so that a compiled step's CUDA
  graph holds it; ``core/compiled_step.py`` keeps a graph's marks enabled
  while :func:`marking` holds and disabled otherwise (a disabled node runs
  as an empty one). On the CPU a mark does nothing. The train step
  (``core/trainer.py::TrainStep``) marks :data:`FORWARD` before the
  forward, :data:`BACKWARD` before ``loss.backward()``, :data:`OPTIMIZER`
  before the clip and :data:`UPDATED` after the gradients are zeroed.
  Graph2Seq (``implementations/graph2seq/graph2seq.py``) marks
  :data:`ENCODED` where the encoder's forward hands its node states on and
  :data:`DECODER_GRAD` where their gradient is complete, so the decoder's
  backward hands over to the encoder's; the fused op (``ops/fused_mp.py``)
  marks :data:`KEYED_BEGIN` and :data:`KEYED_END` around each keyed
  message-dropout mask it makes and applies.
* :func:`marking`: a profiler records, or :func:`set_marking` turned marks on.
* The counter table: integer counts by name and key, always on. Whatever
  counts something adds to it in one line (:func:`count`), with no list of
  counters anywhere: each kernel wrapper its launches (``typed_dw``,
  ``keyed_dropout`` and ``broadcast_to_edges`` keyed by the shape they ran
  at), the fused op ``keyed_dropout_elements``, the elements the keyed
  message-dropout hash covered, a data-parallel step its all-reduce calls
  and bytes under its own key. A counter reads 0 before its first count.
  A compiled step (``core/compiled_step.py``) puts the table back after a
  capture and adds what the capture counted on every replay, so counts are
  executions on the device. ``ops/segment_kernels.launch_counts`` is the
  view of it that the benchmark reads.

The spans the port opens:

==================================  ==========================================================
``ptgnn.train_step``                ``TrainStep.step``: the rates, the staging and the launch
``ptgnn.compiled_step.capture``     a signature's warm-up and capture (``CaptureStats.seconds``)
``ptgnn.compiled_step.stage``       the copies of a call's arguments into the static buffers
``ptgnn.compiled_step.replay``      ``graph.replay()`` and the counters (the plain call on the CPU)
``ptgnn.model.tensorize``           a root model's ``tensorize``
``ptgnn.model.extend_minibatch``    a root model's ``extend_minibatch_with``
``ptgnn.model.finalize_minibatch``  a root model's ``finalize_minibatch``
``ptgnn.handoff.send`` / ``receive``  a node handoff's slot messages (``NodeHandoff.stats``)
``ptgnn.handoff.pack`` / ``unpack``   their packing and unpacking, inside them
``ptgnn.kernels.build``             the nvcc builds of ``ops/cuda_build.py`` and the g++ build
                                    of ``native/``
==================================  ==========================================================

A forked tensorize child (``core/iterators.BufferedIterator``) keeps its
spans to itself.
"""
from __future__ import annotations

import ctypes
import functools
import os
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Tuple

import torch

__all__ = ["span", "spanned", "totals", "reset", "count", "counter", "tally", "counters", "set_counters",
           "add_counters", "reset_counters", "mark", "marking", "set_marking", "graph_marks", "set_graph_marks",
           "FORWARD", "BACKWARD", "OPTIMIZER", "UPDATED", "ENCODED", "DECODER_GRAD", "KEYED_BEGIN", "KEYED_END"]

# The phase marks' ids: the train step's four, in a step's order, then the
# marks of the layers inside its phases.
FORWARD, BACKWARD, OPTIMIZER, UPDATED, ENCODED, DECODER_GRAD, KEYED_BEGIN, KEYED_END = range(8)

_clock = time.perf_counter
_LOCK = threading.Lock()
_TOTALS: Dict[str, List[float]] = {}  # name -> [count, seconds, self seconds]
_LOCAL = threading.local()  # .stack: the spans open on this thread, innermost last
_MARKING = False
_COUNTS: Dict[Tuple[str, Hashable], int] = {}  # (name, key) -> count, under _LOCK


def _reinit_in_child() -> None:
    """A forked child starts with a free lock and no open spans (another
    thread of the parent may have held the lock at the fork)."""
    global _LOCK, _LOCAL
    _LOCK = threading.Lock()
    _LOCAL = threading.local()


os.register_at_fork(after_in_child=_reinit_in_child)


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class span:
    """``with span(name[, args]) as s:`` times the block; ``s.seconds`` holds
    its duration after it (also where a same-named span was open, and the
    block added nothing)."""

    __slots__ = ("name", "args", "seconds", "_start", "_child", "_range", "_counted")

    def __init__(self, name: str, args: Any = None):
        self.name = name
        self.args = args
        self.seconds = 0.0

    def __enter__(self) -> "span":
        stack = _stack()
        self._counted = all(s.name != self.name for s in stack)
        self._range = None
        if self._counted:
            if self.args is None and stack:
                self.args = stack[-1].args
            self._child = 0.0
            stack.append(self)
            if _profiling():
                self._range = torch.autograd.profiler.record_function(
                    self.name, None if self.args is None else str(self.args))
                self._range.__enter__()
        self._start = _clock()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = _clock() - self._start
        if not self._counted:
            return
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1]._child += self.seconds
        with _LOCK:
            entry = _TOTALS.setdefault(self.name, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += self.seconds
            entry[2] += self.seconds - self._child


def spanned(name: str) -> Callable[[Callable], Callable]:
    """A decorator: every call of the function is a :class:`span` ``name``."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def totals() -> Dict[str, Dict[str, float]]:
    """The spans closed in this process since the last :func:`reset`, by
    name: ``count``, ``seconds`` and ``self_seconds``."""
    with _LOCK:
        return {name: {"count": int(c), "seconds": s, "self_seconds": own} for name, (c, s, own) in _TOTALS.items()}


def reset() -> None:
    with _LOCK:
        _TOTALS.clear()


def count(name: str, key: Hashable = None, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` under ``key``."""
    entry = (name, key)
    with _LOCK:
        _COUNTS[entry] = _COUNTS.get(entry, 0) + n


def counter(name: str) -> int:
    """Counter ``name`` summed over its keys: 0 before its first count."""
    return sum(tally(name).values())


def tally(name: str) -> Dict[Hashable, int]:
    """Counter ``name`` by key."""
    with _LOCK:
        return {key: n for (counted, key), n in _COUNTS.items() if counted == name}


def counters() -> Dict[Tuple[str, Hashable], int]:
    """A snapshot of the whole table, by (name, key)."""
    with _LOCK:
        return dict(_COUNTS)


def set_counters(snapshot: Dict[Tuple[str, Hashable], int]) -> None:
    """The table as :func:`counters` took it."""
    with _LOCK:
        _COUNTS.clear()
        _COUNTS.update(snapshot)


def add_counters(added: Dict[Tuple[str, Hashable], int]) -> None:
    """Add a difference of two snapshots, by (name, key)."""
    with _LOCK:
        for entry, n in added.items():
            _COUNTS[entry] = _COUNTS.get(entry, 0) + n


def reset_counters(*names: str) -> None:
    """Clear the named counters, or the whole table where none is named."""
    with _LOCK:
        for entry in [entry for entry in _COUNTS if not names or entry[0] in names]:
            del _COUNTS[entry]


def set_marking(on: bool) -> None:
    """Launch (and enable in compiled steps) the phase marks with no
    profiler recording, or only while one records."""
    global _MARKING
    _MARKING = bool(on)


def marking() -> bool:
    """Whether phase marks run: a profiler records, or :func:`set_marking`
    turned them on."""
    return _MARKING or _profiling()


def mark(mark_id: int, device: torch.device) -> None:
    """Phase mark ``mark_id`` on ``device``'s current stream: launched while
    :func:`marking` holds or the stream is being captured; nothing on the
    CPU. It changes no tensor."""
    if device.type != "cuda" or not (marking() or torch.cuda.is_current_stream_capturing()):
        return
    from ptgnn_tpu_torch.ops import cuda_build

    with torch.cuda.device(device):
        fn = cuda_build.kernel_function("trace_mark")
        cuda_build.check("trace_mark", fn(mark_id, torch.cuda.current_stream(device).cuda_stream))


def graph_marks(graph: "torch.cuda.CUDAGraph") -> "ctypes.Array":
    """The phase marks' nodes of a graph captured with ``keep_graph=True``,
    found by walking its kernel nodes (once: a walk costs milliseconds)."""
    from ptgnn_tpu_torch.ops import cuda_build

    fn = cuda_build.helper_function("trace_mark", "ptgnn_trace_mark_nodes")
    count = ctypes.c_int(0)
    cuda_build.check("trace_mark", fn(graph.raw_cuda_graph(), None, 0, ctypes.byref(count)))
    nodes = (ctypes.c_void_p * count.value)()
    if count.value:
        cuda_build.check("trace_mark", fn(graph.raw_cuda_graph(), nodes, count.value, ctypes.byref(count)))
    return nodes


def set_graph_marks(graph: "torch.cuda.CUDAGraph", nodes: "ctypes.Array", enabled: bool) -> None:
    """Enable or disable the mark ``nodes`` (:func:`graph_marks`) in the
    graph's instantiated executable graph, from its next replay on."""
    from ptgnn_tpu_torch.ops import cuda_build

    fn = cuda_build.helper_function("trace_mark", "ptgnn_trace_mark_set_enabled")
    cuda_build.check("trace_mark", fn(graph.raw_cuda_graph_exec(), nodes, len(nodes), int(enabled)))
