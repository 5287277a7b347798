"""Compiled steps: the counterpart of ``jax.jit`` for the port's step
functions.

The JAX package compiles every step it runs (the trainer's train, eval and
accumulation steps, the serving functions, the Graph2Seq encoder) once per
static batch shape, and the padded layout (``BatchPadding``) exists so that
each compiles once. :class:`CompiledStep` does the same on the card: it
captures one call of a step function into a ``torch.cuda.CUDAGraph`` per
call signature and replays it, so a step costs one graph launch instead of
one Python dispatch per kernel.

* **Signature.** The tree structure of the arguments (dicts, lists, tuples,
  NamedTuples), every tensor leaf's shape, dtype and device, the values of
  the other leaves (Python flags such as train or eval, which are static
  here as under ``jit``), and whether autograd records: jit's per-shape
  cache key.
* **First call of a signature** on CUDA: static input buffers are allocated
  and filled; ``warmup_calls`` eager calls (:data:`WARMUP_CALLS` unless the
  step sets its own) run on a side stream and grow what a step allocates
  lazily (the row reductions' scratch, cuBLAS's workspace, NCCL's
  communicators); the last of them runs with
  ``torch.cuda.set_sync_debug_mode("error")``, so a step that waits for the
  device raises. The tensors the step writes in place (``state``:
  parameters, gradients, optimizer state) and its generators are then put
  back as they were, and one call is captured. That call's graph is then
  replayed for the first call's result, so the first call returns what an
  eager call would have, and leaves the state as an eager call would.
  Whatever ``state`` does not name carries on from the warm-ups: that is
  how a step keeps bookkeeping that must advance, such as
  ``DistributedDataParallel``'s reducer, which needs its first eager
  iterations (bucket rebuild, static-graph discovery) behind it before a
  capture.
* **Collectives.** NCCL collectives (``all_reduce``, ``broadcast``,
  ``all_to_all_single``) issued on the capture stream are captured like
  kernels and run on every replay. The process group must be made with
  NCCL's asynchronous error handling off
  (``parallel/distributed_trainer.initialize_multi_host`` sees to it), so
  that no watchdog queries an event of a captured collective.
* **Later calls** copy the arguments into the static buffers, replay the
  graph and return the static outputs. A replay overwrites the outputs of
  the previous one: the caller takes what it keeps before the next call.
* **CPU**: the step function runs as a plain call; no graph exists there.
* **No fallback.** A capture that fails raises, after ending the capture and
  dropping the partial graph; the state is as before the call. A device OOM
  propagates as ``torch.OutOfMemoryError``, so the trainer's skip handles it.
* **Counters.** A capture runs the step's Python once, but launches nothing.
  The counters in :data:`REPLAYED_COUNTERS` (the kernel wrappers'
  ``launches``, the broadcast's launches by width, the keyed dropout's
  elements, and any a caller registers) and those a step names
  (``counters``: a data-parallel step's all-reduce calls and bytes) are
  put back after a capture to their values before it, and every replay
  adds what the capture added, so they count what ran on the card: the
  warm-up calls and every replay. A counter is an integer or a dict of
  integers (a tally by key).
* **Generators** (``generators``) are registered with each graph, so a
  replay draws from the generator's current seed and offset: reseeded with
  ``s``, it draws exactly what an eager call seeded with ``s`` draws.
* **Phase marks** (``utils/tracing.py``): a graph is captured with
  ``keep_graph=True`` and instantiated here, so that the phase marks it
  captured can be switched in its executable graph. Before each replay the
  graph's marks are enabled where :func:`tracing.marking` holds (a profiler
  records, or marking was turned on) and disabled otherwise; they are
  switched only when that changes, and a disabled mark runs as an empty
  node. Spans: ``ptgnn.compiled_step.capture`` (the warm-up and capture:
  :class:`CaptureStats` ``seconds``), ``ptgnn.compiled_step.stage`` (the
  copies into the static buffers) and ``ptgnn.compiled_step.replay`` (the
  replay and the counters; on the CPU, the plain call).
"""
from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ptgnn_tpu_torch.ops import segment_kernels as sk
from ptgnn_tpu_torch.ops.keyed_dropout import keyed_dropout_kernel
from ptgnn_tpu_torch.ops.typed_linear import typed_dw_kernel
from ptgnn_tpu_torch.utils import tracing

__all__ = ["CompiledStep", "REPLAYED_COUNTERS", "WARMUP_CALLS", "canonical_device"]

# Eager calls before a capture. One is enough for the port's steps: it runs
# every lazy allocation of the step on the stream the capture uses.
WARMUP_CALLS = 1

# (owner, attribute) of every counter that a replay adds to as its capture
# did: the kernel wrappers' launch counters, the broadcast's tally by width,
# the typed dW's and the keyed dropout's by shape, the elements the keyed
# dropout hashed, and any a caller adds.
REPLAYED_COUNTERS: List[Tuple[Any, str]] = [(fn, "launches") for fn in sk.kernel_wrappers()] + [
    (sk.planned_broadcast_to_edges, "launches_by_width"), (typed_dw_kernel, "launches_by_shape"),
    (keyed_dropout_kernel, "launches_by_shape"), (tracing, "keyed_dropout_elements"),
]


def _counter_value(owner: Any, name: str) -> Any:
    value = getattr(owner, name)
    return dict(value) if isinstance(value, dict) else value


def _counter_added(after: Any, before: Any) -> Any:
    """What a capture added to a counter (an integer, or a dict of the keys
    that changed); falsy when nothing."""
    if isinstance(after, dict):
        return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    return after - before


def _counter_set(owner: Any, name: str, value: Any) -> None:
    current = getattr(owner, name)
    if isinstance(current, dict):  # in place: callers may hold the dict
        current.clear()
        current.update(value)
    else:
        setattr(owner, name, value)


def _counter_add(owner: Any, name: str, added: Any) -> None:
    current = getattr(owner, name)
    if isinstance(current, dict):
        for k, n in added.items():
            current[k] = current.get(k, 0) + n
    else:
        setattr(owner, name, current + added)


def canonical_device(device) -> torch.device:
    """``device`` with the current card's index where it names CUDA
    without one: the device a compiled step runs on, and a cache key."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


# ---------------------------------------------------------------------------
# Trees of arguments
# ---------------------------------------------------------------------------
def _flatten(tree: Any, leaves: List[Any]) -> Hashable:
    """Append ``tree``'s leaves to ``leaves``; returns its structure, in which
    a tensor is a placeholder and any other leaf stands for itself."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return torch.Tensor
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    return ("leaf", tree)


def _unflatten(structure: Hashable, tensors: Iterable[torch.Tensor]) -> Any:
    """The tree of ``structure`` with its tensors taken from ``tensors``."""
    if structure is torch.Tensor:
        return next(tensors)
    kind, body = structure
    if kind == "leaf":
        return body
    if kind is dict:
        return {k: _unflatten(v, tensors) for k, v in body}
    items = [_unflatten(x, tensors) for x in body]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def signature(args: tuple, kwargs: dict) -> Tuple[Hashable, List[torch.Tensor]]:
    """(the cache key of a call, its tensor leaves in order)."""
    leaves: List[Any] = []
    structure = _flatten((args, kwargs), leaves)
    shapes = tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)
    return (structure, shapes, torch.is_grad_enabled(), torch.is_inference_mode_enabled()), leaves


# ---------------------------------------------------------------------------
# The compiled step
# ---------------------------------------------------------------------------
class CaptureStats(NamedTuple):
    """What one signature's capture cost: the warm-up and capture seconds
    (the first call's, its replay excluded) and the bytes its graph's
    private memory pool took from the device."""

    seconds: float
    pool_bytes: int


@dataclass
class _Entry:
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]  # the static input buffers, in leaf order
    outputs: Any  # the static outputs
    counted: List[Tuple[Any, str, int]]  # (owner, attribute, what one replay adds)
    stats: CaptureStats
    marks: Any  # the nodes of the phase marks the graph holds (utils/tracing.graph_marks)
    marks_on: bool  # whether they are enabled


def _end_failed_capture(graph: torch.cuda.CUDAGraph) -> None:
    """End a capture whose step raised, and drop what it recorded. A capture
    that the error invalidated ends all the same: its stream leaves capture
    mode, and ``capture_end`` reports the invalidation, which the step's own
    error supersedes."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
    graph.reset()


class CompiledStep:
    """``fn`` compiled per call signature on ``device`` (a plain call on the
    CPU). ``state``: returns the tensors a call writes in place (restored
    after the warm-up); ``generators``: those the step draws from;
    ``warmup_calls``: the eager calls before a capture; ``counters``:
    ``(owner, attribute)`` integer counters of this step's own, replayed
    as :data:`REPLAYED_COUNTERS` are. ``fn`` is the uncompiled function:
    calling it runs the step eagerly."""

    def __init__(
        self,
        fn: Callable[..., Any],
        device: torch.device,
        *,
        state: Optional[Callable[[], Sequence[torch.Tensor]]] = None,
        generators: Sequence[torch.Generator] = (),
        warmup_calls: Optional[int] = None,
        counters: Sequence[Tuple[Any, str]] = (),
    ):
        self.fn = fn
        self.device = canonical_device(device)
        self._state = state
        self._generators = list(generators)
        self.warmup_calls = WARMUP_CALLS if warmup_calls is None else warmup_calls
        if self.warmup_calls < 1:
            raise ValueError("a compiled step needs at least one warm-up call")
        self._counters = list(counters)
        self._entries: Dict[Hashable, _Entry] = {}

    def __call__(self, *args, **kwargs):
        if self.device.type != "cuda":
            with tracing.span("ptgnn.compiled_step.replay"):
                return self.fn(*args, **kwargs)
        key, leaves = signature(args, kwargs)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._compile(key, leaves)
            self._entries[key] = entry
        else:
            with tracing.span("ptgnn.compiled_step.stage"):
                for buf, leaf in zip(entry.inputs, leaves):
                    buf.copy_(leaf)
        with tracing.span("ptgnn.compiled_step.replay"):
            if len(entry.marks) and entry.marks_on != tracing.marking():
                entry.marks_on = not entry.marks_on
                tracing.set_graph_marks(entry.graph, entry.marks, entry.marks_on)
            entry.graph.replay()
            for owner, name, added in entry.counted:
                _counter_add(owner, name, added)
        return entry.outputs

    # ------------------------------------------------------------------
    def stats(self) -> List[CaptureStats]:
        """The capture cost of every signature compiled so far."""
        return [entry.stats for entry in self._entries.values()]

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Free every signature's graph and its memory pool."""
        entries, self._entries = list(self._entries.values()), {}
        if entries and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # no replay in flight
        for entry in entries:
            entry.graph.reset()
        del entries
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def _compile(self, key: Hashable, leaves: List[torch.Tensor]) -> _Entry:
        for leaf in leaves:
            if leaf.device != self.device:
                raise ValueError(f"a compiled step on {self.device} was given a tensor on {leaf.device}")
        with tracing.span("ptgnn.compiled_step.capture") as timed:
            graph, inputs, outputs, counted, reserved = self._capture(key, leaves)
            marks = tracing.graph_marks(graph)
            marks_on = tracing.marking()
            if len(marks) and not marks_on:
                tracing.set_graph_marks(graph, marks, False)
        stats = CaptureStats(timed.seconds, torch.cuda.memory_reserved(self.device) - reserved)
        return _Entry(graph, inputs, outputs, counted, stats, marks, marks_on)

    def _capture(self, key: Hashable, leaves: List[torch.Tensor]) -> Tuple[Any, ...]:
        """(graph, static inputs, static outputs, replayed counters, the
        bytes the device reserved before the graph's pool) of a signature's
        warm-up and capture."""
        inputs = [torch.empty_like(leaf).copy_(leaf) for leaf in leaves]
        args, kwargs = _unflatten(key[0], iter(inputs))
        stream = torch.cuda.Stream(self.device)
        self._warm_up(stream, args, kwargs)

        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for generator in self._generators:
            graph.register_generator_state(generator)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # the warm-up's blocks, for the graph's pool
        reserved = torch.cuda.memory_reserved(self.device)
        counters = REPLAYED_COUNTERS + self._counters
        before = [_counter_value(owner, name) for owner, name in counters]
        stream.wait_stream(torch.cuda.current_stream(self.device))
        # No collection during the capture: garbage that holds another
        # graph would free it there, which the CUDA runtime does not permit
        # while a stream captures, and the capture would be invalidated.
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin()
                try:
                    outputs = self.fn(*args, **kwargs)
                except BaseException:
                    _end_failed_capture(graph)
                    raise
                graph.capture_end()
            graph.instantiate()
        finally:
            if collecting:
                gc.enable()
            after = [_counter_value(owner, name) for owner, name in counters]
            for (owner, name), value in zip(counters, before):
                _counter_set(owner, name, value)
            torch.cuda.current_stream(self.device).wait_stream(stream)
        counted = [(owner, name, added) for (owner, name), a, b in zip(counters, after, before)
                   if (added := _counter_added(a, b))]
        return graph, inputs, outputs, counted, reserved

    def _warm_up(self, stream: torch.cuda.Stream, args: tuple, kwargs: dict) -> None:
        """``warmup_calls`` eager calls on ``stream``, the last of which may
        not wait for the device (the earlier ones may: a step's first
        iterations can hold one-off bookkeeping); then the state and the
        generators as before them."""
        current = torch.cuda.current_stream(self.device)
        state = list(self._state()) if self._state is not None else []
        saved = [t.clone() for t in state]
        generators = [g.get_state() for g in self._generators]
        debug_mode = torch.cuda.get_sync_debug_mode()
        stream.wait_stream(current)
        try:
            with torch.cuda.stream(stream):
                for _ in range(self.warmup_calls - 1):
                    self.fn(*args, **kwargs)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self.fn(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(debug_mode)
        finally:
            current.wait_stream(stream)
            with torch.no_grad():
                for t, s in zip(state, saved):
                    t.copy_(s)
            for g, s in zip(self._generators, generators):
                g.set_state(s)
