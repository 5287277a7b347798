"""The port's tracing module (``ptgnn_tpu_torch/utils/tracing.py``) on the
CPU: span totals, nesting and self time; a span inside one of its own name;
spans on many threads at once; ranges in a ``torch.profiler`` trace only
while one records; the host pipeline's spans once per root call on a small
Graph2Class; the build timer as a span; phase marks that do nothing on the
CPU and leave a train step bitwise as it was. The counter table: 0 before
a first count, counts by key that add up by name, snapshots and resets,
and ``ops/segment_kernels.launch_counts``, its view, after a fused op's
forward and backward with keyed message dropout."""
import threading

import pytest
import torch

from ptgnn_tpu_torch.core.trainer import TrainStep
from ptgnn_tpu_torch.graph.structs import tree_to
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.ops import cuda_build
from ptgnn_tpu_torch.ops import segment_kernels as sk
from ptgnn_tpu_torch.ops.fused_mp import fused_typed_message_aggregation
from ptgnn_tpu_torch.utils import tracing
from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs


@pytest.fixture(autouse=True)
def fresh_totals():
    tracing.reset()
    tracing.set_marking(False)
    yield
    tracing.reset()
    tracing.set_marking(False)


def _fake_clock(monkeypatch, *ticks):
    clock = iter(ticks)
    monkeypatch.setattr(tracing, "_clock", lambda: next(clock))


def test_totals_count_seconds_and_self_seconds(monkeypatch):
    # outer 0-10 holds inner 1-4 and inner 5-6; a second outer 20-21
    _fake_clock(monkeypatch, 0.0, 1.0, 4.0, 5.0, 6.0, 10.0, 20.0, 21.0)
    with tracing.span("outer") as outer:
        with tracing.span("inner"):
            pass
        with tracing.span("inner"):
            pass
    with tracing.span("outer"):
        pass
    assert outer.seconds == 10.0
    assert tracing.totals() == {
        "outer": {"count": 2, "seconds": 11.0, "self_seconds": 7.0},
        "inner": {"count": 2, "seconds": 4.0, "self_seconds": 4.0},
    }
    tracing.reset()
    assert tracing.totals() == {}


def test_a_span_inside_one_of_its_name_is_part_of_it(monkeypatch):
    _fake_clock(monkeypatch, 0.0, 1.0, 2.0, 3.0, 4.0, 8.0)
    with tracing.span("tensorize"):
        with tracing.span("tensorize") as nested:
            with tracing.span("child"):
                pass
    assert nested.seconds == 3.0  # still timed for its caller
    assert tracing.totals() == {
        "tensorize": {"count": 1, "seconds": 8.0, "self_seconds": 7.0},
        "child": {"count": 1, "seconds": 1.0, "self_seconds": 1.0},
    }


def test_a_span_takes_the_args_of_the_span_it_is_opened_in():
    with tracing.span("ptgnn.train_step", 7):
        with tracing.span("ptgnn.compiled_step.replay") as inner:
            pass
        with tracing.span("other", 9) as own:
            pass
    with tracing.span("alone") as alone:
        pass
    assert (inner.args, own.args, alone.args) == (7, 9, None)


def test_spans_on_many_threads_lose_no_update():
    import sys

    threads, each = 16, 400
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with tracing.span("shared"):
                    with tracing.span("inner"):
                        pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    found = tracing.totals()
    assert found["shared"]["count"] == found["inner"]["count"] == threads * each
    assert found["shared"]["self_seconds"] <= found["shared"]["seconds"]


@pytest.fixture(scope="module")
def small_g2c():
    model, module, mbs = build_graph2class(padding=small_padding(max_nodes=256), hidden_state_size=16,
                                           num_minibatches=2, minibatch_size=4, num_metadata_graphs=12,
                                           mean_nodes=40, max_graph_nodes=90, device="cpu")
    return model, module, [tree_to(mb, "cpu") for mb in mbs]


def _step(module):
    return TrainStep(module, torch.optim.Adam(module.parameters(), lr=1e-3), clip_gradient_norm=1.0)


def _host_ranges(prof):
    return sorted((e.time_range.start, -e.time_range.end, e.name) for e in prof.events() if e.name.startswith("ptgnn."))


def test_the_profiler_holds_the_step_ranges_only_while_it_records(small_g2c, monkeypatch):
    import copy

    _, module, mbs = small_g2c
    step = _step(copy.deepcopy(module))
    opened = []
    real = torch.autograd.profiler.record_function

    def counted(name, *args, **kwargs):
        if name.startswith("ptgnn."):
            opened.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    step.step(mbs[0])
    assert opened == []  # no profiler: no range
    assert not tracing.marking()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.marking()
        step.step(mbs[1])
        step.step(mbs[0])
    assert opened == ["ptgnn.train_step", "ptgnn.compiled_step.replay"] * 2
    ranges = _host_ranges(prof)
    assert [name for _, _, name in ranges] == ["ptgnn.train_step", "ptgnn.compiled_step.replay"] * 2
    (s0, e0, _), (s1, e1, _) = ranges[:2]
    assert s0 <= s1 and -e1 <= -e0  # the replay inside its step
    assert tracing.totals()["ptgnn.train_step"]["count"] == 3


def test_the_host_pipeline_counts_each_root_call_once(small_g2c):
    model, _, _ = small_g2c
    graphs = list(synthetic_typilus_graphs(6, seed=5, mean_nodes=40, max_nodes=90))
    tracing.reset()
    tensorized = [model.tensorize(g) for g in graphs]
    found = tracing.totals()
    # Graph2Class.tensorize runs its graph model's tensorize inside: one span
    assert found["ptgnn.model.tensorize"]["count"] == len(graphs)
    mb = model.initialize_minibatch()
    added = 0
    for t in tensorized:
        if t is None or not model.can_add_to_minibatch(t, mb):
            continue
        model.extend_minibatch_with(t, mb)
        added += 1
    model.finalize_minibatch(mb)
    found = tracing.totals()
    assert added > 0
    assert found["ptgnn.model.extend_minibatch"]["count"] == added
    assert found["ptgnn.model.finalize_minibatch"]["count"] == 1
    for name in ("ptgnn.model.tensorize", "ptgnn.model.extend_minibatch", "ptgnn.model.finalize_minibatch"):
        assert 0 < found[name]["self_seconds"] <= found[name]["seconds"]

    tracing.reset()
    batches = list(model.minibatch_iterator(model.tensorize_dataset(iter(graphs), parallelize=False),
                                            max_minibatch_size=4, parallelize=False))
    found = tracing.totals()
    assert found["ptgnn.model.tensorize"]["count"] == len(graphs)
    assert found["ptgnn.model.finalize_minibatch"]["count"] == len(batches)
    assert found["ptgnn.model.extend_minibatch"]["count"] == sum(len(raw) for _, raw in batches)


def test_a_kernel_build_is_a_span(monkeypatch, tmp_path):
    import time

    monkeypatch.setattr(cuda_build, "_library_path", lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(cuda_build, "_build", lambda todo: time.sleep(0.01))
    seconds = cuda_build.build_all()
    found = tracing.totals()["ptgnn.kernels.build"]
    assert found["count"] == 1 and found["seconds"] == seconds >= 0.01


def test_marking_follows_the_profiler_or_the_switch():
    assert not tracing.marking()
    tracing.set_marking(True)
    assert tracing.marking()
    tracing.set_marking(False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.marking()
    assert not tracing.marking()


def test_a_mark_does_nothing_on_the_cpu_and_changes_no_step(small_g2c, monkeypatch):
    import copy

    def no_kernel(*args):
        raise AssertionError("a mark on the CPU reached the kernel library")

    monkeypatch.setattr(cuda_build, "kernel_function", no_kernel)
    tracing.set_marking(True)
    for mark in range(4):
        tracing.mark(mark, torch.device("cpu"))

    _, module, mbs = small_g2c
    runs = []
    for on in (True, False):
        tracing.set_marking(on)
        step = _step(copy.deepcopy(module))
        losses = []
        for i in range(3):
            step.generator.manual_seed(100 + i)
            losses.append(step.step(mbs[i % len(mbs)], lr_factor=0.5 + 0.25 * i)[0].clone())
        runs.append((torch.stack(losses), [p.detach().clone() for p in step.module.parameters()],
                     [v.clone() for s in step.optimizer.state.values() for v in s.values()]))
    (l_on, p_on, s_on), (l_off, p_off, s_off) = runs
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(p_on, p_off))
    assert all(torch.equal(a, b) for a, b in zip(s_on, s_off))


# ---------------------------------------------------------------------------
# the counter table
# ---------------------------------------------------------------------------
def test_a_counter_reads_zero_before_its_first_count():
    tracing.reset_counters()
    assert tracing.counter("test.never") == 0 and tracing.tally("test.never") == {}
    tracing.count("test.once")
    assert tracing.counter("test.once") == 1 and tracing.tally("test.once") == {None: 1}


def test_keyed_counts_add_up_by_name():
    tracing.reset_counters()
    tracing.count("test.keyed", (64, "float32"))
    tracing.count("test.keyed", (64, "float32"), 2)
    tracing.count("test.keyed", (128, "bfloat16"), 4)
    tracing.count("test.other", n=5)
    assert tracing.tally("test.keyed") == {(64, "float32"): 3, (128, "bfloat16"): 4}
    assert tracing.counter("test.keyed") == 7 and tracing.counter("test.other") == 5
    assert tracing.counters() == {("test.keyed", (64, "float32")): 3, ("test.keyed", (128, "bfloat16")): 4,
                                  ("test.other", None): 5}


def test_a_snapshot_puts_the_table_back_and_a_difference_adds_to_it():
    """What a compiled step does around a capture and at each replay."""
    tracing.reset_counters()
    tracing.count("test.a", n=2)
    before = tracing.counters()
    tracing.count("test.a")
    tracing.count("test.b", "key", 3)
    after = tracing.counters()
    tracing.set_counters(before)
    assert tracing.counters() == {("test.a", None): 2}
    added = {entry: n - before.get(entry, 0) for entry, n in after.items() if n != before.get(entry, 0)}
    tracing.add_counters(added)
    tracing.add_counters(added)
    assert tracing.counters() == {("test.a", None): 4, ("test.b", "key"): 6}


def test_a_reset_clears_everything_or_the_named_counters():
    tracing.count("test.a")
    tracing.count("test.b", "key")
    tracing.count("test.c", n=3)
    tracing.reset_counters("test.a", "test.b")
    assert tracing.counter("test.a") == tracing.counter("test.b") == 0 and tracing.counter("test.c") == 3
    tracing.reset_counters()
    assert tracing.counters() == {}


def test_launch_counts_reads_its_eight_counters_at_zero_on_a_fresh_table():
    tracing.reset_counters()
    tracing.count("test.not_a_launch")
    assert sk.launch_counts() == {"segment_extremum": 0, "segment_extremum_argmax": 0, "broadcast_to_edges": 0,
                                  "segment_sum": 0, "typed_matmul": 0, "typed_dw": 0, "keyed_dropout": 0,
                                  "keyed_dropout_elements": 0}
    tracing.count("segment_sum", n=2)
    tracing.count("broadcast_to_edges", (256, "float32"))
    sk.reset_launch_counts()
    assert sum(sk.launch_counts().values()) == 0 and tracing.counter("test.not_a_launch") == 1


@pytest.mark.parametrize("reduction,columns", [("sum", 4), ("max", 6)])
def test_launch_counts_after_a_fused_forward_and_backward_with_keyed_dropout(small_g2c, reduction, columns):
    """The CPU launches no kernel; the hash covers the forward's [E, 2D]
    input and the backward's two [E, D] cotangent halves, and under max
    the value ties' recomputed [E, 2D] transpose input besides."""
    _, _, mbs = small_g2c
    adj = mbs[0]["batch"].adjacency
    n, d, m = 256, 8, 8
    types = int(max(adj.tile_types.max(), adj.tile_types_transposed.max())) + 1
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, d, generator=gen, requires_grad=True)
    w = torch.randn(types, 2 * d, m, generator=gen, requires_grad=True)
    tracing.reset_counters()
    out = fused_typed_message_aggregation(x, w, adj, n, reduction, True, 0.8, torch.tensor(7))
    assert sk.launch_counts()["keyed_dropout_elements"] == adj.mask.shape[0] * 2 * d
    out.sum().backward()
    assert x.grad.abs().max() > 0
    assert sk.launch_counts() == {"segment_extremum": 0, "segment_extremum_argmax": 0, "broadcast_to_edges": 0,
                                  "segment_sum": 0, "typed_matmul": 0, "typed_dw": 0, "keyed_dropout": 0,
                                  "keyed_dropout_elements": adj.mask.shape[0] * columns * d}
