"""The readers of the program's phase marks and spans on hand-made traces:
the four phases add up to the step intervals, a step with a lost mark is
left out, too many lost read nothing, operations take the phase of the
mark before them, a trace without marks reads nothing, and the host step is
the mean of the program's step ranges in the window."""
import pytest

from gnnbench.harness import phases, pool, report, spec, trace
from gnnbench.metrics import (backward_ms_per_step, forward_ms_per_step, host_minibatch_s, host_step_ms,
                              optimizer_ms_per_step, staging_ms_per_step)

READERS = (forward_ms_per_step, backward_ms_per_step, optimizer_ms_per_step, staging_ms_per_step)
# ns from a step's mark 0 to its marks 1, 2, 3 and to the next step's 0
OFFSETS = (3_000_000, 8_000_000, 8_600_000, 8_700_000)


def _marks(steps, start=1_000, drop=()):
    """The device operations of ``steps`` steps' marks and a kernel in each
    phase; ``drop``: (step, mark id) left out of the trace."""
    ops = []
    for s in range(steps):
        t0 = start + s * OFFSETS[-1]
        for i, t in enumerate((t0, t0 + OFFSETS[0], t0 + OFFSETS[1], t0 + OFFSETS[2])):
            if (s, i) not in drop:
                ops.append((f"void trace_mark_kernel<{i}>()", t, t + 1_500))
            ops.append(("void at::native::elementwise_kernel<128, 4>()", t + 2_000, t + 900_000))
    return ops


def _run(device, steps, host=()):
    events = [(trace.WINDOW, False, 0, 10**12)] + [(n, True, a, b) for n, a, b in device]
    events += [(n, False, a, b) for n, a, b in host]
    tr = trace.summarize(events)
    groups = [pool.Group([], 10, 30)] * steps
    return report.LayerRun(spec.load_config("ppi_mlp_sum"), tr, steps, groups, {"launches": {}}, 1.0, 0, {})


def test_the_four_phases_add_up_to_the_step_interval():
    run = _run(_marks(20), 20)
    got = [r.read(run) for r in READERS]
    want = [1e-6 * b for b in (OFFSETS[0], OFFSETS[1] - OFFSETS[0], OFFSETS[2] - OFFSETS[1], OFFSETS[3] - OFFSETS[2])]
    assert got == pytest.approx(want, rel=1e-12)
    assert sum(got) == pytest.approx(1e-6 * OFFSETS[-1], rel=1e-12)
    assert len(phases.complete_steps(phases.marks(run.trace))) == 19  # the last step has no next mark 0


def test_a_step_with_a_lost_mark_is_left_out():
    # step 50 loses its mark 2; the lost mark 0 of step 120 leaves its step
    # and step 119 (whose staging has no end) out; 3 of 300 is the share
    ops = _marks(300, drop={(50, 2), (120, 0)})
    # step 200's staging is 40 us longer, and still read
    late = _start(200, 3) + 10_000
    ops = [(n, a, b) if a < late else (n, a + 40_000, b + 40_000) for n, a, b in ops]
    run = _run(ops, 300)
    assert len(phases.complete_steps(phases.marks(run.trace))) == 299 - 3
    assert forward_ms_per_step.read(run) == pytest.approx(1e-6 * OFFSETS[0], rel=1e-12)
    assert staging_ms_per_step.read(run) == pytest.approx(1e-6 * (OFFSETS[3] - OFFSETS[2] + 40_000 / 296), rel=1e-9)


def _start(step, mark):
    return 1_000 + step * OFFSETS[-1] + (0, *OFFSETS[:3])[mark]


def test_more_lost_than_the_share_reads_nothing():
    steps = 100  # trace.LOST_EVENTS of 100 steps: one may be left out
    one = _run(_marks(steps, drop={(10, 1)}), steps)
    assert forward_ms_per_step.read(one) is not None
    two = _run(_marks(steps, drop={(10, 1), (40, 3)}), steps)
    assert all(r.read(two) is None for r in READERS)


def test_operations_go_to_the_phase_of_the_last_mark_before_them():
    ops = [("early", 0, 500)] + _marks(3)
    found = phases.by_phase(_run(ops, 3).trace)
    kernel = "void at::native::elementwise_kernel<128, 4>()"
    assert [set(f) for f in found] == [{kernel}] * 4
    assert [f[kernel] for f in found] == [3 * 898_000] * 4  # one a step and phase; "early" and the marks left out


def test_a_trace_without_marks_reads_nothing():
    run = _run([("void at::native::elementwise_kernel<128, 4>()", 10, 20)], 5)
    assert all(r.read(run) is None for r in READERS)
    assert host_step_ms.read(run) is None


def test_host_step_is_the_mean_of_the_program_step_ranges_in_the_window():
    host = [("ptgnn.train_step", 1_000_000 * k, 1_000_000 * k + 200_000 + 10_000 * k) for k in range(1, 5)]
    host += [("ptgnn.compiled_step.replay", 1_000_000, 1_100_000), ("ptgnn.train_step", 10**12 - 5, 10**12 + 100)]
    run = _run(_marks(3), 3, host)
    assert host_step_ms.read(run) == pytest.approx(1e-6 * (200_000 + 25_000), rel=1e-12)


def test_host_minibatch_seconds_sum_the_model_spans(monkeypatch):
    from ptgnn_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "totals", lambda: {
        "ptgnn.model.tensorize": {"count": 4, "seconds": 1.5, "self_seconds": 1.5},
        "ptgnn.model.finalize_minibatch": {"count": 1, "seconds": 0.25, "self_seconds": 0.25},
        "ptgnn.train_step": {"count": 9, "seconds": 7.0, "self_seconds": 1.0}})
    assert host_minibatch_s.read(None) == 1.75
    monkeypatch.setattr(tracing, "totals", lambda: {})
    assert host_minibatch_s.read(None) is None
