"""Host milliseconds a train step takes to dispatch: the mean duration of
the program's ``ptgnn.train_step`` spans (``core/trainer.py::TrainStep.step``:
the rates, the staging copies and the graph's launch) that lie inside the
traced window, from the profiler's host ranges (rank 0). It moves the
step's pace only where the device waits for the host."""
NAME = "ptgnn.train_step"
COMBINE = "rank0"


def read(run):
    w0, w1 = run.trace.window
    spans = [b - a for name, a, b in run.trace.host_ops if name == NAME and w0 <= a and b <= w1]
    return 1e-6 * sum(spans) / len(spans) if spans else None
