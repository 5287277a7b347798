"""Device milliseconds a train step spends in its backward: phase mark 1
to mark 2 (``harness/phases.py``; autograd of the stack, the dW
products, the typed products' input gradients), over the traced window's
complete steps (rank 0)."""
from gnnbench.harness import phases

COMBINE = "rank0"


def read(run):
    return phases.phase_ms(run, "backward")
